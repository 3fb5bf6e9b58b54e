"""Double-pendulum MPC (fully actuated + underactuated variants).

Workload parity: `/root/reference/python/run_MPC_double_pendulum.py` (T=1
horizon, T_sim=3, maxiter=50, rk4/rk4, nonzero initial velocity [0,0,-10,10])
and `run_iLQR_UA_MPC.py` (UA: T=2, T_sim=5, rk4 solver / backward_euler plant,
Q=diag(5,5,.1,.1), R=[50], Q_f=diag(1000,1000,10,10)).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.mpc import run_mpc
from ilqr_tpu.utils.timing import timed, warmup
from ilqr_tpu.viz.plots import plot_trajectory


def fully_actuated(out):
    dt = 0.01
    N_h = len(jnp.arange(0, sm(1.0, 0.12) + dt, dt)) - 1
    N_sim = len(jnp.arange(0, sm(3.0, 0.06) + dt, dt)) - 1
    mk = lambda integ: it.make_double_pendulum(
        dt, x_target=[jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator=integ,
    )
    solver_sys = plant_sys = mk("rk4")
    cfg = it.IlqrConfig(maxiter=sm(50, 3), tol=1e-5)
    x0 = jnp.array([0.0, 0.0, -10.0, 10.0])

    mpc = jax.jit(lambda x, U: run_mpc(solver_sys, plant_sys, x, U, N_sim, cfg))
    warmup(mpc, x0, jnp.zeros((N_h, 2)))
    sec, res = timed(mpc, x0, jnp.zeros((N_h, 2)), reps=2)
    print(f"FA double-pendulum MPC: {N_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / N_sim * 1e6:.1f} µs/step), final x={res.X[-1]}")
    plot_trajectory(res.X, res.U, dt, x_target=[jnp.pi, 0, 0, 0],
                    title="FA double-pendulum MPC",
                    save_path=os.path.join(out, "double_pendulum_mpc.png"))


def underactuated(out):
    dt = 0.01
    N_h = len(jnp.arange(0, sm(2.0, 0.12) + dt, dt)) - 1
    N_sim = len(jnp.arange(0, sm(5.0, 0.06) + dt, dt)) - 1
    mk = lambda integ: it.make_double_pendulum(
        dt, x_target=[jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([5.0, 5.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([50.0])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 10.0, 10.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
        underactuated=True, integrator=integ,
    )
    solver_sys, plant_sys = mk("rk4"), mk("backward_euler")
    cfg = it.IlqrConfig(maxiter=sm(50, 3), tol=1e-5)

    mpc = jax.jit(lambda x, U: run_mpc(solver_sys, plant_sys, x, U, N_sim, cfg))
    warmup(mpc, jnp.zeros(4), jnp.zeros((N_h, 1)))
    sec, res = timed(mpc, jnp.zeros(4), jnp.zeros((N_h, 1)), reps=1)
    print(f"UA double-pendulum MPC: {N_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / N_sim * 1e6:.1f} µs/step), final x={res.X[-1]}")
    plot_trajectory(res.X, res.U, dt, x_target=[jnp.pi, 0, 0, 0],
                    title="UA double-pendulum MPC",
                    save_path=os.path.join(out, "ua_double_pendulum_mpc.png"))


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    fully_actuated(out)
    underactuated(out)
