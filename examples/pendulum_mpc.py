"""Pendulum receding-horizon MPC.

Workload parity: `/root/reference/python/run_iLQR_MPC.py` (horizon T=2 solved
every step for T_sim=4, maxiter=10, solver=backward_euler vs plant=midpoint
mismatch, shift-and-hold warm start).  Unlike the reference's host loop, the
entire closed-loop run is one device program; per-step time is total/N_sim.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.mpc import run_mpc
from ilqr_tpu.utils.timing import timed, warmup
from ilqr_tpu.viz.plots import plot_trajectory


def main():
    dt = 0.01
    N_h = len(jnp.arange(0, sm(2.0, 0.12) + dt, dt)) - 1   # horizon
    N_sim = len(jnp.arange(0, sm(4.0, 0.06) + dt, dt)) - 1  # simulation steps

    mk = lambda integ: it.make_pendulum(
        dt, x_target=[jnp.pi, 0.0], Q=jnp.diag(jnp.array([10.0, 1.0])),
        R=jnp.eye(1), Q_f=jnp.diag(jnp.array([10.0, 10.0])), d=0.0,
        integrator=integ,
    )
    solver_sys, plant_sys = mk("backward_euler"), mk("midpoint")
    cfg = it.IlqrConfig(maxiter=sm(10, 3), tol=1e-5)

    mpc = jax.jit(lambda x0, U0: run_mpc(solver_sys, plant_sys, x0, U0, N_sim, cfg))
    print("Warming up…")
    warmup(mpc, jnp.zeros(2), jnp.zeros((N_h, 1)))
    sec, res = timed(mpc, jnp.zeros(2), jnp.zeros((N_h, 1)), reps=3)
    print(f"MPC: {N_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / N_sim * 1e6:.1f} µs/step), final x={res.X[-1]}, "
          f"closed-loop cost={float(res.cost):.3f}")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(res.X, res.U, dt, x_target=[jnp.pi, 0.0],
                    state_labels=["θ", "θ̇"], title="Pendulum MPC",
                    save_path=os.path.join(out, "pendulum_mpc.png"))


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
