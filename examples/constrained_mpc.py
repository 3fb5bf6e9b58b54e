"""Torque-limited receding-horizon MPC, three ways.

Greenfield workload (the reference MPC drivers are all unconstrained,
`/root/reference/python/run_iLQR_MPC.py:116-140`): pendulum swing-up under a
binding torque limit |u| <= 6 (the unconstrained plan peaks at ~11.4), with
solver/plant model mismatch (backward_euler vs midpoint), comparing

  1. `run_mpc_constrained` — per-step augmented-Lagrangian solve, multipliers
     and penalty warm-started by shifting along the horizon (ALTRO-MPC);
  2. `run_mpc_barrier`     — fixed-(mu, delta) relaxed-barrier solve per step
     (Feller & Ebenbauer 2017): constant per-step latency;
  3. `run_mpc` + boxQP     — `IlqrConfig(u_min/u_max)` projected-Newton limits
     inside the plain MPC loop.

All three are single jitted device programs for the full closed loop.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.constrained import AlConfig, box_control_constraints
from ilqr_tpu.mpc import run_mpc, run_mpc_barrier, run_mpc_constrained


def main():
    mk = lambda integ: it.make_pendulum(
        0.01, [jnp.pi, 0.0], Q=jnp.diag(jnp.array([10.0, 1.0])),
        R=jnp.eye(1), Q_f=jnp.diag(jnp.array([10.0, 10.0])), d=0.0,
        integrator=integ,
    )
    solver_sys, plant_sys = mk("backward_euler"), mk("midpoint")
    N_h, n_sim, lim = sm(200, 12), sm(400, 6), 6.0
    x0, U0 = jnp.zeros(2), jnp.zeros((N_h, 1))
    cons = box_control_constraints(jnp.array([-lim]), jnp.array([lim]))

    def bench(name, fn):
        f = jax.jit(fn)
        res = jax.block_until_ready(f())          # compile + run
        t0 = time.perf_counter()
        res = jax.block_until_ready(f())
        dt_ms = (time.perf_counter() - t0) * 1e3
        print(f"{name:12s}  cost {float(res.cost):8.3f}   "
              f"max|u| {float(jnp.max(jnp.abs(res.U))):6.3f}   "
              f"xN [{float(res.X[-1, 0]):+.4f} {float(res.X[-1, 1]):+.4f}]   "
              f"{dt_ms:7.1f} ms / {n_sim} steps")
        return res

    bench("AL warm", lambda: run_mpc_constrained(
        solver_sys, plant_sys, cons, x0, U0, n_sim,
        it.IlqrConfig(maxiter=sm(15, 3), tol=1e-6),
        AlConfig(max_outer=2, ctol=1e-3, mu0=1.0)))
    bench("barrier", lambda: run_mpc_barrier(
        solver_sys, plant_sys, cons, x0, U0, n_sim,
        it.IlqrConfig(maxiter=sm(10, 3), tol=1e-6), mu=1e-2, delta=0.05))
    bench("boxQP", lambda: run_mpc(
        solver_sys, plant_sys, x0, U0, n_sim,
        it.IlqrConfig(maxiter=sm(10, 3), tol=1e-6, u_min=-lim, u_max=lim)))


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
