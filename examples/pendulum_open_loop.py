"""Pendulum swing-up, open-loop iLQR.

Workload parity: `/root/reference/python/run_iLQR_open_loop.py` (dt=0.01,
T=4, Q=I, R=I, Q_f=0, x0=[1,0], backward_euler, tol=1e-5, maxiter=100) with
the reference's measurement protocol (JIT warm-up, then timed solve).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.utils.timing import timed, warmup
from ilqr_tpu.viz.plots import plot_convergence, plot_trajectory


def main():
    dt, T = 0.01, sm(4.0, 0.2)
    N = len(jnp.arange(0, T + dt, dt)) - 1

    sys_ = it.make_pendulum(
        dt, x_target=[jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
        Q_f=jnp.zeros((2, 2)), g=9.81, l=1.0, d=0.0,
        integrator="backward_euler",
    )
    x0 = jnp.array([1.0, 0.0])
    U0 = jnp.zeros((N, 1))
    cfg = it.IlqrConfig(maxiter=sm(100, 5), tol=1e-5)

    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    print("Warming up (compiling the full solver)…")
    warmup(solve, x0, U0)

    sec, sol = timed(solve, x0, U0, reps=5)
    print(f"Solve: status={int(sol.status)} iters={int(sol.iterations)} "
          f"cost={float(sol.cost):.4f}  wall={sec * 1e3:.2f} ms (warmed)")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(sol.X, sol.U, dt, x_target=[jnp.pi, 0.0],
                    state_labels=["θ", "θ̇"], title="Pendulum swing-up",
                    save_path=os.path.join(out, "pendulum_ol.png"))
    plot_convergence(sol, save_path=os.path.join(out, "pendulum_ol_conv.png"))
    print(f"Plots written to {out}/")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
