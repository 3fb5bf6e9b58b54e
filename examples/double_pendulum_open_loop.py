"""Fully-actuated double-pendulum swing-up, open-loop iLQR.

Workload parity: `/root/reference/python/run_double_pendulum_open_loop.py`
(dt=0.01, T=5, Q=diag(10,10,.1,.1), R=diag(.1,.1), Q_f=diag(1000,1000,100,100),
euler, tol=1e-6, maxiter=200), plus mp4 export of the solution.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.utils.timing import timed, warmup
from ilqr_tpu.viz.animation import DoublePendulumAnimation
from ilqr_tpu.viz.plots import plot_trajectory


def main(save_video: bool = True):
    dt, T = 0.01, sm(5.0, 0.2)
    N = len(jnp.arange(0, T + dt, dt)) - 1

    sys_ = it.make_double_pendulum(
        dt, x_target=[jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler",
    )
    x0 = jnp.zeros(4)
    U0 = jnp.zeros((N, 2))
    cfg = it.IlqrConfig(maxiter=sm(200, 5), tol=1e-6)

    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    print("Warming up…")
    warmup(solve, x0, U0)
    sec, sol = timed(solve, x0, U0, reps=3)
    print(f"Solve: iters={int(sol.iterations)} cost={float(sol.cost):.3f} "
          f"x_N={sol.X[-1]}  wall={sec * 1e3:.1f} ms")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(sol.X, sol.U, dt, x_target=[jnp.pi, 0, 0, 0],
                    state_labels=["q1", "q2", "q̇1", "q̇2"],
                    title="Double pendulum swing-up",
                    save_path=os.path.join(out, "double_pendulum_ol.png"))
    if save_video:
        path = DoublePendulumAnimation(sol.X, dt).animate(
            save_video=True,
            filename=os.path.join(out, "double_pendulum_swing_up.mp4"),
        )
        print(f"Video written to {path}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
