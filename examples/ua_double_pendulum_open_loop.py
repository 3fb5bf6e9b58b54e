"""Underactuated double-pendulum swing-up (the hardest open-loop problem).

Workload parity: `/root/reference/python/run_iLQR_OL_UA_Pendulum.py` (dt=0.01,
T=8, only joint 1 actuated, Q=diag(1,1,.1,.1), R=[1],
Q_f=diag(1000,1000,100,100), backward_euler, maxiter=700).
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
    dt, T = 0.01, sm(8.0, 0.2)
    N = len(jnp.arange(0, T + dt, dt)) - 1

    sys_ = it.make_double_pendulum(
        dt, x_target=[jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([1.0, 1.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([1.0])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
        underactuated=True, integrator="backward_euler",
    )
    x0 = jnp.zeros(4)
    U0 = jnp.zeros((N, 1))
    cfg = it.IlqrConfig(maxiter=sm(700, 5), tol=1e-5)

    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    print("Warming up…")
    warmup(solve, x0, U0)
    sec, sol = timed(solve, x0, U0, reps=1)
    print(f"Solve: iters={int(sol.iterations)} cost={float(sol.cost):.3f} "
          f"x_N={sol.X[-1]}  wall={sec:.3f} s")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(sol.X, sol.U, dt, x_target=[jnp.pi, 0, 0, 0],
                    state_labels=["q1", "q2", "q̇1", "q̇2"],
                    title="UA double pendulum swing-up",
                    save_path=os.path.join(out, "ua_double_pendulum_ol.png"))
    if save_video:
        path = DoublePendulumAnimation(sol.X, dt).animate(
            save_video=True,
            filename=os.path.join(out, "ua_double_pendulum_swing_up.mp4"),
        )
        print(f"Video written to {path}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
