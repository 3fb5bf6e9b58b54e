"""Car obstacle avoidance — AL-constrained iLQR on the kinematic bicycle.

Greenfield workload (no reference counterpart): drive from the origin to a
goal 8 m ahead around two keep-out discs blocking the straight line, with
acceleration/steering box limits, all constraints handled by
`ilqr_tpu.solve_constrained` in one jitted device program.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.models.car import make_car, obstacle_constraints
from ilqr_tpu.utils.timing import timed, warmup


def main():
    dt, N = 0.05, sm(120, 16)
    goal = jnp.array([8.0, 0.0, 0.0, 0.0])
    sys_ = make_car(
        dt, x_target=goal,
        Q=jnp.diag(jnp.array([0.1, 0.1, 0.01, 0.1])),
        R=jnp.diag(jnp.array([1.0, 5.0])),
        Q_f=100.0 * jnp.diag(jnp.array([1.0, 1.0, 0.1, 1.0])),
    )
    centers = jnp.array([[3.0, 0.3], [5.5, -0.4]])
    radii = jnp.array([1.0, 0.8])
    cons = it.merge_constraints(
        obstacle_constraints(centers, radii),
        it.box_control_constraints(jnp.array([-3.0, -0.5]),
                                   jnp.array([3.0, 0.5])),
    )
    x0 = jnp.zeros(4)
    U0 = jnp.zeros((N, 2))
    cfg = it.IlqrConfig(maxiter=sm(100, 5), tol=1e-7)
    # Gentler escalation converges better here: large mu jumps right after
    # the iterate crosses into a disc stall the inner solve on this problem.
    al = it.AlConfig(max_outer=sm(15, 2), ctol=1e-3, mu0=50.0, mu_factor=5.0)

    solve = jax.jit(lambda x, U: it.solve_constrained(sys_, cons, x, U, cfg, al))
    print("Warming up (compiling the constrained solver)…")
    warmup(solve, x0, U0)
    sec, sol = timed(solve, x0, U0, reps=5)

    d_min = [float(jnp.min(jnp.linalg.norm(sol.X[:, :2] - c, axis=-1)))
             for c in centers]
    print(f"Constrained solve: status={int(sol.status)} "
          f"outer={int(sol.outer_iterations)} inner={int(sol.inner_iterations)} "
          f"cost={float(sol.cost):.3f} violation={float(sol.violation):.2e} "
          f"wall={sec * 1e3:.2f} ms (warmed)")
    print(f"goal error={float(jnp.max(jnp.abs(sol.X[-1] - goal))):.3f}, "
          f"obstacle clearances={d_min} (radii {list(map(float, radii))})")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 4))
    for c, r in zip(centers, radii):
        ax.add_patch(plt.Circle((float(c[0]), float(c[1])), float(r),
                                color="#c44", alpha=0.35))
    ax.plot(sol.X[:, 0], sol.X[:, 1], "-", lw=2, label="constrained path")
    ax.plot([0], [0], "ks", label="start")
    ax.plot([8], [0], "k*", ms=12, label="goal")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]")
    ax.legend(); ax.set_title("Car obstacle avoidance (AL-iLQR)")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "car_obstacles.png"), dpi=120)
    print(f"Plot written to {out}/car_obstacles.png")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
