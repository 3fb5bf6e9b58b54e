"""Constrained pendulum swing-up — augmented-Lagrangian iLQR.

Greenfield workload (no reference counterpart; the reference's only
constraint treatment is a commented-out log-barrier,
`pendulum_sys.py:84-85`): a torque-limited pumping swing-up with an exact
terminal goal, solved by `ilqr_tpu.solve_constrained` as one jitted device
program.  With |u| <= 3 < mgl = 9.81 the pendulum cannot swing up directly
and must pump over multiple swings.
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
from ilqr_tpu.viz.plots import plot_trajectory


def main():
    dt, T = 0.01, sm(4.0, 0.16)
    N = len(jnp.arange(0, T + dt, dt)) - 1
    goal = jnp.array([jnp.pi, 0.0])

    sys_ = it.make_pendulum(
        dt, x_target=goal, Q=jnp.eye(2), R=jnp.eye(1),
        Q_f=100.0 * jnp.eye(2), g=9.81, l=1.0, d=0.0, integrator="rk4",
    )
    cons = it.merge_constraints(
        it.box_control_constraints(jnp.array([-3.0]), jnp.array([3.0])),
        it.goal_constraint(goal),
    )
    x0 = jnp.zeros(2)
    U0 = jnp.zeros((N, 1))
    cfg = it.IlqrConfig(maxiter=sm(100, 5), tol=1e-7)
    al = it.AlConfig(max_outer=sm(15, 2), ctol=1e-4)

    solve = jax.jit(lambda x, U: it.solve_constrained(sys_, cons, x, U, cfg, al))
    print("Warming up (compiling the constrained solver)…")
    warmup(solve, x0, U0)

    sec, sol = timed(solve, x0, U0, reps=5)
    print(f"Constrained solve: status={int(sol.status)} "
          f"outer={int(sol.outer_iterations)} inner={int(sol.inner_iterations)} "
          f"cost={float(sol.cost):.4f} violation={float(sol.violation):.2e} "
          f"wall={sec * 1e3:.2f} ms (warmed)")
    print(f"max |u| = {float(jnp.max(jnp.abs(sol.U))):.4f} (limit 3.0), "
          f"terminal error = {float(jnp.max(jnp.abs(sol.X[-1] - goal))):.2e}")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(sol.X, sol.U, dt, x_target=goal,
                    state_labels=["θ", "θ̇"],
                    title="Torque-limited swing-up (AL-iLQR)",
                    save_path=os.path.join(out, "constrained_pendulum.png"))
    print(f"Plot written to {out}/")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
