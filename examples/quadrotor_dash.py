"""Planar-quadrotor dash: thrust-limited trajectory optimization + TVLQR
tracking under model mismatch.

Workload (no reference counterpart — the reference has pendula only):
  1. fly from hover at the origin to a waypoint 3 m right / 1 m up in 3 s,
     with PHYSICAL rotor limits 0 ≤ F_i ≤ 2·(mg/2) enforced by the
     projected-Newton boxQP path (`IlqrConfig(u_min, u_max)`) — thrusts
     cannot be negative, which the unconstrained solver happily requests;
  2. replay the plan on a 20%-heavier plant, open-loop vs TVLQR-tracked
     (`ilqr_tpu.tracking`): the gains synthesized along the plan absorb the
     mismatch that open-loop replay cannot.

Run: python examples/quadrotor_dash.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.models.quadrotor import hover_controls, make_quadrotor
from ilqr_tpu.tracking import track, tvlqr_gains
from ilqr_tpu.utils.timing import warmup


def main():
    dt, T = 0.01, sm(3.0, 0.15)
    N = int(T / dt)
    target = [3.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    Q = jnp.diag(jnp.array([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]))
    R = 0.1 * jnp.eye(2)
    Q_f = jnp.diag(jnp.array([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]))
    sys_ = make_quadrotor(dt, target, Q, R, Q_f)

    m, g = float(sys_.params["m"]), float(sys_.params["g"])
    f_max = 2.0 * 0.5 * m * g  # each rotor can lift the whole craft at most
    x0 = jnp.zeros(6)
    U0 = jnp.tile(hover_controls(sys_.params), (N, 1))

    cfg = it.IlqrConfig(maxiter=sm(200, 5), tol=1e-6, u_min=0.0,
                        u_max=f_max,
                        adaptive_reg=True)
    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    warmup(solve, x0, U0)
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(x0, U0))
    t_solve = time.perf_counter() - t0
    print(f"thrust-limited dash: {t_solve * 1e3:.1f} ms  "
          f"cost={float(sol.cost):.3f}  iters={int(sol.iterations)}  "
          f"status={int(sol.status)}")
    print(f"rotor thrust range [{float(jnp.min(sol.U)):.3f}, "
          f"{float(jnp.max(sol.U)):.3f}] N  (limits [0, {f_max:.3f}])")
    print(f"final state err: {float(jnp.linalg.norm(sol.X[-1] - jnp.asarray(target))):.4f}")

    # --- Mismatched plant: 20% heavier. Open-loop replay vs TVLQR. ---
    # Gains are synthesized FRESH with tracking weights (`tvlqr_gains`), not
    # taken from the converged solve: at convergence the boxQP backward's
    # free-direction gains can be enormous (Q_uu nearly singular along
    # inactive directions) — optimal for the local LQ model, useless as a
    # tracking controller.
    plant = make_quadrotor(dt, target, Q, R, Q_f, m=1.2 * m)
    X_ol, _ = it.rollout(plant, x0, sol.U)
    err_ol = float(jnp.linalg.norm(X_ol[-1] - jnp.asarray(target)))

    K = tvlqr_gains(
        sys_, sol.X, sol.U,
        Q=jnp.diag(jnp.array([10.0, 10.0, 10.0, 1.0, 1.0, 1.0])),
        R=jnp.eye(2),
        Q_f=jnp.diag(jnp.array([100.0, 100.0, 100.0, 10.0, 10.0, 10.0])),
    )
    X_tr, U_tr, _ = track(plant, x0, sol.X, sol.U, K, u_limits=(0.0, f_max))
    err_tr = float(jnp.linalg.norm(X_tr[-1] - jnp.asarray(target)))
    print(f"20% heavier plant, final error: open-loop {err_ol:.3f}  "
          f"TVLQR-tracked {err_tr:.3f}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].plot(sol.X[:, 0], sol.X[:, 1], label="plan")
        ax[0].plot(X_ol[:, 0], X_ol[:, 1], "--", label="open-loop (heavy)")
        ax[0].plot(X_tr[:, 0], X_tr[:, 1], ":", label="TVLQR (heavy)")
        ax[0].plot([3.0], [1.0], "r*", markersize=12)
        ax[0].set_xlabel("x [m]"); ax[0].set_ylabel("z [m]"); ax[0].legend()
        ax[0].set_title("planar quadrotor dash")
        tspan = jnp.arange(N) * dt
        ax[1].plot(tspan, sol.U[:, 0], label="F1")
        ax[1].plot(tspan, sol.U[:, 1], label="F2")
        ax[1].axhline(f_max, color="k", ls="--", lw=0.8)
        ax[1].axhline(0.0, color="k", ls="--", lw=0.8)
        ax[1].set_xlabel("t [s]"); ax[1].set_ylabel("thrust [N]"); ax[1].legend()
        fig.tight_layout()
        fig.savefig("/tmp/quadrotor_dash.png", dpi=110)
        print("plot saved to /tmp/quadrotor_dash.png")
    except Exception as e:  # headless/plot-less environments
        print(f"(plot skipped: {e})")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
