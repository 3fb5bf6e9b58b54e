"""TVLQR tracking demo — stabilize a solved swing-up under disturbances.

Greenfield workload (no reference counterpart; the reference's only feedback
execution is full MPC re-solving): solve the pendulum swing-up once, then
execute it closed-loop from perturbed initial states on a mismatched plant
(different damping + integrator) with the solver's own time-varying gains.
Open-loop replay of the same controls diverges; TVLQR tracking does not —
at zero per-step optimization cost.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it


def main():
    dt, N = 0.01, sm(400, 16)
    sys_ = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=100.0 * jnp.eye(2), d=0.1, integrator="rk4")
    plant = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                             Q_f=100.0 * jnp.eye(2), d=0.13,
                             integrator="midpoint")
    x0 = jnp.zeros(2)
    sol = it.solve(sys_, x0, jnp.zeros((N, 1)),
                   it.IlqrConfig(maxiter=sm(200, 5), tol=1e-6))
    print(f"Swing-up solved: cost={float(sol.cost):.4f} "
          f"terminal θ={float(sol.X[-1, 0]):.4f} (π={jnp.pi:.4f})")

    # Batch of perturbed starts, tracked in one vmapped program.
    x0s = x0 + jnp.array([[0.2, 0.0], [-0.2, 0.1], [0.1, -0.3], [0.0, 0.4]])
    Xs, Us, _ = jax.jit(jax.vmap(
        lambda x: it.track_solution(plant, x, sol)))(x0s)
    X_ol = jax.jit(jax.vmap(lambda x: it.rollout(plant, x, sol.U)[0]))(x0s)

    err_cl = jnp.max(jnp.abs(Xs[:, -1, :] - sol.X[-1]), axis=-1)
    err_ol = jnp.max(jnp.abs(X_ol[:, -1, :] - sol.X[-1]), axis=-1)
    for i in range(x0s.shape[0]):
        print(f"  start {i}: terminal error tracked={float(err_cl[i]):.4f} "
              f"open-loop={float(err_ol[i]):.4f}")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = jnp.arange(N + 1) * dt
    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    for i in range(x0s.shape[0]):
        axes[0].plot(t, Xs[i, :, 0], lw=1)
        axes[1].plot(t, X_ol[i, :, 0], lw=1)
    for ax, title in zip(axes, ["TVLQR tracked", "open-loop replay"]):
        ax.plot(t, sol.X[:, 0], "k--", lw=1.5, label="reference")
        ax.axhline(float(jnp.pi), color="gray", lw=0.5)
        ax.set_xlabel("t [s]"); ax.set_title(title)
    axes[0].set_ylabel("θ [rad]"); axes[0].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out, "tvlqr_tracking.png"), dpi=120)
    print(f"Plot written to {out}/tvlqr_tracking.png")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
