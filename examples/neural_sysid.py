"""Grey-box system identification + control: learn an MLP residual on a
wrong nominal model from plant data, then control through the learned model.

Story: the true pendulum has strong damping (d=0.5) and a different length
than the nominal model believes (l=1.0 vs 1.6, d=0).  We excite the plant
over the swing-up's state range, fit a neural residual on the nominal
dynamics (ilqr_tpu.models.neural) with MULTI-STEP prediction error (one-step
fits can be excellent yet drift when composed — and the composed model is
what the planner optimizes through), then compare CLOSED-LOOP MPC on the
true plant:

  1. MPC planning with the wrong nominal model,
  2. MPC planning with the learned (nominal + MLP residual) model,
  3. MPC planning with the true model (oracle floor).

Closed loop is the honest comparison — open-loop replay of any plan on a
mismatched plant mostly measures the plant's open-loop instability, not the
model quality.  The learned System is a plain `ilqr_tpu.System`, so the same
object drops into solve / MPC / solve_implicit unchanged.

Run: python examples/neural_sysid.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.models.neural import (
    fit_dynamics,
    make_neural_residual,
    prediction_loss,
)
from ilqr_tpu.ops.rollout import rollout


def make(d, l=1.0):
    return it.make_pendulum(
        0.05, [jnp.pi, 0.0],
        Q=jnp.diag(jnp.array([5.0, 0.5])), R=0.1 * jnp.eye(1),
        Q_f=jnp.diag(jnp.array([50.0, 5.0])), d=d, l=l, integrator="rk4",
    )


def main():
    plant = make(d=0.5, l=1.0)       # truth
    nominal = make(d=0.0, l=1.6)     # 60% too long, undamped — badly wrong

    # --- Excite the plant over the swing-up's state range: strong random
    # sinusoidal torques from large-angle/velocity starts. ---
    B, N = sm(32, 4), sm(60, 10)
    k1, k2, k3, k4 = jax.random.split(jax.random.key(0), 4)
    amps = jax.random.uniform(k1, (B, 1, 1), minval=1.0, maxval=6.0)
    freqs = jax.random.uniform(k2, (B, 1, 1), minval=0.5, maxval=3.0)
    t = jnp.linspace(0.0, N * plant.dt, N)[None, :, None]
    U_data = amps * jnp.sin(freqs * t)
    x0s = jnp.concatenate([
        jax.random.uniform(k3, (B, 1), minval=-3.0, maxval=3.0),
        jax.random.uniform(k4, (B, 1), minval=-4.0, maxval=4.0),
    ], axis=1)
    X_data = jax.vmap(lambda x0, u: rollout(plant, x0, u)[0])(x0s, U_data)

    # --- Fit the residual on 10-step prediction error. ---
    net = make_neural_residual(nominal, hidden=(32, 32), key=jax.random.key(1))
    print(f"10-step prediction MSE before fit: "
          f"{prediction_loss(net, X_data, U_data, horizon=10):.2e}")
    t0 = time.perf_counter()
    net, losses = fit_dynamics(net, X_data, U_data, steps=sm(1000, 20),
                               learning_rate=3e-3, horizon=10)
    print(f"10-step prediction MSE after fit:  {losses[-1]:.2e}  "
          f"({time.perf_counter() - t0:.1f}s, 1000 adam steps on-device)")

    # --- Closed-loop MPC on the true plant with each planning model. ---
    from ilqr_tpu.mpc import run_mpc

    mcfg = it.IlqrConfig(maxiter=sm(8, 3), tol=1e-6)
    x0, U0, n_sim = jnp.zeros(2), jnp.zeros((sm(40, 8), 1)), sm(80, 6)
    for name, model in [("nominal (wrong)", nominal),
                        ("learned residual", net),
                        ("true model (oracle)", plant)]:
        res = run_mpc(model, plant, x0, U0, n_sim, mcfg)
        print(f"MPC with {name:20s} → closed-loop cost {float(res.cost):8.3f}"
              f"   final state [{float(res.X[-1, 0]):+.3f} "
              f"{float(res.X[-1, 1]):+.3f}]  (target [+3.142 +0.000])")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
