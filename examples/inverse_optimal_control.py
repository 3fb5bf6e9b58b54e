"""Inverse optimal control: learn cost weights from demonstrations by
differentiating THROUGH the iLQR solve (ilqr_tpu.diff.solve_implicit).

An expert demonstrates pendulum swing-ups under hidden cost weights
(Q, R).  We recover them by gradient descent on the mismatch between the
learner's optimal controls and the demonstrations — the gradient flows
through the converged solve via the implicit function theorem, so the
whole learning step is one jitted device program (and vmaps over a dataset
of demonstrations).

No reference counterpart: the reference solver is a host-side loop with
no differentiable surface.  Run: python examples/inverse_optimal_control.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.diff import solve_implicit


def make_system(log_w):
    """Pendulum whose cost weights are parameterized by log-weights
    (q_theta, q_thetadot, r)."""
    w = jnp.exp(log_w)
    return it.make_pendulum(
        0.05, [jnp.pi, 0.0],
        Q=jnp.diag(jnp.array([w[0], w[1]])),
        R=w[2] * jnp.eye(1),
        Q_f=10.0 * jnp.eye(2),
        integrator="rk4",
    )


def main():
    N = sm(60, 10)
    cfg = it.IlqrConfig(maxiter=sm(150, 10), tol=1e-9)
    U0 = jnp.zeros((N, 1))
    x0s = jnp.stack([
        jnp.array([0.2, 0.0]), jnp.array([0.6, 0.0]),
        jnp.array([-0.4, 0.5]), jnp.array([1.0, -0.5]),
    ])

    # --- Expert demonstrations under hidden weights. ---
    log_w_true = jnp.log(jnp.array([2.0, 0.5, 0.25]))
    expert = make_system(log_w_true)
    demo_U = jax.jit(jax.vmap(lambda x0: it.solve(expert, x0, U0, cfg).U))(x0s)

    # --- Learner: gradient descent through the solve. ---
    def loss(log_w):
        sys_ = make_system(log_w)
        sols_U = jax.vmap(
            lambda x0: solve_implicit(sys_, x0, U0, cfg).U
        )(x0s)
        return jnp.mean((sols_U - demo_U) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss))
    log_w = jnp.zeros(3)  # start from all-ones weights
    lr = 1.0
    t0 = time.perf_counter()
    val, g = grad_fn(log_w)
    for k in range(sm(60, 2)):
        # Backtracked gradient descent — the landscape is stiff in the
        # small-R direction, so a fixed step diverges.
        cand = log_w - lr * g
        val_c, g_c = grad_fn(cand)
        if val_c < val:
            log_w, val, g = cand, val_c, g_c
            lr = min(lr * 1.5, 4.0)
        else:
            lr *= 0.3
        if k % 10 == 0:
            print(f"iter {k:3d}  loss {val:.6f}  lr {lr:.3f}  "
                  f"weights {jnp.exp(log_w)}")
    print(f"\nlearned weights: {jnp.exp(log_w)}")
    print(f"true weights:    {jnp.exp(log_w_true)}")
    print(f"final loss {loss(log_w):.2e}  ({time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
