"""iLQG vs deterministic iLQR under control-multiplicative noise.

Pendulum swing-up with effort-proportional actuation noise
x⁺ = f(x, u) + σ·B·u·ξ (ilqr_tpu.ilqg).  The deterministic policy commands
large torques whose noise blows the closed loop up; the iLQG policy trades
tracking for caution and stays bounded.  No reference counterpart — the
reference (`iLQR_class.py`) is deterministic only.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.ilqg import control_multiplicative_noise, simulate_closed_loop


def main(sigma: float = 1.5):
    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2),
                            R=0.1 * jnp.eye(1), Q_f=10.0 * jnp.eye(2),
                            d=0.1, integrator="rk4")
    B = jnp.array([[0.0], [1.0]])
    noise_fn = control_multiplicative_noise(sigma, B)
    x0 = jnp.zeros(2)
    U0 = jnp.zeros((sm(200, 16), 1))

    sol_det = it.solve(sys_, x0, U0,
                       it.IlqrConfig(maxiter=sm(80, 5), tol=1e-7))
    sol_sto = it.solve(sys_, x0, U0,
                       it.IlqrConfig(maxiter=sm(80, 5), tol=1e-7,
                                     noise=noise_fn))
    print(f"deterministic nominal cost: {float(sol_det.cost):.3f} "
          f"(iters {int(sol_det.iterations)})")
    print(f"iLQG (σ={sigma}) nominal cost: {float(sol_sto.cost):.3f} "
          f"(iters {int(sol_sto.iterations)})")

    key = jax.random.PRNGKey(0)
    for name, sol in [("deterministic", sol_det), ("iLQG", sol_sto)]:
        mean, std = simulate_closed_loop(
            sys_, noise_fn, sol.X, sol.U, sol.K, key,
            n_rollouts=sm(256, 8))
        print(f"{name:>13} policy under the noise: "
              f"E[cost] = {float(mean):.2f} ± {float(std):.2f}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(float(os.environ.get("SIGMA", "1.5")))
