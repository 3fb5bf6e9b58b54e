"""MPPI vs iLQR on the torque-limited pendulum swing-up.

Compares three controllers on the same closed-loop task:
  1. sampling MPC (ilqr_tpu.mppi.run_mpc_mppi, derivative-free),
  2. gradient MPC (ilqr_tpu.mpc.run_mpc with boxQP control limits),
  3. MPPI-warm-started iLQR open-loop solve (global exploration feeding the
     local optimizer).

Run: python examples/mppi_pendulum.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.mpc import run_mpc
from ilqr_tpu.mppi import MppiConfig, run_mpc_mppi, solve_mppi


def main():
    dt, N_h, n_sim = 0.05, sm(30, 8), sm(120, 6)
    u_lim = 8.0
    sys_ = it.make_pendulum(
        dt, [jnp.pi, 0.0],
        Q=jnp.diag(jnp.array([5.0, 0.5])), R=0.1 * jnp.eye(1),
        Q_f=jnp.diag(jnp.array([50.0, 5.0])),
        integrator="rk4",
    )
    plant = sys_.with_integrator("midpoint")
    x0, U0 = jnp.zeros(2), jnp.zeros((N_h, 1))
    key = jax.random.key(0)

    def timed(name, f, *a):
        out = jax.block_until_ready(f(*a))  # includes compile
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*a))
        print(f"{name:34s} cost {float(out.cost):8.3f}   "
              f"{(time.perf_counter() - t0) * 1e3:7.1f} ms warm")
        return out

    mppi_cfg = MppiConfig(samples=sm(512, 16), iters=sm(4, 2),
                          temperature=0.2, sigma=1.0,
                          noise_beta=0.8, u_min=-u_lim, u_max=u_lim)
    timed("MPPI MPC (512 samples x 4 iters)",
          jax.jit(lambda k: run_mpc_mppi(sys_, plant, x0, U0, n_sim, k, mppi_cfg)),
          key)

    ilqr_cfg = it.IlqrConfig(maxiter=sm(8, 3), tol=1e-6,
                             u_min=-u_lim, u_max=u_lim)
    timed("iLQR MPC (boxQP limits)",
          jax.jit(lambda x: run_mpc(sys_, plant, x, U0, n_sim, ilqr_cfg)), x0)

    # Global-then-local: MPPI explores, iLQR polishes.
    N_ol = sm(80, 10)
    ol_cfg = it.IlqrConfig(maxiter=sm(100, 5), tol=1e-8,
                           u_min=-u_lim, u_max=u_lim)
    warm = timed("MPPI open-loop explore",
                 jax.jit(lambda k: solve_mppi(
                     sys_, x0, jnp.zeros((N_ol, 1)), k,
                     MppiConfig(samples=sm(1024, 16), iters=sm(60, 2),
                                temperature=0.1,
                                sigma=1.2, noise_beta=0.8,
                                u_min=-u_lim, u_max=u_lim))),
                 key)
    timed("iLQR polish (MPPI warm start)",
          jax.jit(lambda u: it.solve(sys_, x0, u, ol_cfg)), warm.U)
    timed("iLQR from zeros (reference)",
          jax.jit(lambda u: it.solve(sys_, x0, u, ol_cfg)),
          jnp.zeros((N_ol, 1)))


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
