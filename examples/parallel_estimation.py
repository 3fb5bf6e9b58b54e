"""Parallel-in-time state estimation on a long pendulum record.

Greenfield workload (no reference counterpart — the reference assumes full
state feedback everywhere, `/root/reference/python/run_iLQR_MPC.py:118-130`):
estimate a partially-observed (θ only), noise-driven pendulum trajectory from
a 100k-step measurement record with

  1. the sequential extended Kalman filter / RTS smoother
     (`ilqr_tpu.estimation`) — O(N)-depth scans, and
  2. the associative-scan filter / iterated extended smoother
     (`ilqr_tpu.estimation_parallel`) — O(log N) depth per sweep,

and compare wall-clock + RMS-to-truth.  The parallel filtering element is the
parallel-Riccati element (`ops/parallel_riccati.py::combine`) scanned forward
— estimation and control ride the same algebra.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.estimation import EkfState, run_ekf, run_eks
from ilqr_tpu.estimation_parallel import run_ekf_parallel, run_eks_parallel
from ilqr_tpu.utils.timing import timed, warmup


def main(N: int = 100_000):
    dt = 0.001
    sys_ = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")
    obs = lambda x: x[:1]                       # measure θ only
    Qp, Ro = 1e-6 * jnp.eye(2), 1e-3 * jnp.eye(1)
    x0 = jnp.array([0.3, 0.0])

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    U = 0.6 * jnp.sin(jnp.linspace(0, 40, N))[:, None] \
        + 0.05 * jax.random.normal(k1, (N, 1))
    X_true, _ = jax.jit(lambda u: it.rollout(sys_, x0, u))(U)
    Y = jax.vmap(obs)(X_true[1:]) + 0.03 * jax.random.normal(k2, (N, 1))
    s0 = EkfState(x_hat=x0, P=0.1 * jnp.eye(2))

    runs = [
        ("EKF  sequential ", jax.jit(
            lambda y: run_ekf(sys_, obs, s0, U, y, Qp, Ro)[1])),
        ("EKF  parallel   ", jax.jit(
            lambda y: run_ekf_parallel(sys_, obs, s0, U, y, Qp, Ro)[0])),
        ("EKS  sequential ", jax.jit(
            lambda y: run_eks(sys_, obs, s0, U, y, Qp, Ro)[0])),
        ("EKS  parallel(2)", jax.jit(
            lambda y: run_eks_parallel(sys_, obs, s0, U, y, Qp, Ro,
                                       iters=2)[0])),
    ]
    for name, fn in runs:
        Xh = warmup(fn, Y)
        t, _ = timed(fn, Y, reps=3)
        rms = float(jnp.sqrt(jnp.mean((Xh - X_true[1:]) ** 2)))
        print(f"{name}: {t * 1e3:8.1f} ms   RMS-to-truth {rms:.2e}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(int(os.environ.get("N_HORIZON", sm(100_000, 512))))
