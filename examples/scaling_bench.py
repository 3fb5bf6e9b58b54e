"""Horizon-sharding scaling-efficiency harness (BASELINE.md protocol:
"1-chip → N-host scaling efficiency on a 10k-step horizon, target ≥80%").

Measures the horizon-sharded Riccati backward pass across mesh sizes
{1, 2, 4, …, n_devices}.  On a multi-GPU host this reports true scaling
efficiency; it can also be run against the virtual CPU device mesh (set
ILQR_TPU_FORCE_CPU=1 XLA_FLAGS=--xla_force_host_platform_device_count=8) to
validate the harness and the communication structure — virtual-device
timings share one socket, so efficiency numbers there are not
hardware-meaningful.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax

if os.environ.get("ILQR_TPU_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.parallel.horizon import backward_pass_sharded
from ilqr_tpu.parallel.mesh import make_mesh
from ilqr_tpu.utils.timing import timed, warmup


def main(N: int = 10_240):
    sys_ = it.make_double_pendulum(
        0.005, [jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler",
    )
    U = 0.05 * jnp.sin(jnp.linspace(0, 20.0, N))[:, None] * jnp.ones((1, 2))
    X, _ = jax.jit(lambda u: it.rollout(sys_, jnp.zeros(4), u))(U)
    exp = jax.block_until_ready(
        jax.jit(lambda x, u: linearize_trajectory(sys_, x, u))(X, U)
    )

    devs = jax.devices()
    bp1 = jax.jit(lambda e: backward_pass(e, 0.0))
    warmup(bp1, exp)
    t1, _ = timed(bp1, exp, reps=10)
    print(f"D=1 (sequential): {t1 * 1e3:.2f} ms  {N / t1:,.0f} timesteps/s")

    d = 2
    base = None
    while d <= len(devs):
        mesh = make_mesh({"time": d}, devices=devs[:d])
        bp = jax.jit(lambda e: backward_pass_sharded(e, mesh, axis="time"))
        warmup(bp, exp)
        td, _ = timed(bp, exp, reps=10)
        if base is None:
            base = td * d  # cost of the 2-shard program per shard
        eff = base / (td * d)
        print(f"D={d} (horizon-sharded): {td * 1e3:.2f} ms  "
              f"{N / td:,.0f} timesteps/s  efficiency vs D=2: {eff:.1%}")
        d *= 2

    # Whole-solve scaling: fully horizon-sharded multiple shooting (the
    # iteration is one distributed suffix scan + one distributed prefix scan
    # + vmapped local work; communication independent of N).
    from ilqr_tpu.parallel.horizon_solve import solve_ms_horizon_sharded

    cfg = it.IlqrConfig(maxiter=sm(30, 2), tol=1e-5)
    d = 2
    base = None
    while d <= len(devs):
        mesh = make_mesh({"time": d}, devices=devs[:d])
        ms = jax.jit(lambda x, u: solve_ms_horizon_sharded(
            sys_, x, u, cfg, mesh)[2])
        warmup(ms, jnp.zeros(4), U)
        td, _ = timed(ms, jnp.zeros(4), U, reps=3)
        if base is None:
            base = td * d
        eff = base / (td * d)
        print(f"D={d} (sharded MS solve): {td * 1e3:.2f} ms  "
              f"efficiency vs D=2: {eff:.1%}")
        d *= 2


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(int(os.environ.get("N_HORIZON", sm(10_240, 256))))
