"""Batched MPC: thousands of double-pendulum instances, sharded over the mesh.

Greenfield workload (BASELINE.json config 4, no reference counterpart):
vmap the full closed-loop MPC over a batch of initial states and shard the
batch axis across all available devices.  Reports solves/sec throughput.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.parallel.batch import run_mpc_sharded, solve_batched
from ilqr_tpu.parallel.mesh import make_mesh
from ilqr_tpu.utils.timing import timed, warmup


def main(B: int = 512):
    B = sm(B, 8)
    dt = 0.01
    N_h = sm(100, 12)
    sys_ = it.make_double_pendulum(
        dt, x_target=[jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="rk4",
    )
    n_dev = len(jax.devices())
    mesh = make_mesh({"batch": n_dev}) if n_dev > 1 else None
    print(f"devices={n_dev} mesh={'batch:%d' % n_dev if mesh else 'single'}")

    key = jax.random.PRNGKey(0)
    x0s = 0.3 * jax.random.normal(key, (B, 4))
    U0 = jnp.zeros((N_h, 2))
    cfg = it.IlqrConfig(maxiter=sm(10, 3), tol=1e-5)

    fn = lambda xs: solve_batched(sys_, xs, U0, cfg, mesh=mesh)
    warmup(fn, x0s)
    sec, sols = timed(fn, x0s, reps=3)
    print(f"batched open-loop solves: B={B}  {sec * 1e3:.1f} ms "
          f"-> {B / sec:.0f} solves/s; mean cost={float(sols.cost.mean()):.3f}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
