"""Multi-process (DCN-boundary) dry run child.

Single-process `shard_map` over a virtual device mesh exercises the SPMD
partitioner but never crosses a process boundary — the launch topology a
real multi-host cluster has (one process per host, collectives riding
the network between them).  This module is run as ``python -m
ilqr_tpu.parallel._multiproc_dryrun <proc_id> <n_procs> <port> <n_local>``
by `__graft_entry__.dryrun_multichip`: N_PROCS coordinated
`jax.distributed` CPU processes, each owning ``n_local`` virtual devices,
jointly execute

  * a batch-sharded vmapped iLQR solve over the global batch mesh, and
  * the horizon-sharded multiple-shooting solve over a global ``time``
    mesh spanning BOTH processes — every halo exchange and interface
    all-gather of the distributed Riccati/affine scans crosses the
    process boundary;

then cross-check the distributed result against a local replay.  Prints
``MULTIPROC_DRYRUN_OK`` on success (the parent greps for it).
"""
import os
import sys


def main(proc_id: int, n_procs: int, port: int, n_local: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local}"
    )
    import jax
    import jax.numpy as jnp
    import numpy as np

    # Pin the platform through the config too: jax may already be imported
    # by the time the env vars above are set (still before any backend
    # client exists, same as tests/conftest.py).
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == n_procs, jax.process_count()
    assert jax.device_count() == n_procs * n_local
    assert len(jax.local_devices()) == n_local

    import ilqr_tpu as it
    from ilqr_tpu.parallel.batch import solve_batched
    from ilqr_tpu.parallel.horizon_solve import solve_ms_horizon_sharded
    from ilqr_tpu.parallel.mesh import make_mesh

    sys_ = it.make_double_pendulum(
        0.01, [jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler",
    )
    D = jax.device_count()

    # --- 1. Batch-sharded solve over the global mesh (data parallel across
    # the process boundary; zero collectives in the hot loop). ---
    mesh_b = make_mesh({"batch": D})
    B = 2 * D
    x0s = jnp.zeros((B, 4)).at[:, 0].add(0.05 * jnp.arange(B))
    sols = solve_batched(sys_, x0s, jnp.zeros((16, 2)),
                         it.IlqrConfig(maxiter=2), mesh=mesh_b)
    finite = jax.jit(
        lambda c: jnp.all(jnp.isfinite(c)),
        out_shardings=jax.sharding.NamedSharding(
            mesh_b, jax.sharding.PartitionSpec()),
    )(sols.cost)
    assert bool(finite)

    # --- 2. Horizon-sharded MS solve over a time mesh spanning both
    # processes: halo ppermutes + interface all-gathers cross DCN. ---
    mesh_t = make_mesh({"time": D})
    cfg = it.IlqrConfig(maxiter=2, tol=1e-6, defect_iters=4)
    N_s = 8 * D
    X_d, U_d, cost_d, _, _ = jax.jit(
        lambda x, u: solve_ms_horizon_sharded(sys_, x, u, cfg, mesh_t)
    )(jnp.zeros(4), jnp.zeros((N_s, 2)))
    jax.block_until_ready(cost_d)
    cost_val = float(jax.device_get(
        jax.jit(lambda c: c,
                out_shardings=jax.sharding.NamedSharding(
                    mesh_t, jax.sharding.PartitionSpec()))(cost_d)))
    assert np.isfinite(cost_val)

    if proc_id == 0:
        print(f"MULTIPROC_DRYRUN_OK procs={n_procs} local={n_local} "
              f"global={D} B={B} N={N_s} ms_cost={cost_val:.6f}",
              flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]))
