"""Batch-parallel solving: thousands of MPC/trajectory problems over a mesh.

Greenfield capability (BASELINE.json config 4: "4096 vmapped
double-pendulum instances sharded across devices"); the reference solves one
problem at a time on one device.

The whole solver is pure and pytree-based, so batch parallelism is just
``vmap`` + a `NamedSharding` on the batch axis: XLA partitions the program
SPMD across the mesh with **zero collectives** in the hot loop
(embarrassingly parallel — each instance's while_loop runs independently).

The jitted entry points live at module level (static `config`, `System`
statics folded into the pytree treedef) so repeated calls hit the jit cache —
wrapping `jax.jit` around a fresh lambda per call would recompile every time.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ilqr_tpu.models.base import System
from ilqr_tpu.mpc import run_mpc_batched
from ilqr_tpu.solver import IlqrConfig, solve


@functools.partial(jax.jit, static_argnames=("config",))
def _solve_batched(system, x0_batch, U_init_batch, config):
    return jax.vmap(lambda x0, U0: solve(system, x0, U0, config))(
        x0_batch, U_init_batch
    )


@functools.partial(jax.jit, static_argnames=("config", "n_sim"))
def _mpc_batched(solver_system, plant_system, x0_batch, U_init, n_sim, config):
    return run_mpc_batched(
        solver_system, plant_system, x0_batch, U_init, n_sim, config
    )


def solve_batched(
    system: System,
    x0_batch: jnp.ndarray,
    U_init_batch: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    mesh: Mesh | None = None,
    axis: str = "batch",
):
    """Solve B independent problems; shard the batch over the mesh.

    x0_batch: (B, n_x); U_init_batch: (B, N, n_u) or (N, n_u) shared.
    """
    if U_init_batch.ndim == 2:
        U_init_batch = jnp.broadcast_to(
            U_init_batch, (x0_batch.shape[0],) + U_init_batch.shape
        )
    if mesh is not None:
        # shard_map (not jit auto-partitioning): each shard runs the whole
        # vmapped solve on its local slice with zero collectives.
        B = x0_batch.shape[0]
        D = mesh.shape[axis]
        pad = (-B) % D
        if pad:
            # Uneven batches: replicate the last instance into the pad slots
            # so every shard gets a full slice, then trim the results.  The
            # pre-round-4 jit auto-partitioning path tolerated uneven B;
            # shard_map would raise a shape error (ADVICE r4 low #3).
            x0_batch = jnp.concatenate(
                [x0_batch, jnp.broadcast_to(x0_batch[-1:],
                                            (pad,) + x0_batch.shape[1:])])
            U_init_batch = jnp.concatenate(
                [U_init_batch,
                 jnp.broadcast_to(U_init_batch[-1:],
                                  (pad,) + U_init_batch.shape[1:])])
        x0_batch = jax.device_put(x0_batch, NamedSharding(mesh, P(axis)))
        U_init_batch = jax.device_put(
            U_init_batch, NamedSharding(mesh, P(axis, None, None))
        )
        sharded = jax.shard_map(
            lambda xs, us: _solve_batched(system, xs, us, config),
            mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(axis),
            # The solver's scans start from constant carries (the zero cost
            # accumulator, zero gains) that the static vma check types as
            # replicated while their bodies make them shard-varying; every
            # shard runs an independent solve, so there is nothing to check.
            check_vma=False,
        )
        sols = sharded(x0_batch, U_init_batch)
        if pad:
            sols = jax.tree_util.tree_map(lambda a: a[:B], sols)
        return sols
    return _solve_batched(system, x0_batch, U_init_batch, config)


def solve_multistart(
    system: System,
    x0: jnp.ndarray,
    U_inits: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    mesh: Mesh | None = None,
    axis: str = "batch",
):
    """Solve from S initial control guesses; return the best local optimum.

    iLQR is a local method — on multimodal problems (e.g. the double-pendulum
    swing-up, where the reference converges to cost 214.3 and this framework
    to 37.1 from different warm starts) the optimum found depends on the
    initialization.  Batch parallelism makes multistart cheap: all S solves
    run as one vmapped program, sharded over the mesh.

    U_inits: (S, N, n_u).  Returns (best: IlqrSolution of the lowest-cost
    converged-or-maxiter start, sols: the full batched solutions).
    """
    x0_batch = jnp.broadcast_to(x0, (U_inits.shape[0],) + x0.shape)
    if mesh is not None:
        U_inits = jax.device_put(U_inits, NamedSharding(mesh, P(axis, None, None)))
    sols = _solve_batched(system, x0_batch, U_inits, config)
    # Exclude line-search failures unless nothing else exists.
    from ilqr_tpu.solver import LINESEARCH_FAILED

    bad = sols.status == LINESEARCH_FAILED
    ranked = jnp.where(bad & ~jnp.all(bad), jnp.inf, sols.cost)
    i = jnp.argmin(ranked)
    best = jax.tree_util.tree_map(lambda a: a[i], sols)
    return best, sols


def run_mpc_sharded(
    solver_system: System,
    plant_system: System,
    x0_batch: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    mesh: Mesh | None = None,
    axis: str = "batch",
):
    """Closed-loop MPC for a batch of initial states, sharded over the mesh."""
    if mesh is not None:
        x0_batch = jax.device_put(x0_batch, NamedSharding(mesh, P(axis)))
    return _mpc_batched(solver_system, plant_system, x0_batch, U_init, n_sim, config)
