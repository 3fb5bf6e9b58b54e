"""Horizon (time-axis) sharding of the Riccati backward pass across chips.

Greenfield capability (BASELINE.json config 5) — the reference's backward
pass is a single-device sequential scan.  This implements the distributed
suffix-scan of the associative Riccati elements
(`ilqr_tpu.ops.parallel_riccati`) over a ``time`` mesh axis:

    1. each device runs a *local* associative suffix-scan over its horizon
       block (O(log(N/D)) depth, no communication);
    2. the per-block totals (one Riccati element per device, a few n_x×n_x
       matrices) are all-gathered — this is the only collective, and its
       payload is O(D·n_x²), independent of N;
    3. each device combines the blocks to its right plus the terminal element
       into its incoming boundary ("halo") element;
    4. local suffixes are closed against the boundary and gains are computed
       blockwise in parallel.

This is the block decomposition of the block-tridiagonal KKT factorization
with interface-block exchange (cf. Nielsen & Axehill arXiv:1407.6898,
SURVEY.md §5 "long-context / sequence parallelism").
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ilqr_tpu.models.base import f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion
from ilqr_tpu.ops.parallel_riccati import (
    RiccatiElement,
    combine,
    gains_from_value,
    make_elements,
)


def _suffix_scan_local(elems: RiccatiElement) -> RiccatiElement:
    return jax.lax.associative_scan(
        lambda a, b: combine(b, a), elems, reverse=True, axis=0
    )


def _backward_block(axis_name, n_blocks, elems_blk, term, exp_blk, reg):
    """Per-device body (runs under shard_map).

    elems_blk: this device's stage elements, (N/D, …).
    term: the terminal element (replicated, no leading axis).
    exp_blk: this device's slice of the trajectory expansion.
    """
    d = jax.lax.axis_index(axis_name)

    # 1. Local suffix scan (no communication).
    local = _suffix_scan_local(elems_blk)
    block_total = jax.tree_util.tree_map(lambda a: a[0], local)

    # 2. One small all-gather of the per-block totals.
    gathered = jax.lax.all_gather(block_total, axis_name)  # (D, …)

    # 3. Boundary element: blocks strictly to the right, then the terminal.
    #    lax.scan over the gathered blocks with a masked combine (d is
    #    traced) — a statically unrolled loop here inflated the per-shard
    #    HLO ~8x and XLA:CPU compile of the DP-sized executable took ~150 s
    #    (measured r3); the scan body compiles once.
    def fold(right, blk_j_and_j):
        blk_j, j = blk_j_and_j
        cand = combine(blk_j, right)
        return jax.tree_util.tree_map(
            lambda c, r: jnp.where(j > d, c, r), cand, right), None

    js = jnp.arange(n_blocks - 1, -1, -1)
    gathered_rev = jax.tree_util.tree_map(lambda a: a[js], gathered)
    # The masked fold makes the carry shard-varying (the mask uses d); the
    # replicated terminal must be pcast to the same vma type up front.
    term_v = jax.tree_util.tree_map(
        lambda a: jax.lax.pcast(a, (axis_name,), to="varying"), term)
    right, _ = jax.lax.scan(fold, term_v, (gathered_rev, js))

    # 4. Close local suffixes against the boundary.
    bat = jax.vmap(combine, in_axes=(0, None))
    suffix = bat(local, right)            # suffix over k..N incl. terminal
    # Shifted suffix (k+1..N) drives the gains at k.
    local_shift = jax.tree_util.tree_map(lambda a: a[1:], local)
    suffix_next_head = bat(local_shift, right)
    suffix_next = jax.tree_util.tree_map(
        lambda h, r: jnp.concatenate([h, r[None]], axis=0),
        suffix_next_head,
        right,
    )

    V_x = -suffix_next.eta
    V_xx = suffix_next.J
    u_ff, K, dVs = gains_from_value(exp_blk, V_x, V_xx, reg)
    dV = jax.lax.psum(jnp.sum(dVs, axis=0), axis_name)
    return u_ff, K, dV


def pad_expansion_identity(exp: TrajectoryExpansion, pad: int):
    """Append ``pad`` identity stages (x⁺ = x, zero cost) to an expansion.

    The Riccati element of such a stage is the combine identity
    (A=I, b=0, C=0, η=0, J=0), so inserting them between the last real stage
    and the terminal leaves every real stage's value function — and hence
    gains — bitwise unchanged; the padded stages' own gains come out exactly
    zero (Q_u=0, Q_uu=l_uu=I) and are trimmed by the caller.  This is what
    makes ragged horizons (N % D != 0) shardable without a ValueError.
    """
    if pad == 0:
        return exp
    n_x = exp.f_x.shape[-1]
    n_u = exp.l_u.shape[-1]
    dt = exp.f_x.dtype

    def z(shape):
        return jnp.zeros((pad,) + shape, dt)

    return TrajectoryExpansion(
        f_x=jnp.concatenate(
            [exp.f_x, jnp.broadcast_to(jnp.eye(n_x, dtype=dt),
                                       (pad, n_x, n_x))]),
        f_u=jnp.concatenate([exp.f_u, z((n_x, n_u))]),
        l_x=jnp.concatenate([exp.l_x, z((n_x,))]),
        l_u=jnp.concatenate([exp.l_u, z((n_u,))]),
        l_xx=jnp.concatenate([exp.l_xx, z((n_x, n_x))]),
        l_ux=jnp.concatenate([exp.l_ux, z((n_u, n_x))]),
        l_uu=jnp.concatenate(
            [exp.l_uu, jnp.broadcast_to(jnp.eye(n_u, dtype=dt),
                                        (pad, n_u, n_u))]),
        v_x=exp.v_x, v_xx=exp.v_xx,
    )


@f32_matmuls
def backward_pass_sharded(
    exp: TrajectoryExpansion,
    mesh: Mesh,
    axis: str = "time",
    reg: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Horizon-sharded drop-in for `ilqr_tpu.ops.riccati.backward_pass`.

    Ragged horizons are fine: when N is not divisible by mesh.shape[axis]
    the expansion is padded with identity stages (exact — see
    `pad_expansion_identity`) and the outputs trimmed back to N.
    Stage arrays are sharded along time; the terminal expansion is replicated.
    """
    n_blocks = mesh.shape[axis]
    N = exp.f_x.shape[0]
    pad = (-N) % n_blocks
    exp = pad_expansion_identity(exp, pad)

    reg = jnp.asarray(reg, dtype=exp.l_u.dtype)
    elems_all = make_elements(exp, reg)
    # Split off the terminal element; stage elements shard over time.
    elems = jax.tree_util.tree_map(lambda a: a[:-1], elems_all)
    term = jax.tree_util.tree_map(lambda a: a[-1], elems_all)

    t_spec = jax.tree_util.tree_map(lambda _: P(axis), elems)
    r_spec = jax.tree_util.tree_map(lambda _: P(), term)
    exp_stage = TrajectoryExpansion(
        f_x=exp.f_x, f_u=exp.f_u, l_x=exp.l_x, l_u=exp.l_u, l_xx=exp.l_xx,
        l_ux=exp.l_ux, l_uu=exp.l_uu,
        v_x=jnp.zeros_like(exp.v_x), v_xx=jnp.zeros_like(exp.v_xx),
    )
    e_spec = TrajectoryExpansion(
        f_x=P(axis), f_u=P(axis), l_x=P(axis), l_u=P(axis), l_xx=P(axis),
        l_ux=P(axis), l_uu=P(axis), v_x=P(), v_xx=P(),
    )

    fn = jax.shard_map(
        partial(_backward_block, axis, n_blocks),
        mesh=mesh,
        in_specs=(t_spec, r_spec, e_spec, P()),
        out_specs=(P(axis), P(axis), P()),
    )
    u_ff, K, dV = fn(elems, term, exp_stage, reg)
    if pad:
        u_ff, K = u_ff[:N], K[:N]
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok
