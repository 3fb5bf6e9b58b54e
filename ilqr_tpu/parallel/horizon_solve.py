"""Fully horizon-sharded iLQR solve: every per-iteration stage distributed.

`parallel.horizon.backward_pass_sharded` distributes only the Riccati
factorization; the rollouts remained a global sequential chain.  This module
shards the *entire* iteration over a ``time`` mesh axis:

* trajectory layout: stages 0..N-1 sharded along time, the terminal state
  x_N replicated;
* linearization: embarrassingly parallel per shard (no communication);
* backward pass: the distributed suffix scan of Riccati elements
  (local associative scan → all-gathered block totals → boundary combine),
  as in `parallel.horizon`;
* line-search rollouts: **defect-correction sweeps**
  (`ops.parallel_rollout`) — the affine correction recurrence is solved by a
  distributed *prefix* scan (local prefix products → all-gathered block
  totals → left-boundary composition), and the only other communication is a
  single-state halo (`ppermute`) for the next-stage values;
* acceptance logic operates on psum-reduced, replicated candidate costs —
  identical decisions on every shard.

Communication per iteration: O(D·n_x²) all-gathers + one n_x-vector halo per
defect sweep — independent of N.  This is the architecture that scales a
single solve across a pod slice (BASELINE.json config 5); on one host it is
validated against the unsharded solver on the virtual CPU mesh.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.linearize import _stage_expansion
from ilqr_tpu.ops.parallel_riccati import RiccatiElement, combine
from ilqr_tpu.ops.riccati import backward_pass  # noqa: F401  (docs reference)
from ilqr_tpu.ops.smallmat import solve_small
from ilqr_tpu.solver import (
    CONVERGED,
    IlqrConfig,
    LINESEARCH_FAILED,
    MAXITER,
    RUNNING,
)


def _local_suffix(elems):
    return jax.lax.associative_scan(
        lambda a, b: combine(b, a), elems, reverse=True, axis=0
    )


def _sharded_backward(axis, D, exp_blk, v_x, v_xx, reg, n_u, defects=None):
    """Distributed Riccati suffix scan on local expansion blocks.

    ``defects`` ((B, n_x) local multiple-shooting gaps) turn the local
    dynamics affine: the gap lands in the element offset (b += d) and shifts
    the gains' linear Q-terms (V_x → V_x + V_xx·d) — the GNMS backward pass
    (`ilqr_tpu.shooting`), distributed."""
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = exp_blk
    eye_u = jnp.eye(n_u, dtype=l_u.dtype)

    def leaf(f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, d):
        R = l_uu + reg * eye_u
        rhs = jnp.concatenate([l_ux, f_u.T, l_u[:, None]], axis=1)
        sol = solve_small(R, rhs)
        Rinv_M = sol[:, : l_ux.shape[1]]
        Rinv_Bt = sol[:, l_ux.shape[1]:-1]
        Rinv_r = sol[:, -1]
        A = f_x - f_u @ Rinv_M
        b = -f_u @ Rinv_r
        if d is not None:
            b = b + d
        C = f_u @ Rinv_Bt
        C = 0.5 * (C + C.T)
        J = l_xx - l_ux.T @ Rinv_M
        J = 0.5 * (J + J.T)
        eta = -(l_x - l_ux.T @ Rinv_r)
        return RiccatiElement(A, b, C, eta, J)

    if defects is None:
        elems = jax.vmap(
            lambda *a: leaf(*a, None)
        )(f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu)
    else:
        elems = jax.vmap(leaf)(f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, defects)
    term = RiccatiElement(
        A=jnp.zeros_like(v_xx), b=jnp.zeros_like(v_x),
        C=jnp.zeros_like(v_xx), eta=-v_x, J=v_xx,
    )

    d_idx = jax.lax.axis_index(axis)
    local = _local_suffix(elems)
    block_total = jax.tree_util.tree_map(lambda a: a[0], local)
    gathered = jax.lax.all_gather(block_total, axis)

    right = term
    for j in range(D - 1, -1, -1):
        blk_j = jax.tree_util.tree_map(lambda a: a[j], gathered)
        cand = combine(blk_j, right)
        right = jax.tree_util.tree_map(
            lambda c, r: jnp.where(j > d_idx, c, r), cand, right
        )

    bat = jax.vmap(combine, in_axes=(0, None))
    local_shift = jax.tree_util.tree_map(lambda a: a[1:], local)
    head = bat(local_shift, right)
    suffix_next = jax.tree_util.tree_map(
        lambda h, r: jnp.concatenate([h, r[None]], axis=0), head, right
    )
    V_x = -suffix_next.eta
    V_xx = suffix_next.J
    if defects is not None:
        V_x = V_x + (V_xx @ defects[..., None])[..., 0]

    def gains(f_x, f_u, l_u, l_ux, l_uu, vx, vxx):
        fuT_Vxx = f_u.T @ vxx
        Q_u = l_u + f_u.T @ vx
        Q_ux = l_ux + fuT_Vxx @ f_x
        Q_uu = l_uu + fuT_Vxx @ f_u + reg * eye_u
        rhs = jnp.concatenate([Q_ux, Q_u[:, None]], axis=1)
        sol = -solve_small(Q_uu, rhs)
        return sol[:, -1], sol[:, :-1]

    u_ff, K = jax.vmap(gains)(f_x, f_u, l_u, l_ux, l_uu, V_x, V_xx)
    return u_ff, K


def _dist_affine_prefix(axis, D, A, d, delta0):
    """Distributed δ_{k+1} = A_k δ_k + d_k: local prefix scans + boundary.

    A: (B, n, n) local block, d: (B, n), delta0: (n,) replicated (= δ at the
    global start).  Returns local δ at stages (B, n) (δ_k for local k) and the
    global final δ_N (replicated).
    """

    def comp(e1, e2):
        P1, q1 = e1
        P2, q2 = e2
        return P2 @ P1, (P2 @ q1[..., None])[..., 0] + q2

    P_loc, q_loc = jax.lax.associative_scan(comp, (A, d), axis=0)
    tot = jax.tree_util.tree_map(lambda a: a[-1], (P_loc, q_loc))
    gathered = jax.lax.all_gather(tot, axis)  # (D, …)

    d_idx = jax.lax.axis_index(axis)
    n = A.shape[-1]
    left = (jnp.eye(n, dtype=A.dtype), jnp.zeros((n,), A.dtype))
    # Compose blocks strictly to the LEFT of this shard, in order 0..d-1.
    for j in range(D):
        blk = jax.tree_util.tree_map(lambda a: a[j], gathered)
        cand = comp(left, blk)
        left = jax.tree_util.tree_map(
            lambda c, l: jnp.where(j < d_idx, c, l), cand, left
        )
    # δ at the start of this shard.
    delta_start = (left[0] @ delta0[..., None])[..., 0] + left[1]
    # δ after each local stage: local prefix applied to delta_start.
    deltas_after = (P_loc @ delta_start[None, :, None])[..., 0] + q_loc
    # δ at local stage positions (before each stage): shift.
    deltas_at = jnp.concatenate([delta_start[None], deltas_after[:-1]], axis=0)
    # Global final δ_N: composition of ALL blocks applied to delta0.
    full = (jnp.eye(n, dtype=A.dtype), jnp.zeros((n,), A.dtype))
    for j in range(D):
        blk = jax.tree_util.tree_map(lambda a: a[j], gathered)
        full = comp(full, blk)
    delta_N = (full[0] @ delta0[..., None])[..., 0] + full[1]
    return deltas_at, delta_N


def _dist_affine_prefix_multi(axis, D, A, q):
    """Multi-candidate distributed prefix: δ_{k+1} = A_k δ_k + q_k^{(a)},
    δ_0 = 0 globally, one SHARED transition chain for all candidates.

    A: (B, n, n) local block; q: (B, nc, n) local per-candidate drives.
    Returns (deltas_at (B, nc, n) — δ at each local stage — and
    delta_N (nc, n), the global final δ, replicated)."""

    def comp(e1, e2):
        P1, q1 = e1
        P2, q2 = e2
        return P2 @ P1, jnp.einsum("...ij,...aj->...ai", P2, q1) + q2

    P_loc, q_loc = jax.lax.associative_scan(comp, (A, q), axis=0)
    tot = (P_loc[-1], q_loc[-1])                       # ((n,n), (nc,n))
    gathered = jax.lax.all_gather(tot, axis)           # ((D,n,n), (D,nc,n))

    d_idx = jax.lax.axis_index(axis)
    n = A.shape[-1]
    nc = q.shape[-2]
    ident = (jnp.eye(n, dtype=A.dtype), jnp.zeros((nc, n), A.dtype))
    left = ident
    full = ident
    for j in range(D):
        blk = (gathered[0][j], gathered[1][j])
        cand = comp(left, blk)
        left = jax.tree_util.tree_map(
            lambda c, l: jnp.where(j < d_idx, c, l), cand, left
        )
        full = comp(full, blk)
    # δ at the start of this shard (δ_0 = 0 → pure offset part).
    delta_start = left[1]                              # (nc, n)
    deltas_after = jnp.einsum("bij,aj->bai", P_loc, delta_start) + q_loc
    deltas_at = jnp.concatenate([delta_start[None], deltas_after[:-1]], axis=0)
    return deltas_at, full[1]


def _valid_stage_mask(axis, N_local, N_true):
    """(B,) bool: which of this shard's stage slots are REAL stages.

    Ragged horizons (N % D != 0) are padded to N_pad = D·N_local with
    passthrough stages appended at the global end; a padded slot's dynamics
    are forced to x⁺ = x with zero cost (`_mask_exp_blk` + zeroed defects),
    which makes every padded slot track the terminal state exactly and
    leaves all real-stage value functions, gains, costs, and accept
    decisions bitwise identical to the unpadded problem
    (VERDICT r4 next-round #3)."""
    k = jax.lax.axis_index(axis) * N_local + jnp.arange(N_local)
    return k < N_true


def _mask_exp_blk(exp_blk, valid):
    """Overwrite padded stages with identity dynamics and zero cost."""
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = exp_blk
    n_x = f_x.shape[-1]
    n_u = l_uu.shape[-1]

    def m(a, repl):
        v = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(v, a, repl)

    I_x = jnp.eye(n_x, dtype=f_x.dtype)
    I_u = jnp.eye(n_u, dtype=f_x.dtype)
    return (m(f_x, I_x), m(f_u, 0.0), m(l_x, 0.0), m(l_u, 0.0),
            m(l_xx, 0.0), m(l_ux, 0.0), m(l_uu, I_u))


def _shift_with_halo(axis, D, X_loc, x_N):
    """Next-stage states for each local stage: shift left within the shard,
    halo = right neighbor's first state (x_N for the last shard)."""
    halo = jax.lax.ppermute(
        X_loc[0], axis, [(i, (i - 1) % D) for i in range(D)]
    )
    is_last = jax.lax.axis_index(axis) == D - 1
    halo = jnp.where(is_last, x_N, halo)
    return jnp.concatenate([X_loc[1:], halo[None]], axis=0)


def _ms_iteration(system, config, ms, alphas, axis, D, N_true, carry):
    """One sharded multiple-shooting iteration (runs under shard_map).

    Cheaper in communication than the single-shooting `_iteration`: the
    update pass is ONE multi-candidate distributed prefix scan (exact — the
    MS update is affine, `ilqr_tpu.shooting`), where single shooting needs
    `defect_iters` sweeps each with its own prefix scan and halo exchange.
    Ragged horizons run via `_valid_stage_mask` passthrough padding.
    """
    X_loc, x_N, U_loc, cost, prev_merit, nu, k, status = carry
    n_u = U_loc.shape[-1]
    n_alpha = len(alphas)
    alph = jnp.asarray(alphas, dtype=X_loc.dtype)
    N_local = X_loc.shape[0]
    ragged = N_true != D * N_local
    valid = _valid_stage_mask(axis, N_local, N_true) if ragged else None

    # --- 1. Local defects/merit (one vmapped evaluation + one halo). ---
    F = jax.vmap(lambda x, u: step(system, x, u))(X_loc, U_loc)
    d_loc = F - _shift_with_halo(axis, D, X_loc, x_N)
    if ragged:
        d_loc = jnp.where(valid[:, None], d_loc, 0.0)
    defect = jax.lax.pmax(jnp.max(jnp.abs(d_loc)), axis)
    sum_d = jax.lax.psum(jnp.sum(jnp.abs(d_loc)), axis)
    merit = cost + nu * sum_d

    # --- 2. Local linearization (embarrassingly parallel). ---
    exp_blk = jax.vmap(lambda x, u: _stage_expansion(system, x, u))(X_loc, U_loc)
    if ragged:
        exp_blk = _mask_exp_blk(exp_blk, valid)
    lf = lambda xx: system.terminal_cost(system.params, xx)
    v_x = jax.grad(lf)(x_N)
    v_xx = jax.hessian(lf)(x_N)

    # --- 3. Distributed defect-aware backward pass. ---
    reg = jnp.asarray(0.0, X_loc.dtype)
    u_ff, K = _sharded_backward(axis, D, exp_blk, v_x, v_xx, reg, n_u,
                                defects=d_loc)

    # --- 4. Multi-candidate affine update pass (exact, one prefix scan). ---
    f_x, f_u = exp_blk[0], exp_blk[1]
    A_cl = f_x + f_u @ K
    base = (f_u @ u_ff[..., None])[..., 0] + d_loc       # (B, n_x)
    q = alph[None, :, None] * base[:, None, :]           # (B, nc, n_x)
    deltas_at, delta_N = _dist_affine_prefix_multi(axis, D, A_cl, q)
    X_c = X_loc[:, None] + deltas_at                     # (B, nc, n_x)
    xN_c = x_N[None] + delta_N                           # (nc, n_x)
    U_c = (U_loc[:, None] + alph[None, :, None] * u_ff[:, None]
           + jnp.einsum("bij,baj->bai", K, deltas_at))   # (B, nc, n_u)

    # --- 5. Candidate scoring (vmapped locals + psum). ---
    stage = jax.vmap(jax.vmap(
        lambda x, u: system.stage_cost(system.params, x, u)))(X_c, U_c)
    if ragged:
        stage = jnp.where(valid[:, None], stage, 0.0)
    costs = jax.lax.psum(jnp.sum(stage, axis=0), axis) + jax.vmap(lf)(xN_c)
    F_c = jax.vmap(jax.vmap(lambda x, u: step(system, x, u)))(X_c, U_c)
    halo_c = jax.lax.ppermute(
        X_c[0], axis, [(i, (i - 1) % D) for i in range(D)])
    is_last = jax.lax.axis_index(axis) == D - 1
    halo_c = jnp.where(is_last, xN_c, halo_c)
    X_next_c = jnp.concatenate([X_c[1:], halo_c[None]], axis=0)
    d_c = jnp.abs(F_c - X_next_c)
    if ragged:
        d_c = jnp.where(valid[:, None, None], d_c, 0.0)
    sum_d_c = jax.lax.psum(jnp.sum(d_c, axis=(0, 2)), axis)
    merits = costs + nu * sum_d_c

    accept = (merits <= merit) & jnp.isfinite(merits)
    any_accept = jnp.any(accept)
    idx = jnp.argmax(accept)

    # Stationary + feasible rejection → converged (see ilqr_tpu.shooting).
    stationary = (defect <= ms.dtol) & (jnp.min(merits) >= merit - config.tol)
    converged_now = (k > 0) & (jnp.abs(merit - prev_merit) <= config.tol) & (
        defect <= ms.dtol)

    X_new = jnp.where(any_accept, jnp.take(X_c, idx, axis=1), X_loc)
    xN_new = jnp.where(any_accept, xN_c[idx], x_N)
    U_new = jnp.where(any_accept, jnp.take(U_c, idx, axis=1), U_loc)
    cost_new = jnp.where(any_accept, costs[idx], cost)
    merit_out = jnp.where(any_accept, merit, jnp.inf)
    nu_new = jnp.where(any_accept, nu, jnp.minimum(nu * ms.nu_factor, ms.nu_max))
    status_new = jnp.where(
        converged_now,
        CONVERGED,
        jnp.where(
            any_accept,
            status,
            jnp.where(
                stationary,
                CONVERGED,
                jnp.where(nu * ms.nu_factor > ms.nu_max,
                          LINESEARCH_FAILED, status),
            ),
        ),
    )
    keep = converged_now
    X_new = jnp.where(keep, X_loc, X_new)
    xN_new = jnp.where(keep, x_N, xN_new)
    U_new = jnp.where(keep, U_loc, U_new)
    cost_new = jnp.where(keep, cost, cost_new)
    return (X_new, xN_new, U_new, cost_new, merit_out, nu_new,
            k + jnp.where(keep, 0, 1), status_new)


def _iteration(system, config, alphas, axis, D, N_local, N_true, carry):
    """One sharded iLQR iteration (runs under shard_map).

    N_true < D·N_local marks a ragged horizon: the trailing padded slots run
    as passthrough stages (see `_valid_stage_mask`)."""
    X_loc, x_N, U_loc, cost, prev_cost, k, status = carry
    n_u = U_loc.shape[-1]
    ragged = N_true != D * N_local
    valid = _valid_stage_mask(axis, N_local, N_true) if ragged else None

    # --- 1. Local linearization (embarrassingly parallel). ---
    exp_blk = jax.vmap(lambda x, u: _stage_expansion(system, x, u))(X_loc, U_loc)
    if ragged:
        exp_blk = _mask_exp_blk(exp_blk, valid)
    lf = lambda xx: system.terminal_cost(system.params, xx)
    v_x = jax.grad(lf)(x_N)
    v_xx = jax.hessian(lf)(x_N)

    # --- 2. Distributed backward pass. ---
    reg = jnp.asarray(0.0, X_loc.dtype)
    u_ff, K = _sharded_backward(axis, D, exp_blk, v_x, v_xx, reg, n_u)

    f_x, f_u = exp_blk[0], exp_blk[1]
    A_cl = f_x + f_u @ K

    # --- 3. Defect-correction line search, one α at a time (static loop). ---
    def rollout_alpha(alpha):
        Xc, xNc = X_loc, x_N

        def sweep(_, val):
            Xc, xNc = val
            U = U_loc + alpha * u_ff + (K @ (Xc - X_loc)[..., None])[..., 0]
            F = jax.vmap(lambda x, u: step(system, x, u))(Xc, U)
            # next-stage states: shift left within the shard; the halo (first
            # state of the right neighbor, or x_N for the last shard).
            first = Xc[0]
            halo = jax.lax.ppermute(
                first, axis, [(i, (i - 1) % D) for i in range(D)]
            )
            is_last = jax.lax.axis_index(axis) == D - 1
            halo = jnp.where(is_last, xNc, halo)
            X_next = jnp.concatenate([Xc[1:], halo[None]], axis=0)
            d = F - X_next
            if ragged:
                d = jnp.where(valid[:, None], d, 0.0)
            delta0 = jnp.zeros_like(x_N)  # δ at stage 0 (x0 is fixed)
            deltas_at, delta_N = _dist_affine_prefix(axis, D, A_cl, d, delta0)
            return Xc + deltas_at, xNc + delta_N

        Xc, xNc = jax.lax.fori_loop(0, config.defect_iters, sweep, (Xc, xNc))
        U = U_loc + alpha * u_ff + (K @ (Xc - X_loc)[..., None])[..., 0]
        F = jax.vmap(lambda x, u: step(system, x, u))(Xc, U)
        first = Xc[0]
        halo = jax.lax.ppermute(first, axis, [(i, (i - 1) % D) for i in range(D)])
        is_last = jax.lax.axis_index(axis) == D - 1
        halo = jnp.where(is_last, xNc, halo)
        X_next = jnp.concatenate([Xc[1:], halo[None]], axis=0)
        d_fin = jnp.abs(F - X_next)
        stage_c = jax.vmap(
            lambda x, u: system.stage_cost(system.params, x, u))(Xc, U)
        if ragged:
            d_fin = jnp.where(valid[:, None], d_fin, 0.0)
            stage_c = jnp.where(valid, stage_c, 0.0)
        defect = jax.lax.pmax(jnp.max(d_fin), axis)
        c = jax.lax.psum(jnp.sum(stage_c), axis) + system.terminal_cost(
            system.params, xNc)
        return Xc, xNc, U, c, defect

    cands = [rollout_alpha(a) for a in alphas]
    costs = jnp.stack([c[3] for c in cands])
    defects = jnp.stack([c[4] for c in cands])
    accept = (costs <= cost) & jnp.isfinite(costs) & (defects < config.defect_tol)
    any_accept = jnp.any(accept)
    idx = jnp.argmax(accept)

    Xs = jnp.stack([c[0] for c in cands])
    xNs = jnp.stack([c[1] for c in cands])
    Us = jnp.stack([c[2] for c in cands])

    X_new = jnp.where(any_accept, Xs[idx], X_loc)
    xN_new = jnp.where(any_accept, xNs[idx], x_N)
    U_new = jnp.where(any_accept, Us[idx], U_loc)
    cost_new = jnp.where(any_accept, costs[idx], cost)
    status_new = jnp.where(any_accept, status, LINESEARCH_FAILED)
    return (X_new, xN_new, U_new, cost_new, cost, k + 1, status_new)


@f32_matmuls
def solve_ms_horizon_sharded(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig,
    mesh: Mesh,
    axis: str = "time",
    X_init: jnp.ndarray | None = None,
    ms=None,
):
    """Multiple-shooting solve with every stage sharded along the horizon.

    The distributed counterpart of `ilqr_tpu.shooting.solve_ms`: local
    linearization (no communication), distributed defect-aware Riccati
    suffix scan, and ONE multi-candidate distributed affine prefix scan for
    the whole line search (exact — the MS update is affine), plus a
    single-state halo per defect evaluation.  Communication per iteration is
    O(D·(n_x² + n_alpha·n_x)) all-gathers — independent of N, and a factor
    `defect_iters` fewer prefix scans than `solve_horizon_sharded`'s
    sweep-based rollouts.

    X_init may be any (N+1, n_x) warm start (infeasible is fine — gaps are
    what MS closes); default is the constant-x0 trajectory: at pod scale
    there is no reason to pay ANY global rollout.
    Returns (X, U, cost, iterations, status) unsharded.
    """
    from ilqr_tpu.shooting import MsConfig, _node_cost

    if ms is None:
        ms = MsConfig()
    D = mesh.shape[axis]
    N = U_init.shape[0]
    pad = (-N) % D
    alphas = tuple(config.alpha_schedule())

    if X_init is None:
        X_init = jnp.broadcast_to(x0, (N + 1,) + x0.shape)
    X_init = X_init.at[0].set(x0)
    cost0 = _node_cost(system, X_init, U_init)
    if pad:
        # Passthrough padding: padded slots carry the terminal node and zero
        # controls; the masked iteration keeps them tracking x_N exactly.
        X_init = jnp.concatenate(
            [X_init[:-1],
             jnp.broadcast_to(X_init[-1], (pad + 1,) + x0.shape)])
        U_init = jnp.concatenate(
            [U_init, jnp.zeros((pad,) + U_init.shape[1:], U_init.dtype)])

    body_sharded = jax.shard_map(
        partial(_ms_iteration, system, config, ms, alphas, axis, D, N),
        mesh=mesh,
        in_specs=((P(axis), P(), P(axis), P(), P(), P(), P(), P()),),
        out_specs=(P(axis), P(), P(axis), P(), P(), P(), P(), P()),
        check_vma=False,
    )

    def cond(carry):
        _, _, _, _, _, _, k, status = carry
        return (status == RUNNING) & (k < config.maxiter)

    init = (X_init[:-1], X_init[-1], U_init, cost0, jnp.inf,
            jnp.asarray(ms.nu0, dtype=cost0.dtype), jnp.asarray(0),
            jnp.asarray(RUNNING))
    X, xN, U, cost, merit, nu, k, status = jax.lax.while_loop(
        cond, lambda c: body_sharded(c), init
    )
    status = jnp.where(
        (status == RUNNING) & (k >= config.maxiter), MAXITER, status
    )
    X_full = jnp.concatenate([X[:N], xN[None]], axis=0)
    return X_full, U[:N], cost, k, status


@f32_matmuls
def solve_horizon_sharded(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig,
    mesh: Mesh,
    axis: str = "time",
):
    """iLQR solve with every iteration stage sharded along the horizon.

    Returns (X, U, cost, iterations, status) with global (unsharded) outputs.
    Ragged horizons (N % mesh.shape[axis] != 0) run via exact passthrough
    padding (`_valid_stage_mask`).  Uses defect-certified line-search
    rollouts (config.defect_iters / defect_tol).
    """
    D = mesh.shape[axis]
    N = U_init.shape[0]
    pad = (-N) % D
    N_pad = N + pad
    alphas = tuple(config.alpha_schedule())

    # Initial open-loop rollout (one-time, global): parallel-in-time Newton
    # sweeps with a certificate fallback to the sequential chain — at pod
    # scale the O(N) sequential rollout would otherwise dominate startup.
    from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout
    from ilqr_tpu.ops.rollout import rollout as _rollout

    X_p, c_p, defect0 = open_loop_defect_rollout(
        system, x0, U_init, iters=config.defect_iters)
    X0_full, cost0 = jax.lax.cond(
        defect0 < config.defect_tol,
        lambda: (X_p, c_p),
        lambda: _rollout(system, x0, U_init),
    )
    X0 = X0_full[:-1]
    xN0 = X0_full[-1]
    if pad:
        # Padded slots hold the terminal state and zero controls; the masked
        # iteration keeps that invariant (padded slots track x_N exactly).
        X0 = jnp.concatenate(
            [X0, jnp.broadcast_to(xN0, (pad,) + xN0.shape)])
        U_init = jnp.concatenate(
            [U_init, jnp.zeros((pad,) + U_init.shape[1:], U_init.dtype)])

    body_sharded = jax.shard_map(
        partial(_iteration, system, config, alphas, axis, D, N_pad // D, N),
        mesh=mesh,
        in_specs=((P(axis), P(), P(axis), P(), P(), P(), P()),),
        out_specs=(P(axis), P(), P(axis), P(), P(), P(), P()),
        # The body freely mixes replicated scalars (costs, status) with
        # shard-varying blocks and halos; skip the varying-axes type checker.
        check_vma=False,
    )

    def cond(carry):
        _, _, _, cost, prev, k, status = carry
        not_conv = (k == 0) | (jnp.abs(cost - prev) > config.tol)
        return (status == RUNNING) & (k < config.maxiter) & not_conv

    init = (X0, xN0, U_init, cost0, jnp.inf, jnp.asarray(0), jnp.asarray(RUNNING))
    X, xN, U, cost, prev, k, status = jax.lax.while_loop(
        cond, lambda c: body_sharded(c), init
    )
    status = jnp.where(
        status == RUNNING,
        jnp.where(k >= config.maxiter, MAXITER, CONVERGED),
        status,
    )
    X_full = jnp.concatenate([X[:N], xN[None]], axis=0)
    return X_full, U[:N], cost, k, status


def _ms_al_iteration(system, cons, config, ms, alphas, axis, D, N_true,
                     carry, lams, mu):
    """One sharded AL-penalized multiple-shooting iteration (under shard_map).

    `_ms_iteration` with the augmented-Lagrangian stage/terminal penalty
    (`ilqr_tpu.constrained`) fused into the cost model: the per-stage GN
    penalty terms add to the local expansion blocks (no extra communication
    — multiplier slices are sharded with their stages), candidate scoring
    psum-reduces the augmented cost, and the merit is augmented-cost +
    ν·Σ|defect|.  Multipliers/μ are fixed for the whole inner loop (they are
    closure-level inputs, not carry)."""
    from ilqr_tpu.constrained import (
        _al_stage_terms,
        _al_terminal_terms,
        _stage_penalty,
        _terminal_penalty,
    )

    X_loc, x_N, U_loc, base, aug, prev_merit, nu, k, status = carry
    lam_gi, lam_he, lam_gti, lam_hte = (
        lams["gi"], lams["he"], lams["gti"], lams["hte"])
    n_u = U_loc.shape[-1]
    alph = jnp.asarray(alphas, dtype=X_loc.dtype)
    N_local = X_loc.shape[0]
    ragged = N_true != D * N_local
    valid = _valid_stage_mask(axis, N_local, N_true) if ragged else None

    # --- 1. Local defects/merit (one vmapped evaluation + one halo). ---
    F = jax.vmap(lambda x, u: step(system, x, u))(X_loc, U_loc)
    d_loc = F - _shift_with_halo(axis, D, X_loc, x_N)
    if ragged:
        d_loc = jnp.where(valid[:, None], d_loc, 0.0)
    defect = jax.lax.pmax(jnp.max(jnp.abs(d_loc)), axis)
    sum_d = jax.lax.psum(jnp.sum(jnp.abs(d_loc)), axis)
    merit = aug + nu * sum_d

    # --- 2. Local linearization + AL augmentation (both local). ---
    exp_blk = jax.vmap(lambda x, u: _stage_expansion(system, x, u))(X_loc, U_loc)
    p_x, p_u, p_xx, p_ux, p_uu = jax.vmap(
        lambda lg, lh, x, u: _al_stage_terms(cons, lg, lh, mu, x, u)
    )(lam_gi, lam_he, X_loc, U_loc)
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = exp_blk
    exp_blk = (f_x, f_u, l_x + p_x, l_u + p_u,
               l_xx + p_xx, l_ux + p_ux, l_uu + p_uu)
    if ragged:
        # Mask AFTER the penalty add so padded stages carry neither cost
        # nor constraint-penalty curvature; re-unpack the masked dynamics
        # for the closed-loop transition below.
        exp_blk = _mask_exp_blk(exp_blk, valid)
        f_x, f_u = exp_blk[0], exp_blk[1]
    lf = lambda xx: system.terminal_cost(system.params, xx)
    v_x = jax.grad(lf)(x_N)
    v_xx = jax.hessian(lf)(x_N)
    t_x, t_xx = _al_terminal_terms(cons, lam_gti, lam_hte, mu, x_N)
    v_x, v_xx = v_x + t_x, v_xx + t_xx

    # --- 3. Distributed defect-aware backward pass on the augmented LQ. ---
    reg = jnp.asarray(0.0, X_loc.dtype)
    u_ff, K = _sharded_backward(axis, D, exp_blk, v_x, v_xx, reg, n_u,
                                defects=d_loc)

    # --- 4. Multi-candidate affine update pass (exact, one prefix scan). ---
    A_cl = f_x + f_u @ K
    base_drive = (f_u @ u_ff[..., None])[..., 0] + d_loc
    q = alph[None, :, None] * base_drive[:, None, :]
    deltas_at, delta_N = _dist_affine_prefix_multi(axis, D, A_cl, q)
    X_c = X_loc[:, None] + deltas_at
    xN_c = x_N[None] + delta_N
    U_c = (U_loc[:, None] + alph[None, :, None] * u_ff[:, None]
           + jnp.einsum("bij,baj->bai", K, deltas_at))

    # --- 5. Candidate scoring under base AND augmented cost. ---
    stage = jax.vmap(jax.vmap(
        lambda x, u: system.stage_cost(system.params, x, u)))(X_c, U_c)
    pen = jax.vmap(
        lambda lg, lh, xs, us: jax.vmap(
            lambda x, u: _stage_penalty(cons, lg, lh, mu, x, u))(xs, us)
    )(lam_gi, lam_he, X_c, U_c)
    if ragged:
        stage = jnp.where(valid[:, None], stage, 0.0)
        pen = jnp.where(valid[:, None], pen, 0.0)
    bases = jax.lax.psum(jnp.sum(stage, axis=0), axis) + jax.vmap(lf)(xN_c)
    augs = (bases + jax.lax.psum(jnp.sum(pen, axis=0), axis)
            + jax.vmap(lambda xx: _terminal_penalty(
                cons, lam_gti, lam_hte, mu, xx))(xN_c))
    F_c = jax.vmap(jax.vmap(lambda x, u: step(system, x, u)))(X_c, U_c)
    halo_c = jax.lax.ppermute(
        X_c[0], axis, [(i, (i - 1) % D) for i in range(D)])
    is_last = jax.lax.axis_index(axis) == D - 1
    halo_c = jnp.where(is_last, xN_c, halo_c)
    X_next_c = jnp.concatenate([X_c[1:], halo_c[None]], axis=0)
    d_c = jnp.abs(F_c - X_next_c)
    if ragged:
        d_c = jnp.where(valid[:, None, None], d_c, 0.0)
    sum_d_c = jax.lax.psum(jnp.sum(d_c, axis=(0, 2)), axis)
    merits = augs + nu * sum_d_c

    accept = (merits <= merit) & jnp.isfinite(merits)
    any_accept = jnp.any(accept)
    idx = jnp.argmax(accept)

    stationary = (defect <= ms.dtol) & (jnp.min(merits) >= merit - config.tol)
    converged_now = (k > 0) & (jnp.abs(merit - prev_merit) <= config.tol) & (
        defect <= ms.dtol)

    X_new = jnp.where(any_accept, jnp.take(X_c, idx, axis=1), X_loc)
    xN_new = jnp.where(any_accept, xN_c[idx], x_N)
    U_new = jnp.where(any_accept, jnp.take(U_c, idx, axis=1), U_loc)
    base_new = jnp.where(any_accept, bases[idx], base)
    aug_new = jnp.where(any_accept, augs[idx], aug)
    merit_out = jnp.where(any_accept, merit, jnp.inf)
    nu_new = jnp.where(any_accept, nu,
                       jnp.minimum(nu * ms.nu_factor, ms.nu_max))
    status_new = jnp.where(
        converged_now,
        CONVERGED,
        jnp.where(
            any_accept,
            status,
            jnp.where(
                stationary,
                CONVERGED,
                jnp.where(nu * ms.nu_factor > ms.nu_max,
                          LINESEARCH_FAILED, status),
            ),
        ),
    )
    keep = converged_now
    X_new = jnp.where(keep, X_loc, X_new)
    xN_new = jnp.where(keep, x_N, xN_new)
    U_new = jnp.where(keep, U_loc, U_new)
    base_new = jnp.where(keep, base, base_new)
    aug_new = jnp.where(keep, aug, aug_new)
    return (X_new, xN_new, U_new, base_new, aug_new, merit_out, nu_new,
            k + jnp.where(keep, 0, 1), status_new)


@f32_matmuls
def solve_constrained_ms_horizon_sharded(
    system: System,
    constraints,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig,
    mesh: Mesh,
    axis: str = "time",
    al_config=None,
    ms=None,
    X_init: jnp.ndarray | None = None,
):
    """Constrained (augmented-Lagrangian) multiple-shooting solve with every
    inner stage sharded along the horizon.

    The distributed counterpart of
    `ilqr_tpu.constrained.solve_constrained_ms` (ALTRO's shape: AL outer loop
    × infeasible-start GNMS inner solver): stage multipliers are sharded with
    their stages, the GN penalty terms fuse into the local expansion blocks,
    and each inner iteration costs the same O(D·(n_x² + n_alpha·n_x))
    all-gathers as `solve_ms_horizon_sharded` — independent of N.  Multiplier
    updates between outer iterations are embarrassingly parallel.

    Returns (X, U, cost, violation, outer_iterations, status) unsharded;
    status CONVERGED means violation ≤ al_config.ctol.
    """
    from ilqr_tpu.constrained import AlConfig, INFEASIBLE, _violations
    from ilqr_tpu.shooting import MsConfig, _node_cost

    if al_config is None:
        al_config = AlConfig()
    if ms is None:
        ms = MsConfig()
    D = mesh.shape[axis]
    N = U_init.shape[0]
    pad = (-N) % D
    N_pad = N + pad
    alphas = tuple(config.alpha_schedule())
    dtype = U_init.dtype
    cons = constraints
    p = cons.params
    n_gi = jax.eval_shape(cons.stage_ineq, p, x0, U_init[0]).shape[0]
    n_he = jax.eval_shape(cons.stage_eq, p, x0, U_init[0]).shape[0]

    if X_init is None:
        # Pod scale: no global rollout — constant-x0 start, gaps are fuel
        # for the MS iteration.
        X_init = jnp.broadcast_to(x0, (N + 1,) + x0.shape)
    X_init = X_init.at[0].set(x0)
    if pad:
        # Ragged horizon: passthrough padding (see `_valid_stage_mask`).
        X_init = jnp.concatenate(
            [X_init[:-1],
             jnp.broadcast_to(X_init[-1], (pad + 1,) + x0.shape)])
        U_init = jnp.concatenate(
            [U_init, jnp.zeros((pad,) + U_init.shape[1:], dtype)])

    from ilqr_tpu.constrained import _augmented_traj_cost

    carry_specs = (P(axis), P(), P(axis), P(), P(), P(), P(), P(), P())
    lam_specs = dict(gi=P(axis), he=P(axis), gti=P(), hte=P())
    body_sharded = jax.shard_map(
        partial(_ms_al_iteration, system, cons, config, ms, alphas, axis, D,
                N),
        mesh=mesh,
        in_specs=(carry_specs, lam_specs, P()),
        out_specs=carry_specs,
        check_vma=False,
    )

    lams0 = dict(
        gi=jnp.zeros((N_pad, n_gi), dtype), he=jnp.zeros((N_pad, n_he), dtype),
        gti=jnp.zeros(jax.eval_shape(cons.terminal_ineq, p, x0).shape, dtype),
        hte=jnp.zeros(jax.eval_shape(cons.terminal_eq, p, x0).shape, dtype),
    )

    def _trim_lams(lams):
        return dict(gi=lams["gi"][:N], he=lams["he"][:N],
                    gti=lams["gti"], hte=lams["hte"])

    def inner(X, xN, U, lams, mu):
        # Cost/merit seeds on the REAL stages only (padded slots hold x_N
        # with zero controls — their stage cost is fictitious).
        X_real = jnp.concatenate([X[:N], xN[None]], 0)
        base0 = _node_cost(system, X_real, U[:N])
        aug0 = _augmented_traj_cost(
            system, cons, _trim_lams(lams), mu, X_real, U[:N], base0)
        init = (X, xN, U, base0, aug0, jnp.inf,
                jnp.asarray(ms.nu0, dtype), jnp.asarray(0),
                jnp.asarray(RUNNING))

        def cond(c):
            return (c[8] == RUNNING) & (c[7] < config.maxiter)

        out = jax.lax.while_loop(
            cond, lambda c: body_sharded(c, lams, mu), init)
        return out[0], out[1], out[2], out[3], out[7]

    def outer_cond(s):
        return (s["status"] == RUNNING) & (s["j"] < al_config.max_outer)

    def outer_body(s):
        X, xN, U, base_cost, k_in = inner(
            s["X"], s["xN"], s["U"], s["lams"], s["mu"])
        X_full = jnp.concatenate([X[:N], xN[None]], axis=0)
        viol = _violations(cons, X_full, U[:N])

        def upd_stage(lg, lh, x, u):
            g = cons.stage_ineq(p, x, u)
            h = cons.stage_eq(p, x, u)
            return (jnp.maximum(0.0, lg + s["mu"] * g), lh + s["mu"] * h)

        lg, lh = jax.vmap(upd_stage)(s["lams"]["gi"], s["lams"]["he"], X, U)
        if pad:
            # Padded slots never contribute penalty terms (masked in the
            # iteration); keep their multipliers pinned at zero.
            vstage = (jnp.arange(N_pad) < N)[:, None]
            lg = jnp.where(vstage, lg, 0.0)
            lh = jnp.where(vstage, lh, 0.0)
        gt = cons.terminal_ineq(p, xN)
        ht = cons.terminal_eq(p, xN)
        lgt = jnp.maximum(0.0, s["lams"]["gti"] + s["mu"] * gt)
        lht = s["lams"]["hte"] + s["mu"] * ht
        clamp = lambda l: jnp.clip(l, -al_config.lam_max, al_config.lam_max)
        lams = dict(gi=clamp(lg), he=clamp(lh), gti=clamp(lgt), hte=clamp(lht))

        feasible = viol <= al_config.ctol
        stalled = (s["mu"] >= al_config.mu_max) & (
            viol >= 0.99 * s["violation"])
        status = jnp.where(
            feasible, CONVERGED, jnp.where(stalled, INFEASIBLE, RUNNING))
        improving = viol <= al_config.viol_decrease * s["violation"]
        mu_next = jnp.where(
            improving, s["mu"],
            jnp.minimum(s["mu"] * al_config.mu_factor, al_config.mu_max))
        return {
            **s, "X": X, "xN": xN, "U": U, "cost": base_cost,
            "violation": viol, "lams": lams, "mu": mu_next,
            "j": s["j"] + 1, "status": status,
        }

    init = dict(
        X=X_init[:-1], xN=X_init[-1], U=U_init,
        cost=jnp.asarray(jnp.inf, dtype),
        violation=jnp.asarray(jnp.inf, dtype),
        lams=lams0, mu=jnp.asarray(al_config.mu0, dtype),
        j=jnp.asarray(0), status=jnp.asarray(RUNNING),
    )
    s = jax.lax.while_loop(outer_cond, outer_body, init)
    status = jnp.where(
        (s["status"] == RUNNING) & (s["j"] >= al_config.max_outer),
        MAXITER, s["status"])
    X_full = jnp.concatenate([s["X"][:N], s["xN"][None]], axis=0)
    return X_full, s["U"][:N], s["cost"], s["violation"], s["j"], status


# ---------------------------------------------------------------------------
# 2-D (batch × time) sharded batched MPC: the instance batch shards over one
# mesh axis while EVERY per-step solve iteration's horizon stages (local
# linearization, distributed Riccati suffix scan, defect-sweep rollouts)
# shard over the other.  The receding-horizon bookkeeping (first-control
# broadcast, shift-and-hold warm start) adds one ppermute halo + one psum
# per simulated step — still independent of the horizon length.
# ---------------------------------------------------------------------------


def _restore_plan(system, time_axis, D_t, sweeps, N_true, X_loc, xN, U_loc):
    """Distributed feasibility restoration: defect-correction Newton sweeps
    at FIXED controls, starting from an inconsistent (shifted / re-anchored)
    state plan.  Returns a dynamically consistent (X_loc, xN) and its true
    cost — the honest `cost0` the accept-if-lower line search needs (the
    raw warm plan's cost is fictitious and can under-cut every feasible
    candidate, dead-latching the solve at LINESEARCH_FAILED).  Ragged
    horizons: padded slots are passthrough (A=I, d=0, zero cost)."""
    N_local = X_loc.shape[0]
    ragged = N_true != D_t * N_local
    valid = (_valid_stage_mask(time_axis, N_local, N_true)
             if ragged else None)
    I_x = jnp.eye(X_loc.shape[-1], dtype=X_loc.dtype)

    def sweep(_, val):
        Xc, xNc = val
        F = jax.vmap(lambda x, u: step(system, x, u))(Xc, U_loc)
        A = jax.vmap(lambda x, u: jax.jacfwd(
            lambda xx: step(system, xx, u))(x))(Xc, U_loc)
        d = F - _shift_with_halo(time_axis, D_t, Xc, xNc)
        if ragged:
            A = jnp.where(valid[:, None, None], A, I_x)
            d = jnp.where(valid[:, None], d, 0.0)
        delta0 = jnp.zeros_like(xNc)
        deltas, delta_N = _dist_affine_prefix(time_axis, D_t, A, d, delta0)
        return Xc + deltas, xNc + delta_N

    X_loc, xN = jax.lax.fori_loop(0, sweeps, sweep, (X_loc, xN))
    stage_c = jax.vmap(lambda x, u: system.stage_cost(
        system.params, x, u))(X_loc, U_loc)
    if ragged:
        stage_c = jnp.where(valid, stage_c, 0.0)
    cost = jax.lax.psum(jnp.sum(stage_c), time_axis) + system.terminal_cost(
        system.params, xN)
    return X_loc, xN, cost


def _mpc2d_body(solver_system, plant_system, config, alphas, n_sim,
                batch_axis, time_axis, D_t, N_local, H_true, x0_loc, U_blk):
    """Per-device body (runs under shard_map over (batch, time)).

    x0_loc: (B_loc, n_x) local batch of plant states (replicated over time
    shards); U_blk: (N_local, n_u) this time shard's slice of the shared
    warm start.  H_true < D_t·N_local marks a ragged horizon (trailing
    passthrough padding, `_valid_stage_mask`).
    """
    B_loc = x0_loc.shape[0]
    n_u = U_blk.shape[-1]
    ragged = H_true != D_t * N_local

    iterate = partial(_iteration, solver_system, config, alphas, time_axis,
                      D_t, N_local, H_true)
    restore = partial(_restore_plan, solver_system, time_axis, D_t,
                      config.defect_iters, H_true)
    # vmap over the local instance batch: the time-axis collectives inside
    # (_sharded_backward's all-gather, the prefix-scan gathers, the halo
    # ppermutes, the psum'd costs) batch elementwise over the unnamed vmap
    # axis — each instance still synchronizes only along `time`.
    iterate_b = jax.vmap(iterate)
    restore_b = jax.vmap(restore)

    def mpc_step(carry, _):
        x, U_loc, X_loc, xN = carry
        # Pin the warm-start plan's first node to the measured state on the
        # first time shard (receding-horizon re-anchoring), then restore
        # dynamic consistency at fixed controls.
        is_first = jax.lax.axis_index(time_axis) == 0
        X_loc = jnp.where(is_first, X_loc.at[:, 0].set(x), X_loc)
        X_loc, xN, cost0 = restore_b(X_loc, xN, U_loc)

        def inner(i, c):
            out = iterate_b(c)
            # Freeze failed instances (masked update keeps the vmapped lanes
            # independent despite the shared fori_loop trip count).
            running = c[6] == RUNNING
            return jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    running.reshape((B_loc,) + (1,) * (new.ndim - 1)),
                    new, old),
                out, c)

        init = (X_loc, xN, U_loc, cost0,
                jnp.full((B_loc,), jnp.inf, x.dtype),
                jnp.zeros((B_loc,), jnp.int32),
                jnp.full((B_loc,), RUNNING, jnp.int32))
        X_s, xN_s, U_s, cost_s, _, _, _ = jax.lax.fori_loop(
            0, config.maxiter, inner, init)

        # First control of the global plan: shard 0's first local row.
        u0 = jax.lax.psum(
            jnp.where(is_first, U_s[:, 0, :], jnp.zeros((B_loc, n_u))),
            time_axis)
        c_applied = jax.vmap(lambda xx, uu: plant_system.stage_cost(
            plant_system.params, xx, uu))(x, u0)
        x_next = jax.vmap(lambda xx, uu: step(plant_system, xx, uu))(x, u0)

        # Shift-and-hold warm start across shard boundaries: the halo is the
        # right neighbor's first row; the last REAL row holds.  On a ragged
        # horizon the last real row (global index H_true-1) can live mid-
        # shard, so every position >= H_true-1 takes the hold value and the
        # padded slots keep tracking x_N.
        gk = (jax.lax.axis_index(time_axis) * N_local
              + jnp.arange(N_local)) if ragged else None

        def shift(A_loc, hold_last):
            halo = jax.lax.ppermute(
                A_loc[:, 0], time_axis, [(i, (i - 1) % D_t) for i in range(D_t)])
            is_last = jax.lax.axis_index(time_axis) == D_t - 1
            halo = jnp.where(is_last, hold_last, halo)
            out = jnp.concatenate([A_loc[:, 1:], halo[:, None]], axis=1)
            if ragged:
                out = jnp.where((gk >= H_true - 1)[None, :, None],
                                hold_last[:, None, :], out)
            return out

        if ragged:
            u_hold = jax.lax.psum(
                jnp.sum(jnp.where((gk == H_true - 1)[None, :, None],
                                  U_s, 0.0), axis=1), time_axis)
        else:
            u_hold = U_s[:, -1]
        U_next = shift(U_s, u_hold)
        X_next = shift(X_s, xN_s)
        return (x_next, U_next, X_next, xN_s), (x, u0, c_applied)

    X0_plan = jnp.broadcast_to(
        x0_loc[:, None, :], (B_loc, N_local, x0_loc.shape[-1]))
    U0 = jnp.broadcast_to(U_blk[None], (B_loc,) + U_blk.shape)
    (x_N, _, _, _), (Xs, Us, cs) = jax.lax.scan(
        mpc_step, (x0_loc, U0, X0_plan, x0_loc), None, length=n_sim)
    cost = jnp.sum(cs, axis=0) + jax.vmap(
        lambda xx: plant_system.terminal_cost(plant_system.params, xx))(x_N)
    X_sim = jnp.concatenate([jnp.swapaxes(Xs, 0, 1), x_N[:, None]], axis=1)
    return X_sim, jnp.swapaxes(Us, 0, 1), cost


@f32_matmuls
def run_mpc_batched_2d(
    solver_system: System,
    plant_system: System,
    x0_batch: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
    time_axis: str = "time",
):
    """Batched closed-loop MPC over a 2-D (batch × time) mesh.

    x0_batch: (B, n_x); U_init: (H, n_u) shared warm start.  Neither B nor H
    needs to divide its mesh axis: uneven batches are padded by replicating
    the last instance (trimmed from the outputs), ragged horizons run via
    exact passthrough padding (`_valid_stage_mask`).  Returns
    (X (B, n_sim+1, n_x), U (B, n_sim, n_u), cost (B,)) — batch-sharded,
    time-replicated.

    Inner solves warm-start BOTH the control and state plans (shifted, like
    `mpc.run_mpc_ms`) and use the fully-distributed iteration of
    `solve_horizon_sharded` — fixed `config.maxiter` iterations per step
    with per-instance freeze-on-failure masking.
    """
    D_b = mesh.shape[batch_axis]
    D_t = mesh.shape[time_axis]
    B = x0_batch.shape[0]
    H = U_init.shape[0]
    pad_b = (-B) % D_b
    pad_t = (-H) % D_t
    if pad_b:
        x0_batch = jnp.concatenate(
            [x0_batch, jnp.broadcast_to(x0_batch[-1:],
                                        (pad_b,) + x0_batch.shape[1:])])
    if pad_t:
        U_init = jnp.concatenate(
            [U_init, jnp.zeros((pad_t,) + U_init.shape[1:], U_init.dtype)])
    alphas = tuple(config.alpha_schedule())

    fn = jax.shard_map(
        partial(_mpc2d_body, solver_system, plant_system, config, alphas,
                n_sim, batch_axis, time_axis, D_t, (H + pad_t) // D_t, H),
        mesh=mesh,
        in_specs=(P(batch_axis), P(time_axis)),
        out_specs=(P(batch_axis), P(batch_axis), P(batch_axis)),
        check_vma=False,
    )
    out = fn(x0_batch, U_init)
    if pad_b:
        out = jax.tree_util.tree_map(lambda a: a[:B], out)
    return out
