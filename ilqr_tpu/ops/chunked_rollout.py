"""Chunked (multiple-shooting) parallel-in-time closed-loop rollouts.

The defect-correction sweeps in `ops/parallel_rollout.py` linearize EVERY
step, so their contraction region is the neighborhood of the linearization
trajectory — on drift-prone systems (the 100k-step cartpole) a line-search
candidate leaves that region and the sweeps never certify (NOTES.md).  This
module trades a little depth for a much larger contraction region:

    split the horizon into C chunks of length L = N/C;
    guess the chunk boundary states s_c (from the previous trajectory);
    repeat:
      1. roll out every chunk EXACTLY (nonlinear dynamics, closed-loop
         controls) from its boundary state — a lax.scan of depth L, vmapped
         over chunks AND line-search candidates;
      2. boundary defects d_c = end_c − s_{c+1};
      3. Newton-correct the boundaries through the linearized closed-loop
         transition: δ_{c+1} = Φ_c δ_c + d_c with Φ_c = Π_{k∈chunk c} A_k —
         an O(C) affine prefix scan (`affine_prefix_scan_multi`).

Within-chunk nonlinearity is propagated exactly, so only the C−1 boundary
corrections rely on the linearization — the scheme is a Newton method on the
C-dimensional boundary system (classic parallel/multiple shooting; cf. the
condensing step of Bock & Plitt 1984 and parareal coarse propagation) instead
of the N-dimensional per-step system.  Depth per sweep is L sequential steps
(vs O(log N) for the pure defect sweeps but with N-fold vectorization and no
per-sweep O(N·n_x³) prefix-scan algebra), and the boundary defect after the
final rollout is an exact certificate of the assembled trajectory's
consistency.

The reference framework's forward pass is one strictly sequential scan
(`/root/reference/python/class_files/iLQR_class.py:231-233`); it has no
counterpart of this component.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.parallel_rollout import (
    _guarded_max_defect,
    affine_prefix_scan_multi,
)


def auto_chunk_len(N: int) -> int:
    """Chunk length balancing scan depth (L) against lane count (C = N/L).

    Depth cost per sweep ~ L·(per-step overhead); boundary-correction cost
    grows with C.  √N balances them; clamped so short horizons keep enough
    lanes to vectorize and long horizons keep compile-time bounded.
    """
    return max(16, min(512, int(round(N ** 0.5))))


def coarse_chunk_len(N: int) -> int:
    """Chunk length for the robust (phase-2) line search: ~8× the fine one.

    Larger chunks propagate more of each candidate's nonlinearity exactly,
    so the boundary Newton certifies far outside the fine-grained scheme's
    contraction region — measured on the 100k-step cartpole: the α=1
    candidate's boundary defect is 25.7 at L=316 (diverged) and 1.5e-8 at
    L=2048, with EVERY candidate in every iteration certifying at the
    coarse length.  The price is an ~8× deeper per-sweep scan, paid only
    when the first-improving candidate was rejected (phase 2).
    """
    return max(64, min(4096, 8 * auto_chunk_len(N)))


def chunk_transition_products(A: jnp.ndarray, L: int) -> jnp.ndarray:
    """Per-chunk products Φ_c = A_{cL+L-1} ··· A_{cL}.  A: (C·L, n, n) → (C, n, n)."""
    n = A.shape[-1]
    C = A.shape[0] // L
    A_c = A.reshape(C, L, n, n).transpose(1, 0, 2, 3)  # (L, C, n, n)

    def body(P, A_l):
        return A_l @ P, None

    P0 = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), (C, n, n))
    Phi, _ = jax.lax.scan(body, P0, A_c)
    return Phi


@f32_matmuls
def linesearch_chunked_rollouts(
    system: System,
    x0: jnp.ndarray,
    alphas: jnp.ndarray,
    X_old: jnp.ndarray,
    U_old: jnp.ndarray,
    u_ff: jnp.ndarray,
    K: jnp.ndarray,
    A_cl: jnp.ndarray,
    sweeps: int = 3,
    chunk_len: int = 0,
    exit_tol: float = 0.0,
    u_limits=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All α candidates via chunked multiple-shooting rollouts.

    Same contract as `ops.parallel_rollout.linesearch_defect_rollouts`:
    returns (X_cands, U_cands, costs, defects) with a leading α axis; the
    defect is the max boundary inconsistency of the assembled trajectory
    (within chunks the dynamics hold exactly).  ``A_cl`` is the linearized
    closed-loop transition f_x + f_u K (α-independent), used only for the
    boundary Newton correction.  ``sweeps`` bounds the number of boundary
    corrections (each correction re-rolls all chunks); the loop exits early
    once every candidate's defect is below ``exit_tol``.
    """
    N, n_u = U_old.shape
    n_x = x0.shape[0]
    n_alpha = alphas.shape[0]
    L = chunk_len if chunk_len > 0 else auto_chunk_len(N)
    L = min(L, N)
    C = -(-N // L)
    N_pad = C * L
    pad = N_pad - N

    # Padded steps freeze the state and contribute no cost, so the last
    # chunk's end IS x_N.  C = ceil(N/L) ⇒ (C−1)·L < N: every chunk START is
    # a real step index.
    mask = (jnp.arange(N_pad) < N)
    Xo = jnp.concatenate(
        [X_old[:-1], jnp.broadcast_to(X_old[-1], (pad, n_x))], axis=0)
    Uo = jnp.concatenate([U_old, jnp.zeros((pad, n_u), U_old.dtype)], axis=0)
    uf = jnp.concatenate([u_ff, jnp.zeros((pad, n_u), u_ff.dtype)], axis=0)
    Kp = jnp.concatenate([K, jnp.zeros((pad, n_u, n_x), K.dtype)], axis=0)

    def chunk_major(a):  # (N_pad, ...) -> (L, C, ...) per-step slices
        return a.reshape(C, L, *a.shape[1:]).transpose(
            1, 0, *range(2, a.ndim + 1))

    Xo_c, Uo_c, uf_c, K_c = map(chunk_major, (Xo, Uo, uf, Kp))
    mask_c = mask.reshape(C, L).T  # (L, C)

    A_pad = jnp.concatenate(
        [A_cl, jnp.broadcast_to(jnp.eye(n_x, dtype=A_cl.dtype),
                                (pad, n_x, n_x))], axis=0)
    Phi = chunk_transition_products(A_pad, L)  # (C, n_x, n_x)

    stage = jax.vmap(jax.vmap(
        lambda x, u: system.stage_cost(system.params, x, u)))
    dyn = jax.vmap(jax.vmap(lambda x, u: step(system, x, u)))

    def roll(s):
        """One exact rollout of all chunks from boundaries s: (A, C, n_x)."""

        def body(carry, inp):
            x, acc = carry
            xo, uo, uf_l, K_l, m = inp
            dx = x - xo[None]
            u = (uo[None] + alphas[:, None, None] * uf_l[None]
                 + jnp.einsum("cij,acj->aci", K_l, dx))
            if u_limits is not None:
                u = jnp.clip(u, u_limits[0], u_limits[1])
            acc = acc + jnp.where(m[None], stage(x, u), 0.0)
            x1 = jnp.where(m[None, :, None], dyn(x, u), x)
            return (x1, acc), (x, u)

        (e, acc), (Xs, Us) = jax.lax.scan(
            body, (s, jnp.zeros((n_alpha, C), s.dtype)),
            (Xo_c, Uo_c, uf_c, K_c, mask_c))
        costs = jnp.sum(acc, axis=1) + jax.vmap(
            lambda xN: system.terminal_cost(system.params, xN))(e[:, -1])
        defects = _guarded_max_defect(e[:, :-1] - s[:, 1:], (1, 2)) \
            if C > 1 else jnp.zeros((n_alpha,), s.dtype)
        return Xs, Us, e, costs, defects

    # Boundary guesses: the previous trajectory's states at the chunk starts.
    starts = jnp.arange(C) * L
    s0 = jnp.broadcast_to(X_old[starts], (n_alpha, C, n_x))
    s0 = s0.at[:, 0].set(x0)

    Xs, Us, e, costs, defects = roll(s0)

    def cond(c):
        k, s, Xs, Us, e, costs, defects = c
        return (k < sweeps) & (jnp.max(defects) > exit_tol)

    def body(c):
        k, s, Xs, Us, e, _, _ = c
        d = e[:, :-1] - s[:, 1:]                      # (A, C-1, n_x)
        deltas = affine_prefix_scan_multi(
            Phi[:-1], d, jnp.zeros((n_alpha, n_x), d.dtype)
        )[:, 1:]                                      # (A, C-1, n_x)
        s = jnp.concatenate([s[:, :1], s[:, 1:] + deltas], axis=1)
        Xs, Us, e, costs, defects = roll(s)
        return k + 1, s, Xs, Us, e, costs, defects

    if C > 1:
        _, s, Xs, Us, e, costs, defects = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), s0, Xs, Us, e, costs, defects))

    # Assemble: within-chunk states are exact; X[c·L] = s_c by construction.
    X_flat = Xs.transpose(1, 2, 0, 3).reshape(n_alpha, N_pad, n_x)[:, :N]
    U_flat = Us.transpose(1, 2, 0, 3).reshape(n_alpha, N_pad, n_u)[:, :N]
    X_full = jnp.concatenate([X_flat, e[:, -1][:, None]], axis=1)
    return X_full, U_flat, costs, defects


def chunked_rollout(system, x0, alpha, X_old, U_old, u_ff, K, A_cl,
                    sweeps: int = 3, chunk_len: int = 0,
                    exit_tol: float = 0.0, u_limits=None):
    """Single-candidate chunked rollout: (X, U, cost, defect)."""
    X, U, costs, defects = linesearch_chunked_rollouts(
        system, x0, jnp.asarray(alpha)[None], X_old, U_old, u_ff, K, A_cl,
        sweeps=sweeps, chunk_len=chunk_len, exit_tol=exit_tol,
        u_limits=u_limits)
    return X[0], U[0], costs[0], defects[0]
