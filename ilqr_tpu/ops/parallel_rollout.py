"""Parallel-in-time closed-loop rollouts by defect correction.

The exact rollout x_{k+1} = f(x_k, u_k(x_k)) is a sequential recurrence —
O(N) depth, the last latency-bound stage of the solver (SURVEY.md §5
"sequence parallelism"; NOTES.md).  This module solves it iteratively with
O(log N) depth per sweep, which is also what makes a fully horizon-sharded
solve possible (no cross-device sequential chain):

    repeat `iters` times (Newton-Picard on the whole trajectory):
      1. evaluate F_k = f(x_k, u_k) for all k IN PARALLEL (vmapped);
      2. defects d_k = F_k − x_{k+1};
      3. propagate corrections through the *linearized* closed-loop dynamics
         δ_{k+1} = A_k δ_k + d_k  (A_k = f_x + f_u K from the current
         expansion) — an affine recurrence solved by `associative_scan`;
      4. X ← X + δ.

With A from the surrounding iLQR linearization the sweep is an inexact
Newton method on the sequence-space residual: quadratic-ish contraction while
the candidate stays near the linearization point (exactly the line-search
regime).  The returned max-defect diagnostic certifies the solution; callers
can fall back to the sequential rollout when it is not small.

cf. temporal parallelization of nonlinear rollouts via Gauss-Newton sweeps
(Särkkä & García-Fernández's parallel nonlinear smoothers use the same
structure).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step


def affine_prefix_scan(A: jnp.ndarray, d: jnp.ndarray, delta0: jnp.ndarray):
    """Solve δ_{k+1} = A_k δ_k + d_k for k = 0..N-1 in O(log N) depth.

    A: (N, n, n), d: (N, n), delta0: (n,).  Returns δ: (N+1, n).
    Composition of affine maps (P2, q2)∘(P1, q1) = (P2 P1, P2 q1 + q2) is
    associative; the prefix products give δ_{k+1} = P_k δ_0 + q_k.
    """

    def combine(e1, e2):
        P1, q1 = e1
        P2, q2 = e2
        return P2 @ P1, (P2 @ q1[..., None])[..., 0] + q2

    P, q = jax.lax.associative_scan(combine, (A, d), axis=0)
    deltas = (P @ delta0[None, :, None])[..., 0] + q
    return jnp.concatenate([delta0[None], deltas], axis=0)


def _combine_multi(e1, e2):
    """Affine-map composition with a candidate axis on q at position -2."""
    P1, q1 = e1
    P2, q2 = e2
    return P2 @ P1, jnp.einsum("...ij,...aj->...ai", P2, q1) + q2


@f32_matmuls
def affine_prefix_scan_multi(P: jnp.ndarray, q: jnp.ndarray,
                             delta0: jnp.ndarray) -> jnp.ndarray:
    """Solve δ_{k+1} = P_k δ_k + q_k^{(a)} for all candidates a at once.

    P: (N, n, n) transition chain shared by every candidate; q: (A, N, n)
    per-candidate drives; delta0: (A, n).  Returns δ: (A, N+1, n) with
    δ[:, 0] = δ0.  One associative scan carries the single P-chain beside
    all A drives, so a combine costs n³ + A·n² multiplies instead of the
    A·(n³ + n²) of A separate `affine_prefix_scan` calls.
    """
    q_t = jnp.moveaxis(q, 0, 1)                               # (N, A, n)
    Ps, qs = jax.lax.associative_scan(_combine_multi, (P, q_t), axis=0)
    deltas = (jnp.einsum("kij,aj->aki", Ps, delta0)
              + jnp.moveaxis(qs, 1, 0))                       # (A, N, n)
    return jnp.concatenate([delta0[:, None], deltas], axis=1)


def _guarded_max_defect(d: jnp.ndarray, axes) -> jnp.ndarray:
    """max |d| over ``axes`` with non-finite mapped to +inf (a NaN defect must
    read as 'not converged', not poison the early-exit comparison)."""
    m = jnp.max(jnp.abs(d), axis=axes)
    return jnp.where(jnp.isfinite(m), m, jnp.inf)


@f32_matmuls
def defect_rollout(
    system: System,
    x0: jnp.ndarray,
    alpha,
    X_old: jnp.ndarray,
    U_old: jnp.ndarray,
    u_ff: jnp.ndarray,
    K: jnp.ndarray,
    A_cl: jnp.ndarray,
    iters: int = 6,
    exit_tol: float = 0.0,
    u_limits=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-loop line-search rollout by parallel defect correction.

    Same contract as `ilqr_tpu.ops.rollout.closed_loop_rollout`, plus the
    final max-defect (‖f(x_k,u_k) − x_{k+1}‖∞ over k).  ``A_cl`` is the
    linearized closed-loop transition f_x + f_u K, (N, n_x, n_x).  Sweeps
    stop early once the defect falls below ``exit_tol`` (dynamics evaluation
    dominates the sweep cost; near convergence one or two sweeps suffice).
    """
    def controls(X):
        dx = X[:-1] - X_old[:-1]
        u = U_old + alpha * u_ff + (K @ dx[..., None])[..., 0]
        if u_limits is not None:
            # Hard control limits: clamped-dim feedback rows are zero in the
            # limited backward's K, so A_cl stays the correct sweep Jacobian
            # for the frozen active set; the clip handles newly-saturating
            # deviations and the defect certificate guards the rest.
            u = jnp.clip(u, u_limits[0], u_limits[1])
        return u

    def eval_f(X, U):
        return jax.vmap(lambda x, u: step(system, x, u))(X[:-1], U)

    U0 = controls(X_old)
    F0 = eval_f(X_old, U0)

    def cond(c):
        k, X, U, F, defect = c
        return (k < iters) & (defect > exit_tol)

    def body(c):
        k, X, U, F, _ = c
        d = F - X[1:]
        deltas = affine_prefix_scan_multi(
            A_cl, d[None], (x0 - X[0])[None])[0]
        Xn = X + deltas
        Un = controls(Xn)
        Fn = eval_f(Xn, Un)
        return k + 1, Xn, Un, Fn, _guarded_max_defect(Fn - Xn[1:], (0, 1))

    # Warm start from the nominal trajectory.
    _, X, U, F, defect = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), X_old, U0, F0, _guarded_max_defect(F0 - X_old[1:], (0, 1))))
    cost = jnp.sum(
        jax.vmap(lambda x, u: system.stage_cost(system.params, x, u))(X[:-1], U)
    ) + system.terminal_cost(system.params, X[-1])
    return X, U, cost, defect


@f32_matmuls
def open_loop_defect_rollout(
    system: System,
    x0: jnp.ndarray,
    U: jnp.ndarray,
    X_guess: jnp.ndarray | None = None,
    iters: int = 8,
    exit_tol: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Open-loop rollout by parallel-in-time Newton sweeps.

    The *initial* rollout of a solve has no surrounding linearization to
    borrow, so each sweep re-linearizes along the current iterate
    (A_k = ∂f/∂x at (x_k, u_k), vmapped — embarrassingly parallel) and solves
    the correction recurrence δ_{k+1} = A_k δ_k + d_k with the O(log N)
    affine prefix scan: a full Newton method on the sequence-space rollout
    residual (quadratic contraction near the solution; may diverge from a
    poor guess on unstable dynamics — check the returned defect and fall back
    to the sequential `ops.rollout.rollout`).

    X_guess defaults to the constant trajectory at x0.  Sweeps stop early once
    the defect falls below ``exit_tol`` (saves the vmapped Jacobian evaluation
    per spared sweep).  Returns (X: (N+1, n_x), cost, max_defect).
    """
    N = U.shape[0]
    if X_guess is None:
        X0 = jnp.broadcast_to(x0, (N + 1,) + x0.shape)
    else:
        X0 = X_guess

    f = lambda x, u: step(system, x, u)

    F0 = jax.vmap(f)(X0[:-1], U)

    def cond(c):
        k, X, F, defect = c
        return (k < iters) & (defect > exit_tol)

    def body(c):
        k, X, F, _ = c
        A = jax.vmap(lambda x, u: jax.jacfwd(f, argnums=0)(x, u))(X[:-1], U)
        d = F - X[1:]
        deltas = affine_prefix_scan_multi(
            A, d[None], (x0 - X[0])[None])[0]
        Xn = X + deltas
        Fn = jax.vmap(f)(Xn[:-1], U)
        return k + 1, Xn, Fn, _guarded_max_defect(Fn - Xn[1:], (0, 1))

    _, X, F, defect = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), X0, F0, _guarded_max_defect(F0 - X0[1:], (0, 1))))
    cost = jnp.sum(
        jax.vmap(lambda x, u: system.stage_cost(system.params, x, u))(X[:-1], U)
    ) + system.terminal_cost(system.params, X[-1])
    return X, cost, defect


@f32_matmuls
def linesearch_defect_rollouts(system, x0, alphas, X_old, U_old, u_ff, K, exp,
                               iters: int = 6, exit_tol: float = 0.0, u_limits=None):
    """All α candidates via defect-correction sweeps with a SHARED scan.

    The linearized closed-loop transition A_cl = f_x + f_u K is independent of
    α, so all candidates share one transition chain: each sweep runs a single
    multi-candidate affine prefix scan (`affine_prefix_scan_multi`) instead
    of one scan per α — one P-chain's worth of matrix products regardless of
    the schedule length.  Returns (X_cands, U_cands, costs, defects) with a
    leading α axis.
    Sweeps stop early once EVERY candidate's defect is below ``exit_tol``
    (candidates that diverge keep the loop alive to the ``iters`` cap; they
    come back uncertified either way).
    """
    A_cl = exp.f_x + exp.f_u @ K
    n_alpha = alphas.shape[0]
    X_init = jnp.broadcast_to(X_old, (n_alpha,) + X_old.shape)

    def controls(X):
        dx = X[:, :-1] - X_old[None, :-1]
        u = (U_old[None] + alphas[:, None, None] * u_ff[None]
             + jnp.einsum("kij,akj->aki", K, dx))
        if u_limits is not None:
            u = jnp.clip(u, u_limits[0], u_limits[1])
        return u

    def eval_f(X, U):
        return jax.vmap(
            jax.vmap(lambda x, u: step(system, x, u))
        )(X[:, :-1], U)

    U0 = controls(X_init)
    F0 = eval_f(X_init, U0)

    def cond(c):
        k, X, U, F, defects = c
        return (k < iters) & (jnp.max(defects) > exit_tol)

    def body(c):
        k, X, U, F, _ = c
        d = F - X[:, 1:]
        delta0 = x0[None] - X[:, 0]
        deltas = affine_prefix_scan_multi(A_cl, d, delta0)
        Xn = X + deltas
        Un = controls(Xn)
        Fn = eval_f(Xn, Un)
        return (k + 1, Xn, Un, Fn,
                _guarded_max_defect(Fn - Xn[:, 1:], (1, 2)))

    _, X, U, F, defects = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), X_init, U0, F0,
         _guarded_max_defect(F0 - X_init[:, 1:], (1, 2))))
    stage = jax.vmap(
        jax.vmap(lambda x, u: system.stage_cost(system.params, x, u))
    )(X[:, :-1], U)
    costs = jnp.sum(stage, axis=1) + jax.vmap(
        lambda xN: system.terminal_cost(system.params, xN)
    )(X[:, -1])
    return X, U, costs, defects
