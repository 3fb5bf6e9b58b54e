"""Parallel Riccati backward pass via `jax.lax.associative_scan`.

The reference's backward pass is a strictly sequential reverse scan over the
horizon (`/root/reference/python/class_files/iLQR_class.py:122-161`) — O(N)
depth regardless of hardware.  This module reformulates the recursion as an
associative combination of per-step value-function elements, giving O(log N)
depth and a natural unit for horizon sharding across devices
(`ilqr_tpu.parallel.horizon`).

Formulation (temporal parallelization of LQT, cf. Särkkä & García-Fernández,
IEEE TAC 2023; parallel Riccati factorizations: Nielsen & Axehill
arXiv:1407.6898, arXiv:1809.06360 — see PAPERS.md):

Each step k of the δ-LQ subproblem (dynamics δx⁺ = A δx + B δu, cost
½δx'Qδx + q'δx + ½δu'Rδu + r'δu + δu'Mδx) induces a conditional value
function of the form

    V(x, z) = ½ x'J x − η'x + ½ (z − A̅x − b)' C⁻¹ (z − A̅x − b)

represented by the 5-tuple e = (A̅, b, C, η, J).  Completing the square in δu:

    A̅ = A − B R⁻¹ M        b = −B R⁻¹ r        C = B R⁻¹ B'
    J = Q − M' R⁻¹ M        η = −(q − M' R⁻¹ r)

The terminal element is (0, 0, 0, −l_f_x, l_f_xx).  The combine of an earlier
element e_i with a later element e_j,

    L   = I + C_i J_j
    A̅_ij = A̅_j L⁻¹ A̅_i
    b_ij = A̅_j L⁻¹ (b_i + C_i η_j) + b_j
    C_ij = A̅_j L⁻¹ C_i A̅_j' + C_j
    η_ij = A̅_i' L⁻ᵀ (η_j − J_j b_i) + η_i
    J_ij = A̅_i' L⁻ᵀ J_j A̅_i + J_i

is associative, so suffix products e_k ⊗ … ⊗ e_N — whose (J, η) parts are the
cost-to-go Hessian/gradient V_xx(k), −V_x(k) — are computed for every k at
once.  Gains then follow from the standard Q-expansion, fully vmapped over
time.  With reg=0 this matches the sequential pass to floating-point
accumulation order.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion
from ilqr_tpu.ops.smallmat import inv_small, solve_small


class RiccatiElement(NamedTuple):
    A: jnp.ndarray  # (..., n_x, n_x)
    b: jnp.ndarray  # (..., n_x)
    C: jnp.ndarray  # (..., n_x, n_x)
    eta: jnp.ndarray  # (..., n_x)
    J: jnp.ndarray  # (..., n_x, n_x)


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def make_elements(exp: TrajectoryExpansion, reg, defects=None) -> RiccatiElement:
    """Build the N+1 stacked scan elements (N stage leaves + terminal).

    ``defects`` ((N, n_x) multiple-shooting gaps, `ilqr_tpu.shooting`) turn
    the local dynamics affine, δx⁺ = A δx + B δu + d — which lands exactly in
    the element's affine offset: b ← b + d.  Everything else is unchanged.
    """
    n_u = exp.l_u.shape[-1]
    eye_u = jnp.eye(n_u, dtype=exp.l_u.dtype)

    def leaf(f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, d):
        R = l_uu + reg * eye_u
        # One factorization for all three R-solves.
        rhs = jnp.concatenate([l_ux, f_u.T, l_u[:, None]], axis=1)
        sol = solve_small(R, rhs)
        Rinv_M, Rinv_Bt, Rinv_r = sol[:, : l_ux.shape[1]], sol[:, l_ux.shape[1]:-1], sol[:, -1]
        A = f_x - f_u @ Rinv_M
        b = -f_u @ Rinv_r
        if d is not None:
            b = b + d
        C = _sym(f_u @ Rinv_Bt)
        J = _sym(l_xx - l_ux.T @ Rinv_M)
        eta = -(l_x - l_ux.T @ Rinv_r)
        return RiccatiElement(A, b, C, eta, J)

    leaves = jax.vmap(
        lambda f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu: leaf(
            f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, None)
    )(exp.f_x, exp.f_u, exp.l_x, exp.l_u, exp.l_xx, exp.l_ux, exp.l_uu
      ) if defects is None else jax.vmap(leaf)(
        exp.f_x, exp.f_u, exp.l_x, exp.l_u, exp.l_xx, exp.l_ux, exp.l_uu,
        defects,
    )

    n_x = exp.v_x.shape[0]
    zero_m = jnp.zeros((1, n_x, n_x), dtype=exp.v_x.dtype)
    zero_v = jnp.zeros((1, n_x), dtype=exp.v_x.dtype)
    term = RiccatiElement(zero_m, zero_v, zero_m, -exp.v_x[None], exp.v_xx[None])
    return jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a, t], axis=0), leaves, term
    )


def combine(ei: RiccatiElement, ej: RiccatiElement) -> RiccatiElement:
    """Associative combine of an earlier element ``ei`` with a later ``ej``.

    Batched over leading axes (used by associative_scan and by the sharded
    block reduction in `ilqr_tpu.parallel.horizon`).
    """
    n_x = ei.A.shape[-1]
    I = jnp.broadcast_to(jnp.eye(n_x, dtype=ei.A.dtype), ei.A.shape)
    L = I + ei.C @ ej.J  # (…, n_x, n_x)
    # Solve against L for the A/b/C updates…
    Li = inv_small(L)
    Ai_sol = Li @ ei.A
    bC_sol = (Li @ (ei.b + (ei.C @ ej.eta[..., None])[..., 0])[..., None])[..., 0]
    C_sol = Li @ ei.C
    # …and against Lᵀ (= I + J_j C_i for symmetric C, J) for the η/J updates.
    Lti = jnp.swapaxes(Li, -1, -2)
    eta_sol = (Lti @ (ej.eta - (ej.J @ ei.b[..., None])[..., 0])[..., None])[..., 0]
    J_sol = Lti @ ej.J

    AiT = jnp.swapaxes(ei.A, -1, -2)
    AjT = jnp.swapaxes(ej.A, -1, -2)
    return RiccatiElement(
        A=ej.A @ Ai_sol,
        b=(ej.A @ bC_sol[..., None])[..., 0] + ej.b,
        C=_sym(ej.A @ C_sol @ AjT + ej.C),
        eta=(AiT @ eta_sol[..., None])[..., 0] + ei.eta,
        J=_sym(AiT @ J_sol @ ei.A + ei.J),
    )


def suffix_scan(elems: RiccatiElement) -> RiccatiElement:
    """suffix[k] = e_k ⊗ e_{k+1} ⊗ … ⊗ e_N for all k, in O(log N) depth.

    `associative_scan(fn, reverse=True)` feeds the *later* accumulation as the
    first argument, so the operands are swapped to preserve the
    non-commutative (earlier, later) order.
    """
    return jax.lax.associative_scan(
        lambda a, b: combine(b, a), elems, reverse=True, axis=0
    )


def gains_from_value(exp: TrajectoryExpansion, V_x, V_xx, reg):
    """Per-step gains from the cost-to-go at k+1 — fully parallel over time.

    Same Q-expansion/gain algebra as the sequential pass
    (`iLQR_class.py:100-110`), vmapped.
    """
    n_u = exp.l_u.shape[-1]
    eye_u = jnp.eye(n_u, dtype=exp.l_u.dtype)

    def one(f_x, f_u, l_u, l_ux, l_uu, vx, vxx):
        fuT_Vxx = f_u.T @ vxx
        Q_u = l_u + f_u.T @ vx
        Q_ux = l_ux + fuT_Vxx @ f_x
        Q_uu = l_uu + fuT_Vxx @ f_u + reg * eye_u
        rhs = jnp.concatenate([Q_ux, Q_u[:, None]], axis=1)
        sol = -solve_small(Q_uu, rhs)
        K, u_ff = sol[:, :-1], sol[:, -1]
        dV = jnp.stack([u_ff @ Q_u, 0.5 * u_ff @ (Q_uu - reg * eye_u) @ u_ff])
        return u_ff, K, dV

    return jax.vmap(one)(
        exp.f_x, exp.f_u, exp.l_u, exp.l_ux, exp.l_uu, V_x, V_xx
    )


@f32_matmuls
def backward_pass_associative(
    exp: TrajectoryExpansion, reg: jnp.ndarray | float = 0.0, defects=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in replacement for `ilqr_tpu.ops.riccati.backward_pass`.

    ``defects`` gives the GNMS multiple-shooting variant
    (`ilqr_tpu.shooting`): the gaps enter the elements' affine offsets and
    shift the gains' linear Q-terms (V_x → V_x + V_xx·d), matching the
    sequential `backward_pass(defects=…)` to fp accuracy while keeping
    O(log N) depth.
    """
    reg = jnp.asarray(reg, dtype=exp.l_u.dtype)
    elems = make_elements(exp, reg, defects=defects)
    suffix = suffix_scan(elems)
    # Cost-to-go at k+1 drives the gains at k.
    V_x = -suffix.eta[1:]
    V_xx = suffix.J[1:]
    if defects is not None:
        V_x = V_x + (V_xx @ defects[..., None])[..., 0]
    u_ff, K, dVs = gains_from_value(exp, V_x, V_xx, reg)
    dV = jnp.sum(dVs, axis=0)
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok


@f32_matmuls
def backward_pass_ddp_parallel(
    exp: TrajectoryExpansion, reg: jnp.ndarray | float = 0.0, hess=None,
    noise=None, sweeps: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full-DDP / iLQG backward pass in O(sweeps·log N) depth.

    The exact second-order recursions are sequential: the DDP terms
    ``V_x(k+1)·f_xx`` (`ops/riccati.py::backward_pass`) couple each step to
    the downstream value GRADIENT, and the iLQG noise terms couple to the
    downstream value HESSIAN — neither fits the associative element algebra
    directly.  But for a FROZEN value trace they are pure per-step cost
    modifications: folding ``V_x(k+1)·f_··`` into (l_xx, l_ux, l_uu) — and
    the noise quadratics into all five stage terms — restores LQR form, so
    one sweep is again an associative suffix scan.  Iterating

        trace⁰ = Gauss-Newton suffix scan (no second-order terms)
        traceᵐ⁺¹ = suffix scan of the expansion folded with traceᵐ

    is a fixed-point iteration on the value trace whose fixed point IS the
    exact sequential recursion; near convergence of the outer solver the
    trace barely moves between sweeps (measured u_ff agreement with the
    sequential recursion on the pendulum: 0.6% at 2 sweeps, 6e-6 at 4; the
    line search guards descent regardless — inexact gains cost iterations,
    not correctness).  The default matches ``IlqrConfig.ddp_sweeps``.

    The reference framework is Gauss-Newton-only (`iLQR_class.py:100-104`);
    this composes its missing second-order terms with the parallel-in-time
    backward that is this framework's headline.
    """
    import dataclasses as _dc

    reg = jnp.asarray(reg, dtype=exp.l_u.dtype)

    def traces(e):
        suffix = suffix_scan(make_elements(e, reg))
        return -suffix.eta[1:], suffix.J[1:]

    def fold(V_x_next, V_xx_next):
        e = exp
        if hess is not None:
            vx = V_x_next[:, :, None, None]
            e = _dc.replace(
                e,
                l_xx=e.l_xx + jnp.sum(vx * hess.f_xx, axis=1),
                l_ux=e.l_ux + jnp.sum(vx * hess.f_ux, axis=1),
                l_uu=e.l_uu + jnp.sum(vx * hess.f_uu, axis=1))
        if noise is not None:
            from ilqr_tpu.ops.riccati import _noise_q_terms

            q_x, q_u, q_xx, q_ux, q_uu = jax.vmap(_noise_q_terms)(
                V_xx_next, *noise)
            e = _dc.replace(
                e, l_x=e.l_x + q_x, l_u=e.l_u + q_u, l_xx=e.l_xx + q_xx,
                l_ux=e.l_ux + q_ux, l_uu=e.l_uu + q_uu)
        return e

    V_x, V_xx = traces(exp)  # sweep 0: Gauss-Newton value trace
    for _ in range(sweeps):
        V_x, V_xx = traces(fold(V_x, V_xx))
    # Gains from a Q-expansion that uses the SAME downstream trace for the
    # second-order folds and the value terms (the sequential recursion's
    # consistency condition; exact at the fixed point).
    u_ff, K, dVs = gains_from_value(fold(V_x, V_xx), V_x, V_xx, reg)
    dV = jnp.sum(dVs, axis=0)
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok
