"""Control-limited backward pass with O(log N) depth — frozen-active-set
iteration over the parallel Riccati suffix scan.

The sequential control-limited backward (`ops.riccati.backward_pass_limited`,
Tassa et al. 2014) solves a projected-Newton boxQP at every step of a reverse
scan: O(N) depth with a heavy per-step body — the one solver path round 1
left without a parallel-in-time form (the associative value elements assume
unconstrained minimization of δu).  No reference counterpart at all (the
reference's only treatment of input limits is a commented-out log-barrier,
`/root/reference/python/class_files/pendulum_sys.py:84-85`).

The parallel form here fixes the active set instead of the recursion:

  repeat ``sweeps`` times (active-set iteration on the whole horizon):
    1. FREEZE the clamped control components at their bounds.  Substituting
       δu = δc + F δv (δc the frozen clamp deltas, F the free-component
       mask) turns the stage LQ data into an *unconstrained* problem in δv
       with an affine dynamics drift d = B δc — exactly the multiple-shooting
       defect form the Riccati elements already support
       (`parallel_riccati.make_elements(defects=…)`).
    2. One O(log N) suffix scan of the masked elements gives V(k+1) for all
       k at once (`parallel_riccati.suffix_scan`).
    3. Gains + feedforward for the free components, fully vmapped.
    4. Active-set update from the FULL problem's Q-expansion at the same V
       (Bertsekas/Tassa projected-Newton rule): clamp where the clipped
       candidate sits at a bound with the gradient pushing outward, release
       otherwise.

On a fixed point of the active-set iteration the result satisfies the same
KKT conditions as the sequential boxQP pass, so both drive the line-searched
solver to the same optimum; per-sweep cost is one parallel backward instead
of N sequential boxQPs.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion
from ilqr_tpu.ops.parallel_riccati import (
    gains_from_value,
    make_elements,
    suffix_scan,
)

# "At the bound" tolerance for the active-set update, relative to the
# delta-bound magnitudes (f32: clipping lands exactly on the bound, the
# epsilon only guards accumulated rounding).
_BOUND_EPS = 1e-6


def masked_expansion(
    exp: TrajectoryExpansion, du_c: jnp.ndarray, free: jnp.ndarray
) -> Tuple[TrajectoryExpansion, jnp.ndarray]:
    """Stage data of the δ-LQ problem with clamped components frozen.

    du_c: (N, n_u) frozen clamp deltas (zero on free components);
    free: (N, n_u) 1.0 = free, 0.0 = clamped.  Substituting
    δu = δc + F δv gives, per step:

        drift    d    = B δc                       (→ element offset b)
        l_x̃  = l_x + l_uxᵀ δc                      (x-linear cross term)
        l_ũ  = F ⊙ (l_u + l_uu δc)                 (free-component gradient)
        f_ũ  = B diag(F),  l_ũx = diag(F) l_ux
        l_ũu = diag(F) l_uu diag(F) + diag(1−F)    (identity keeps the
                                                    clamped block invertible
                                                    and fully decoupled)

    Constant terms drop (gains don't see them).  Returns (masked expansion,
    drift d: (N, n_x)).
    """
    d = (exp.f_u @ du_c[..., None])[..., 0]
    l_x = exp.l_x + (jnp.swapaxes(exp.l_ux, -1, -2) @ du_c[..., None])[..., 0]
    l_u = free * (exp.l_u + (exp.l_uu @ du_c[..., None])[..., 0])
    f_u = exp.f_u * free[:, None, :]
    l_ux = exp.l_ux * free[..., None]
    n_u = exp.l_u.shape[-1]
    eye_u = jnp.eye(n_u, dtype=exp.l_u.dtype)
    l_uu = (free[:, :, None] * exp.l_uu * free[:, None, :]
            + (1.0 - free[:, :, None]) * (1.0 - free[:, None, :]) * eye_u)
    return (
        TrajectoryExpansion(
            f_x=exp.f_x, f_u=f_u, l_x=l_x, l_u=l_u, l_xx=exp.l_xx,
            l_ux=l_ux, l_uu=l_uu, v_x=exp.v_x, v_xx=exp.v_xx),
        d,
    )


def _suffix_values(exp_m, reg, defects):
    """V_x, V_xx at k+1 for every k (defect-shifted), via one suffix scan."""
    suffix = suffix_scan(make_elements(exp_m, reg, defects=defects))
    V_x = -suffix.eta[1:]
    V_xx = suffix.J[1:]
    V_x = V_x + (V_xx @ defects[..., None])[..., 0]
    return V_x, V_xx


@f32_matmuls
def backward_pass_limited_parallel(
    exp: TrajectoryExpansion,
    U_old: jnp.ndarray,
    u_lo: jnp.ndarray,
    u_hi: jnp.ndarray,
    reg: jnp.ndarray | float = 0.0,
    sweeps: int = 12,
    hess=None,
    noise=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in replacement for `ops.riccati.backward_pass_limited` with
    O(sweeps · log N) depth.  Same contract: (u_ff, K, dV, ok), feedback rows
    of clamped controls zeroed, u_lo/u_hi broadcast against (n_u,).

    ``sweeps`` caps the active-set iteration; it exits early as soon as the
    set stops changing (near solver convergence that is 1-2 sweeps; far from
    it, heavily saturated horizons can use the full budget).

    With ``hess`` (DDP second-order dynamics terms) and/or ``noise`` (iLQG
    covariance terms — see `ops.riccati.backward_pass`), the two frozen
    fixed-point mechanisms COMPOSE in one alternating iteration: each sweep
    (1) folds the V(k+1)-coupled terms into the stage expansion at the
    CARRIED value trace (as `parallel_riccati.backward_pass_ddp_parallel`),
    (2) freezes the active set and runs the masked suffix scan, (3) updates
    the trace and the set from the folded problem's Q-expansion.  The joint
    fixed point satisfies the sequential limited-DDP/iLQG recursion's
    conditions (clamped-KKT per step at a self-consistent trace); on ddp/
    noise runs the early exit additionally requires the trace to have been
    refreshed at least twice after the last set change.
    """
    N, n_u = U_old.shape
    dtype = exp.l_u.dtype
    reg = jnp.asarray(reg, dtype=dtype)
    lo_d = jnp.broadcast_to(u_lo, (N, n_u)).astype(dtype) - U_old
    hi_d = jnp.broadcast_to(u_hi, (N, n_u)).astype(dtype) - U_old
    eps = _BOUND_EPS * (1.0 + jnp.abs(hi_d - lo_d))
    eye_u = jnp.eye(n_u, dtype=dtype)

    n_x = exp.v_x.shape[-1]
    second_order = hess is not None or noise is not None
    # Trace refreshes required after the set stabilizes (the folded terms
    # lag the trace by one sweep; 2 extra sweeps match
    # backward_pass_ddp_parallel's measured accuracy budget).
    settle = 2 if second_order else 0
    if second_order:
        # The alternating iteration splits the budget between set changes
        # and trace refreshes: with the plain cap the torque-limited DP
        # swing-up exhausted 12 sweeps mid-iteration far from convergence
        # and the solver drifted to a worse basin (57.3 vs 45.6); doubling
        # restores the sequential limited-DDP optimum from cold starts.
        sweeps = 2 * sweeps

    def fold(V_x_next, V_xx_next):
        import dataclasses as _dc

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

    def one_sweep(free, du_c, V_x, V_xx):
        e_fold = fold(V_x, V_xx) if second_order else exp
        exp_m, d = masked_expansion(e_fold, du_c, free)
        V_x, V_xx = _suffix_values(exp_m, reg, d)
        u_ff_f, K, dVs = gains_from_value(exp_m, V_x, V_xx, reg)
        dV = jnp.sum(dVs, axis=0)
        u_ff = jnp.clip(du_c + u_ff_f, lo_d, hi_d)

        # Active-set update from the FULL (folded) problem's Q-expansion at
        # the same cost-to-go: clamp where the clipped candidate is at a
        # bound with the gradient pointing outward (projected-Newton rule);
        # everything else — including previously clamped components whose
        # gradient now points inward — is released.
        fuT_Vxx = jnp.swapaxes(e_fold.f_u, -1, -2) @ V_xx
        Q_u = e_fold.l_u + (
            jnp.swapaxes(e_fold.f_u, -1, -2) @ V_x[..., None])[..., 0]
        Q_uu = e_fold.l_uu + fuT_Vxx @ e_fold.f_u + reg * eye_u
        g = Q_u + (Q_uu @ u_ff[..., None])[..., 0]
        clamp_lo = (u_ff <= lo_d + eps) & (g > 0)
        clamp_hi = (u_ff >= hi_d - eps) & (g < 0)
        free_new = 1.0 - (clamp_lo | clamp_hi).astype(dtype)
        du_c_new = (jnp.where(clamp_lo, lo_d, 0.0)
                    + jnp.where(clamp_hi, hi_d, 0.0))
        return u_ff, K, dV, free_new, du_c_new, V_x, V_xx

    def cond(c):
        k, stable, *_ = c
        return (k < sweeps) & (stable < 1 + settle)

    def body(c):
        k, stable, free, du_c, V_x, V_xx, _, _, _ = c
        u_ff, K, dV, free_new, du_c_new, V_x, V_xx = one_sweep(
            free, du_c, V_x, V_xx)
        # When the set is unchanged the gains just computed were computed
        # UNDER that set — without second-order terms that is a fixed point;
        # with them, keep sweeping until the value trace has settled too.
        changed = jnp.any(free_new != free)
        stable = jnp.where(changed, 0, stable + 1)
        return (k + 1, stable, free_new, du_c_new, V_x, V_xx, u_ff, K, dV)

    free0 = jnp.ones((N, n_u), dtype=dtype)
    du0 = jnp.zeros((N, n_u), dtype=dtype)
    V0 = jnp.zeros((N, n_x), dtype)
    Vxx0 = jnp.zeros((N, n_x, n_x), dtype)
    if second_order:
        # Seed the trace with the Gauss-Newton unconstrained values so the
        # first fold is meaningful.
        V0, Vxx0 = _suffix_values(
            exp, reg, jnp.zeros((N, n_x), dtype))
    init = (jnp.asarray(0), jnp.asarray(0), free0, du0, V0, Vxx0,
            jnp.zeros((N, n_u), dtype),
            jnp.zeros((N, n_u, n_x), dtype),
            jnp.zeros((2,), dtype))
    *_, u_ff, K, dV = jax.lax.while_loop(cond, body, init)

    # The feedforward is clipped to the delta box so the α=1 step is feasible
    # by construction; clamped-component feedback rows are exactly zero from
    # the masked Q_uu's decoupled block.
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok
