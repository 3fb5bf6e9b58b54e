"""Sequential Riccati backward pass over a precomputed trajectory expansion.

Algorithmic parity with the reference backward pass
(`/root/reference/python/class_files/iLQR_class.py:79-161`): same Q-expansion,
same gain solves, scanned in reverse over time.  Differences:

* value updates use the FULL symmetric form + explicit symmetrization
  instead of the reference's simplified Todorov form (`iLQR_class.py:113-114`)
  — mathematically identical at the unconstrained minimizer, but the
  simplified form loses V_xx symmetry in f32 and the recursion compounds it
  catastrophically on stiff cascades (quadrotor: 50%-of-scale u_ff error
  vs 1e-5 relative with the full form);

* operates on the stacked `TrajectoryExpansion` (derivatives hoisted out of the
  scan — see `ilqr_tpu.ops.linearize`), so the scan body is pure small-matrix
  algebra;
* optional Levenberg-style regularization ``Q_uu + reg*I`` — the reference's
  bare LU solve (`iLQR_class.py:109-110`) goes indefinite on hard problems;
  ``reg=0`` reproduces the reference bit-for-bit;
* also returns the expected-improvement terms ``dV = (Σ u_ff'Q_u,
  Σ u_ff'Q_uu u_ff)`` used by Tassa-style line-search acceptance.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion
from ilqr_tpu.ops.smallmat import solve_small


def _noise_q_terms(V_xx, C, C_x, C_u):
    """iLQG noise contributions to the Q-expansion (Todorov & Li 2005, §II).

    With stochastic dynamics x⁺ = f(x, u) + C(x, u)·ξ, ξ ~ N(0, I), the
    expected cost-to-go adds, per noise column c_i with Jacobians ∂c_i/∂x,
    ∂c_i/∂u:  q_u = Σ_i C_u,iᵀ V_xx c_i, q_uu = Σ_i C_u,iᵀ V_xx C_u,i, etc.
    Additive noise (C_x = C_u = 0) contributes nothing — certainty
    equivalence; state/control-dependent noise yields "cautious" gains.

    Shapes: C (n_x, n_w); C_x (n_x, n_w, n_x); C_u (n_x, n_w, n_u).
    """
    n_x, n_w = C.shape
    n_u = C_u.shape[-1]
    Vc = V_xx @ C                                            # (n_x, n_w)
    Wu = (V_xx @ C_u.reshape(n_x, -1)).reshape(n_x, n_w, n_u)
    Wx = (V_xx @ C_x.reshape(n_x, -1)).reshape(n_x, n_w, n_x)
    Cu2 = C_u.reshape(n_x * n_w, n_u)
    Cx2 = C_x.reshape(n_x * n_w, n_x)
    q_u = Cu2.T @ Vc.reshape(-1)
    q_x = Cx2.T @ Vc.reshape(-1)
    q_uu = Cu2.T @ Wu.reshape(n_x * n_w, n_u)
    q_ux = Cu2.T @ Wx.reshape(n_x * n_w, n_x)
    q_xx = Cx2.T @ Wx.reshape(n_x * n_w, n_x)
    return q_x, q_u, q_xx, q_ux, q_uu


@f32_matmuls
def backward_pass(
    exp: TrajectoryExpansion, reg: jnp.ndarray | float = 0.0, hess=None,
    noise=None, defects=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the Riccati recursion.

    With ``hess`` (a `DynamicsHessians`), adds the full-DDP second-order
    dynamics terms ``V_x·f_xx / V_x·f_ux / V_x·f_uu`` to the Q-expansion
    (Jacobson & Mayne; the reference is Gauss-Newton iLQR only).  DDP is
    inherently sequential — the terms couple to the running V_x, so they have
    no associative-scan counterpart.

    With ``noise`` (a (C, C_x, C_u) triple of stacked (N, …) arrays — see
    `ilqr_tpu.ilqg`), adds the iLQG noise-covariance terms; also sequential,
    they couple to the running V_xx.

    With ``defects`` (an (N, n_x) array of multiple-shooting gap residuals
    d_k = f(x_k, u_k) − x_{k+1}, see `ilqr_tpu.shooting`), the local dynamics
    become affine, δx⁺ = f_x δx + f_u δu + d, which only shifts the linear
    Q-terms: V_x is replaced by V_x + V_xx·d in Q_x and Q_u (GNMS backward
    pass — Giftthaler et al. 2018).  ``defects=None`` (or zeros) reproduces
    the plain recursion.

    Returns:
        u_ff: (N, n_u) feedforward controls
        K:    (N, n_u, n_x) feedback gains
        dV:   (2,) expected cost-decrease coefficients (linear, quadratic in α)
        ok:   scalar bool — all Q_uu solves finite
    """
    n_u = exp.l_u.shape[-1]
    eye_u = jnp.eye(n_u, dtype=exp.l_u.dtype)
    reg = jnp.asarray(reg, dtype=exp.l_u.dtype)

    def body(carry, inp):
        V_x, V_xx = carry
        (f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu), h, nz, d = inp

        # Q-expansion (`iLQR_class.py:100-104`).  With a shooting gap d the
        # constant term of the affine dynamics folds into the linear terms.
        W = V_x if d is None else V_x + V_xx @ d
        fuT_Vxx = f_u.T @ V_xx
        Q_x = l_x + f_x.T @ W
        Q_u = l_u + f_u.T @ W
        Q_xx = l_xx + f_x.T @ V_xx @ f_x
        Q_ux = l_ux + fuT_Vxx @ f_x
        Q_uu = l_uu + fuT_Vxx @ f_u
        if h is not None:
            # V_x·f_·· as a broadcast sum over the tiny contraction dim.
            f_xx, f_ux, f_uu = h
            vx = V_x[:, None, None]
            Q_xx = Q_xx + jnp.sum(vx * f_xx, axis=0)
            Q_ux = Q_ux + jnp.sum(vx * f_ux, axis=0)
            Q_uu = Q_uu + jnp.sum(vx * f_uu, axis=0)
        if nz is not None:
            q_x, q_u, q_xx, q_ux, q_uu = _noise_q_terms(V_xx, *nz)
            Q_x, Q_u = Q_x + q_x, Q_u + q_u
            Q_xx, Q_ux, Q_uu = Q_xx + q_xx, Q_ux + q_ux, Q_uu + q_uu

        Q_uu_reg = Q_uu + reg * eye_u
        # Gains (`iLQR_class.py:109-110`); one factorization for both solves.
        rhs = jnp.concatenate([Q_ux, Q_u[:, None]], axis=1)
        sol = -solve_small(Q_uu_reg, rhs)
        K = sol[:, :-1]
        u_ff = sol[:, -1]

        # Value updates: full symmetric form + explicit symmetrization, NOT
        # the reference's simplified Todorov form (`iLQR_class.py:113-114`).
        # The two are identical in exact arithmetic at the unconstrained
        # minimizer, but the simplified form relies on the f32 cancellation
        # Q_uu K = −Q_ux and the recursion compounds the roundoff — measured
        # 0.67 RELATIVE u_ff error vs 8e-5 with the full form on the
        # quadrotor at N=100 (f64 oracle).  Written via the stationarity
        # residuals W = Q_uu K + Q_ux, w = Q_u + Q_uu u_ff
        # (K'Q_uu K + K'Q_ux = K'W), with the tiny contractions as broadcast
        # sums: @ on (n_u-contraction) shapes lowers to a slow dot_general
        # under vmap — the expanded-@ form cost 18% of batched-solve
        # throughput, this form ~2.5%, at identical f32 accuracy.
        W = jnp.sum(Q_uu[:, :, None] * K[None, :, :], axis=1) + Q_ux
        w = Q_u + jnp.sum(Q_uu * u_ff[None, :], axis=1)
        V_x_new = (Q_x + jnp.sum(K * w[:, None], axis=0)
                   + jnp.sum(Q_ux * u_ff[:, None], axis=0))
        V_xx_new = (Q_xx + jnp.sum(K[:, :, None] * W[:, None, :], axis=0)
                    + jnp.sum(Q_ux[:, :, None] * K[:, None, :], axis=0))
        V_xx_new = 0.5 * (V_xx_new + V_xx_new.T)

        dV = jnp.stack([u_ff @ Q_u, 0.5 * u_ff @ (w - Q_u)])
        return (V_x_new, V_xx_new), (u_ff, K, dV)

    init = (exp.v_x, exp.v_xx)
    xs = ((exp.f_x, exp.f_u, exp.l_x, exp.l_u, exp.l_xx, exp.l_ux, exp.l_uu),
          None if hess is None else (hess.f_xx, hess.f_ux, hess.f_uu),
          None if noise is None else tuple(noise),
          defects)
    (_, _), (u_ff, K, dVs) = jax.lax.scan(body, init, xs, reverse=True)
    dV = jnp.sum(dVs, axis=0)
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok


@f32_matmuls
def backward_pass_limited(
    exp: TrajectoryExpansion,
    U_old: jnp.ndarray,
    u_lo: jnp.ndarray,
    u_hi: jnp.ndarray,
    reg: jnp.ndarray | float = 0.0,
    qp_iters: int = 8,
    hess=None,
    noise=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Control-limited backward pass (Tassa et al. 2014, see ops/boxqp.py).

    Same contract as `backward_pass`, plus box limits lo ≤ u ≤ hi enforced at
    the gain computation: the feedforward solves a boxQP over the *delta*
    bounds [lo − u_k, hi − u_k] and feedback rows of clamped controls are
    zeroed.  No reference counterpart (the reference has no hard limits).
    """
    from ilqr_tpu.ops.boxqp import boxqp_with_gains

    n_u = exp.l_u.shape[-1]
    eye_u = jnp.eye(n_u, dtype=exp.l_u.dtype)
    reg = jnp.asarray(reg, dtype=exp.l_u.dtype)

    def body(carry, inp):
        V_x, V_xx = carry
        (f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, u_k), h, nz = inp

        fuT_Vxx = f_u.T @ V_xx
        Q_x = l_x + f_x.T @ V_x
        Q_u = l_u + f_u.T @ V_x
        Q_xx = l_xx + f_x.T @ V_xx @ f_x
        Q_ux = l_ux + fuT_Vxx @ f_x
        Q_uu = l_uu + fuT_Vxx @ f_u
        if h is not None:
            # V_x·f_·· as a broadcast sum over the tiny contraction dim.
            f_xx, f_ux, f_uu = h
            vx = V_x[:, None, None]
            Q_xx = Q_xx + jnp.sum(vx * f_xx, axis=0)
            Q_ux = Q_ux + jnp.sum(vx * f_ux, axis=0)
            Q_uu = Q_uu + jnp.sum(vx * f_uu, axis=0)
        if nz is not None:
            q_x, q_u, q_xx, q_ux, q_uu = _noise_q_terms(V_xx, *nz)
            Q_x, Q_u = Q_x + q_x, Q_u + q_u
            Q_xx, Q_ux, Q_uu = Q_xx + q_xx, Q_ux + q_ux, Q_uu + q_uu

        Q_uu_reg = Q_uu + reg * eye_u
        u_ff, free, K = boxqp_with_gains(
            Q_uu_reg, Q_u, u_lo - u_k, u_hi - u_k, Q_ux, iters=qp_iters
        )

        # Full symmetric value update (see backward_pass — same residual
        # form with broadcast-sum tiny contractions): besides the f32
        # robustness, for CLAMPED controls the simplified form is not even
        # algebraically valid — u_ff/K are not the unconstrained minimizer.
        W = jnp.sum(Q_uu[:, :, None] * K[None, :, :], axis=1) + Q_ux
        w = Q_u + jnp.sum(Q_uu * u_ff[None, :], axis=1)
        V_x_new = (Q_x + jnp.sum(K * w[:, None], axis=0)
                   + jnp.sum(Q_ux * u_ff[:, None], axis=0))
        V_xx_new = (Q_xx + jnp.sum(K[:, :, None] * W[:, None, :], axis=0)
                    + jnp.sum(Q_ux[:, :, None] * K[:, None, :], axis=0))
        V_xx_new = 0.5 * (V_xx_new + V_xx_new.T)

        dV = jnp.stack([u_ff @ Q_u, 0.5 * u_ff @ (w - Q_u)])
        return (V_x_new, V_xx_new), (u_ff, K, dV)

    init = (exp.v_x, exp.v_xx)
    xs = ((exp.f_x, exp.f_u, exp.l_x, exp.l_u, exp.l_xx, exp.l_ux, exp.l_uu,
           U_old),
          None if hess is None else (hess.f_xx, hess.f_ux, hess.f_uu),
          None if noise is None else tuple(noise))
    (_, _), (u_ff, K, dVs) = jax.lax.scan(body, init, xs, reverse=True)
    dV = jnp.sum(dVs, axis=0)
    ok = jnp.all(jnp.isfinite(u_ff)) & jnp.all(jnp.isfinite(K))
    return u_ff, K, dV, ok
