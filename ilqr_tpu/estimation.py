"""State estimation: EKF / UKF filters, RTS smoother, output-feedback LQG.

Greenfield capability (no reference counterpart — the reference assumes full
state feedback everywhere, e.g. the MPC loop reads the plant state directly,
`/root/reference/python/run_iLQR_MPC.py:118-130`).  Together with
`ilqr_tpu.ilqg` this completes the classic LQG stack: solve for a nominal
trajectory + gains, then at runtime measure y = h(x) + v, filter to x̂, and
apply u = u_ref + K (x̂ − x_ref).

Model:
    x⁺ = f(x, u) + w,   w ~ N(0, Q_proc)      (process noise)
    y  = h(x) + v,      v ~ N(0, R_obs)       (measurement noise)

All operators are pure and jit/vmap-safe; the filter scans run on-device.
Covariance updates are symmetrized (EKF: Joseph form) for f32 robustness.  Three
estimators share one `EkfState` carry: the EKF (Jacobian linearization), the
UKF (unscented transform — derivative-free, exact to 3rd-order moments), and
the extended RTS smoother (offline, conditions every estimate on the FULL
measurement record).  `simulate_output_feedback` takes a pluggable
`filter_step` so LQG execution can run on either filter.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.smallmat import solve_small


class EkfState(NamedTuple):
    x_hat: jnp.ndarray  # (n_x,) state estimate
    P: jnp.ndarray      # (n_x, n_x) estimate covariance


def ekf_predict(
    system: System, s: EkfState, u: jnp.ndarray, Q_proc: jnp.ndarray
) -> EkfState:
    """Propagate the estimate through the (discrete) dynamics."""
    x_pred = step(system, s.x_hat, u)
    A = jax.jacfwd(lambda x: step(system, x, u))(s.x_hat)
    P_pred = A @ s.P @ A.T + Q_proc
    return EkfState(x_hat=x_pred, P=0.5 * (P_pred + P_pred.T))


def ekf_update(
    obs_fn: Callable, s: EkfState, y: jnp.ndarray, R_obs: jnp.ndarray
) -> EkfState:
    """Measurement update (Joseph-form covariance)."""
    H = jax.jacfwd(obs_fn)(s.x_hat)          # (n_y, n_x)
    S = H @ s.P @ H.T + R_obs                # (n_y, n_y) innovation covariance
    # K = P Hᵀ S⁻¹ via one small solve: S Kᵀ = H P.
    K = solve_small(S, H @ s.P).T            # (n_x, n_y)
    x_new = s.x_hat + K @ (y - obs_fn(s.x_hat))
    I_KH = jnp.eye(s.P.shape[0], dtype=s.P.dtype) - K @ H
    P_new = I_KH @ s.P @ I_KH.T + K @ R_obs @ K.T
    return EkfState(x_hat=x_new, P=0.5 * (P_new + P_new.T))


def ekf_step(
    system: System,
    obs_fn: Callable,
    s: EkfState,
    u: jnp.ndarray,
    y: jnp.ndarray,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
) -> EkfState:
    """One predict(u) → update(y) cycle: y is measured AFTER applying u."""
    return ekf_update(obs_fn, ekf_predict(system, s, u, Q_proc), y, R_obs)


@f32_matmuls
def run_ekf(
    system: System,
    obs_fn: Callable,
    s0: EkfState,
    U: jnp.ndarray,
    Y: jnp.ndarray,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
) -> Tuple[EkfState, jnp.ndarray, jnp.ndarray]:
    """Filter a recorded (U, Y) sequence.  U: (N, n_u); Y: (N, n_y) with Y[k]
    measured after U[k].  Returns (final state, X_hat (N, n_x), P (N, n_x²))."""

    def body(s, inp):
        u, y = inp
        s1 = ekf_step(system, obs_fn, s, u, y, Q_proc, R_obs)
        return s1, (s1.x_hat, s1.P)

    s_f, (X_hat, Ps) = jax.lax.scan(body, s0, (U, Y))
    return s_f, X_hat, Ps


@f32_matmuls
def simulate_output_feedback(
    system: System,
    obs_fn: Callable,
    X_ref: jnp.ndarray,
    U_ref: jnp.ndarray,
    K_fb: jnp.ndarray,
    s0: EkfState,
    x0_true: jnp.ndarray,
    key: jax.Array,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
    filter_step: Callable = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-loop LQG execution: control from the filter estimate.

    Per step k: u_k = U_ref_k + K_fb_k (x̂_k − X_ref_k); the TRUE plant steps
    with process noise w_k; a noisy measurement y = h(x⁺) + v_k feeds the
    filter.  `filter_step` has the `ekf_step` signature (default: EKF; pass
    `ukf_step` for the unscented filter).  Returns (X_true (N+1, n_x),
    X_hat (N+1, n_x), U (N, n_u), cost) — cost is the true incurred cost.
    """
    if filter_step is None:
        filter_step = ekf_step
    N = U_ref.shape[0]
    n_x = x0_true.shape[0]
    n_y = obs_fn(x0_true).shape[0]
    kw, kv = jax.random.split(key)
    Lw = jnp.linalg.cholesky(Q_proc + 1e-12 * jnp.eye(n_x, dtype=Q_proc.dtype))
    Lv = jnp.linalg.cholesky(R_obs + 1e-12 * jnp.eye(n_y, dtype=R_obs.dtype))
    Ws = jax.random.normal(kw, (N, n_x), X_ref.dtype) @ Lw.T
    Vs = jax.random.normal(kv, (N, n_y), X_ref.dtype) @ Lv.T

    def body(carry, inp):
        x, s, c = carry
        x_ref, u_ref, K_k, w, v = inp
        u = u_ref + K_k @ (s.x_hat - x_ref)
        c = c + system.stage_cost(system.params, x, u)
        x1 = step(system, x, u) + w
        y = obs_fn(x1) + v
        s1 = filter_step(system, obs_fn, s, u, y, Q_proc, R_obs)
        return (x1, s1, c), (x1, s1.x_hat, u)

    (x_N, _, cost), (Xs, Xh, U) = jax.lax.scan(
        body, (x0_true, s0, 0.0), (X_ref[:-1], U_ref, K_fb, Ws, Vs)
    )
    cost = cost + system.terminal_cost(system.params, x_N)
    X_true = jnp.concatenate([x0_true[None], Xs], axis=0)
    X_hat = jnp.concatenate([s0.x_hat[None], Xh], axis=0)
    return X_true, X_hat, U, cost


# ---------------------------------------------------------------------------
# Unscented Kalman filter (Wan & van der Merwe 2000 scaled sigma points).
# Derivative-free: propagates 2n+1 sigma points through the full nonlinear
# dynamics/observation instead of linearizing — exact to 3rd-order moments,
# and usable when obs_fn is non-differentiable.  Sigma propagation is one
# vmapped batch, so the (2n+1)-point cloud maps onto the device as a single
# small batched op rather than 2n+1 scalar chains.
# ---------------------------------------------------------------------------


def _sigma_points(x, P, alpha, beta, kappa):
    """Scaled sigma points + mean/cov weights.  Returns (pts (2n+1, n), Wm, Wc)."""
    n = x.shape[0]
    lam = alpha * alpha * (n + kappa) - n
    # Row-scaled Cholesky factor of (n+lam) P; jitter keeps f32 PSD.
    L = jnp.linalg.cholesky(
        (n + lam) * (P + 1e-9 * jnp.eye(n, dtype=P.dtype))
    )
    pts = jnp.concatenate([x[None], x[None] + L.T, x[None] - L.T], axis=0)
    Wm = jnp.full((2 * n + 1,), 0.5 / (n + lam), dtype=P.dtype)
    Wm = Wm.at[0].set(lam / (n + lam))
    Wc = Wm.at[0].add(1.0 - alpha * alpha + beta)
    return pts, Wm, Wc


def ukf_predict(
    system: System,
    s: EkfState,
    u: jnp.ndarray,
    Q_proc: jnp.ndarray,
    alpha: float = 1e-1,
    beta: float = 2.0,
    kappa: float = 0.0,
) -> EkfState:
    """Unscented propagation of the estimate through the dynamics."""
    pts, Wm, Wc = _sigma_points(s.x_hat, s.P, alpha, beta, kappa)
    fpts = jax.vmap(lambda p: step(system, p, u))(pts)
    x_pred = Wm @ fpts
    d = fpts - x_pred[None]
    P_pred = (Wc[:, None] * d).T @ d + Q_proc
    return EkfState(x_hat=x_pred, P=0.5 * (P_pred + P_pred.T))


def ukf_update(
    obs_fn: Callable,
    s: EkfState,
    y: jnp.ndarray,
    R_obs: jnp.ndarray,
    alpha: float = 1e-1,
    beta: float = 2.0,
    kappa: float = 0.0,
) -> EkfState:
    """Unscented measurement update."""
    n = s.x_hat.shape[0]
    pts, Wm, Wc = _sigma_points(s.x_hat, s.P, alpha, beta, kappa)
    ypts = jax.vmap(obs_fn)(pts)
    y_pred = Wm @ ypts
    dy = ypts - y_pred[None]
    dx = pts - s.x_hat[None]
    S = (Wc[:, None] * dy).T @ dy + R_obs        # innovation covariance
    C = (Wc[:, None] * dx).T @ dy                # state-obs cross covariance
    K = solve_small(S, C.T).T                    # K = C S⁻¹, (n_x, n_y)
    x_new = s.x_hat + K @ (y - y_pred)
    # P − K S Kᵀ, re-symmetrized + jittered to stay PSD under f32 roundoff.
    P_new = s.P - K @ S @ K.T
    P_new = 0.5 * (P_new + P_new.T) + 1e-10 * jnp.eye(n, dtype=s.P.dtype)
    return EkfState(x_hat=x_new, P=P_new)


def ukf_step(
    system: System,
    obs_fn: Callable,
    s: EkfState,
    u: jnp.ndarray,
    y: jnp.ndarray,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
) -> EkfState:
    """One unscented predict(u) → update(y) cycle (drop-in for `ekf_step`)."""
    return ukf_update(obs_fn, ukf_predict(system, s, u, Q_proc), y, R_obs)


@f32_matmuls
def run_ukf(
    system: System,
    obs_fn: Callable,
    s0: EkfState,
    U: jnp.ndarray,
    Y: jnp.ndarray,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
) -> Tuple[EkfState, jnp.ndarray, jnp.ndarray]:
    """Unscented filter over a recorded (U, Y) sequence (see `run_ekf`)."""

    def body(s, inp):
        u, y = inp
        s1 = ukf_step(system, obs_fn, s, u, y, Q_proc, R_obs)
        return s1, (s1.x_hat, s1.P)

    s_f, (X_hat, Ps) = jax.lax.scan(body, s0, (U, Y))
    return s_f, X_hat, Ps


# ---------------------------------------------------------------------------
# Extended Rauch–Tung–Striebel smoother: offline, conditions every x̂_k on the
# FULL measurement record y_{1:N}.  Forward EKF scan, then a reverse scan with
# the smoother gain G_k = P_k A_kᵀ P⁻_{k+1}⁻¹.  Both scans are on-device.
# ---------------------------------------------------------------------------


@f32_matmuls
def run_eks(
    system: System,
    obs_fn: Callable,
    s0: EkfState,
    U: jnp.ndarray,
    Y: jnp.ndarray,
    Q_proc: jnp.ndarray,
    R_obs: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended RTS smoother over a recorded (U, Y) sequence.

    Conventions match `run_ekf`: Y[k] is measured after applying U[k], so the
    returned X_s[k] is the smoothed estimate of x_{k+1} (same alignment as
    `run_ekf`'s X_hat).  Returns (X_s (N, n_x), P_s (N, n_x, n_x)).
    """

    def fwd(s, inp):
        u, y = inp
        sp = ekf_predict(system, s, u, Q_proc)
        A = jax.jacfwd(lambda x: step(system, x, u))(s.x_hat)
        su = ekf_update(obs_fn, sp, y, R_obs)
        return su, (su.x_hat, su.P, sp.x_hat, sp.P, A)

    s_f, (Xf, Pf, Xp, Pp, As) = jax.lax.scan(fwd, s0, (U, Y))

    def bwd(carry, inp):
        xs_next, Ps_next = carry
        xf, P, xp_next, Pp_next, A_next = inp
        # G = P A_nextᵀ Pp_next⁻¹  via  Pp_next Gᵀ = A_next P.
        G = solve_small(Pp_next, A_next @ P).T
        xs = xf + G @ (xs_next - xp_next)
        Ps = P + G @ (Ps_next - Pp_next) @ G.T
        Ps = 0.5 * (Ps + Ps.T)
        return (xs, Ps), (xs, Ps)

    # Smooth backward from the final filtered state.  inputs at index k use
    # the PREDICTION made from k into k+1 (shift by one).
    init = (Xf[-1], Pf[-1])
    inputs = (Xf[:-1], Pf[:-1], Xp[1:], Pp[1:], As[1:])
    _, (Xs_rev, Ps_rev) = jax.lax.scan(
        bwd, init, jax.tree.map(lambda a: a[::-1], inputs)
    )
    X_s = jnp.concatenate([Xs_rev[::-1], Xf[-1:]], axis=0)
    P_s = jnp.concatenate([Ps_rev[::-1], Pf[-1:]], axis=0)
    return X_s, P_s
