"""Rotor-lag 3-D quadrotor (n_x = 16): model physics, derivative surface,
the n=16 element algebra via the XLA associative scan, and a converging
solve.
"""
import jax
import jax.numpy as jnp
import numpy as np

import ilqr_tpu as it
from ilqr_tpu.models.quadrotor3d import (
    f_cont,
    hover_controls,
    make_quadrotor3d_rotor,
)
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu.ops.riccati import backward_pass
import pytest

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'


def _sys(dt=0.01):
    hov = 0.25 * 0.5 * 9.81
    target = [1.0, 0.5, 1.0] + [0.0] * 9 + [hov] * 4
    Q = jnp.diag(jnp.asarray([1.0] * 3 + [0.5] * 3 + [0.1] * 6
                             + [0.01] * 4))
    return make_quadrotor3d_rotor(dt, target, Q, 0.1 * jnp.eye(4),
                                  10.0 * Q, rotor_tau=0.05)


def test_rotor_lag_physics():
    sys_ = _sys()
    hov = hover_controls(sys_.params)
    # At hover attitude with rotors AT their commanded hover thrust, the
    # craft is in equilibrium and the lag states are stationary.
    x_eq = jnp.zeros(16).at[12:16].set(hov)
    dx = f_cont(sys_.params, x_eq[:12], hov)
    np.testing.assert_allclose(np.asarray(dx), 0.0, atol=1e-6)
    full = sys_.f_cont(sys_.params, x_eq, hov)
    np.testing.assert_allclose(np.asarray(full), 0.0, atol=1e-6)
    # Step command: rotors relax toward the command at rate 1/τ.
    u_step = 1.2 * hov
    d = sys_.f_cont(sys_.params, x_eq, u_step)
    np.testing.assert_allclose(
        np.asarray(d[12:16]),
        np.asarray((u_step - hov) / sys_.params["rotor_tau"]), rtol=1e-6)


def test_n16_associative_backward_matches_sequential():
    """The Riccati element algebra (incl. the n=16 inverse path) agrees
    with the sequential recursion at manipulator-class dimensions."""
    sys_ = _sys()
    N = 60
    hov = hover_controls(sys_.params)
    U = jnp.tile(hov, (N, 1)) * (1.0 + 0.05 * jnp.sin(
        jnp.arange(N))[:, None])
    x0 = jnp.zeros(16).at[12:16].set(hov)
    X, _ = it.rollout(sys_, x0, U)
    exp = linearize_trajectory(sys_, X, U)
    u_s, K_s, dV_s, ok_s = backward_pass(exp, 1e-6)
    u_p, K_p, dV_p, ok_p = backward_pass_associative(exp, 1e-6)
    assert bool(ok_s) and bool(ok_p)
    scale = float(jnp.max(jnp.abs(u_s))) + 1e-9
    assert float(jnp.max(jnp.abs(u_s - u_p))) / scale < 5e-3
    assert float(jnp.max(jnp.abs(K_s - K_p))) / (
        float(jnp.max(jnp.abs(K_s))) + 1e-9) < 5e-3


def test_n16_solve_converges():
    """Full solve on the n_x=16 system (CPU: 'auto' routes to the scan;
    'pscan' exercises the dimension-generic parallel path end-to-end)."""
    sys_ = _sys(dt=0.02)
    N = 80
    hov = hover_controls(sys_.params)
    x0 = jnp.zeros(16).at[12:16].set(hov)
    U0 = jnp.tile(hov, (N, 1))
    sol = it.solve(sys_, x0, U0, it.IlqrConfig(maxiter=60, tol=1e-7,
                                               adaptive_reg=True))
    assert int(sol.status) == it.CONVERGED
    assert float(jnp.linalg.norm(sol.X[-1, :3] - jnp.asarray(
        [1.0, 0.5, 1.0]))) < 0.25
    sol_p = it.solve(sys_, x0, U0, it.IlqrConfig(
        maxiter=60, tol=1e-7, adaptive_reg=True, backward="pscan"))
    assert abs(float(sol_p.cost) - float(sol.cost)) < 5e-3 * max(
        1.0, abs(float(sol.cost)))
