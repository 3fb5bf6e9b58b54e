"""3-D quadrotor (n_x=12, n_u=4): model sanity, solver convergence, and the
big-system (n_x > 8) fast-path coverage that round 2 lacked (VERDICT r2
item 2 — every fast path was hard-gated at n_x ≤ 8 and nothing detected it).

Reference analogue: the reference tops out at n_x=4
(`double_pendulum_sys.py`); these tests exercise the same solver surface at
real-robot dimensions.
"""
import jax
import jax.numpy as jnp
import pytest

import ilqr_tpu as it
from ilqr_tpu.models.quadrotor3d import (
    default_weights,
    f_cont,
    hover_controls,
    make_quadrotor3d,
)
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu.ops.riccati import backward_pass

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'


def _sys(dt=0.02, target=(1.0, 1.0, 1.0)):
    Q, R, Q_f = default_weights()
    return make_quadrotor3d(dt, list(target) + [0.0] * 9, Q, R, Q_f)


def test_hover_is_equilibrium():
    sys_ = _sys()
    x_h = jnp.zeros(12)
    u_h = hover_controls(sys_.params)
    assert float(jnp.max(jnp.abs(f_cont(sys_.params, x_h, u_h)))) < 1e-6


def test_rotor_mixing_signs():
    """Differential thrust maps to the documented torque axes."""
    sys_ = _sys()
    u_h = hover_controls(sys_.params)
    x = jnp.zeros(12)
    # +F2/−F4 → positive roll rate derivative (ω̇x > 0)
    du = jnp.array([0.0, 0.1, 0.0, -0.1])
    assert float(f_cont(sys_.params, x, u_h + du)[9]) > 0
    # +F3/−F1 → positive pitch accel (ω̇y > 0)
    du = jnp.array([-0.1, 0.0, 0.1, 0.0])
    assert float(f_cont(sys_.params, x, u_h + du)[10]) > 0
    # +F1/+F3 −F2/−F4 → positive yaw accel (ω̇z > 0)
    du = jnp.array([0.1, -0.1, 0.1, -0.1])
    assert float(f_cont(sys_.params, x, u_h + du)[11]) > 0
    # extra collective thrust at level attitude → +z accel only
    dz = f_cont(sys_.params, x, u_h * 1.2) - f_cont(sys_.params, x, u_h)
    assert float(dz[8]) > 0
    assert float(jnp.max(jnp.abs(dz.at[8].set(0.0)))) < 1e-6


def test_open_loop_repositioning_converges():
    sys_ = _sys()
    u_h = hover_controls(sys_.params)
    sol = it.solve(sys_, jnp.zeros(12), jnp.broadcast_to(u_h, (150, 4)),
                   it.IlqrConfig(maxiter=100, tol=1e-6))
    assert int(sol.status) == 1
    assert float(jnp.max(jnp.abs(sol.X[-1, :3] - 1.0))) < 5e-3
    # velocities and rates settle
    assert float(jnp.max(jnp.abs(sol.X[-1, 6:]))) < 0.1


def test_pscan_backward_matches_scan_nx12():
    """The dimension-generic associative backward ('pscan' for
    n_x > 12) agrees with the sequential recursion at n_x=12."""
    sys_ = _sys()
    N = 200
    U = jnp.broadcast_to(hover_controls(sys_.params), (N, 4)) + \
        0.05 * jnp.sin(jnp.linspace(0, 8, N))[:, None]
    X, _ = it.rollout(sys_, jnp.zeros(12), U)
    exp = linearize_trajectory(sys_, X, U)
    u0, K0, _, ok0 = backward_pass(exp, 0.0)
    u1, K1, _, ok1 = backward_pass_associative(exp, 0.0)
    assert bool(ok0) and bool(ok1)
    scale = float(jnp.max(jnp.abs(u0)))
    assert float(jnp.max(jnp.abs(u1 - u0))) < 5e-3 * scale
    assert float(jnp.max(jnp.abs(K1 - K0))) < 5e-3 * max(
        1.0, float(jnp.max(jnp.abs(K0))))


def test_solve_with_pscan_backward_nx12():
    """End-to-end solve on the explicit parallel backward reaches the same
    optimum as the sequential default."""
    sys_ = _sys()
    u_h = hover_controls(sys_.params)
    U0 = jnp.broadcast_to(u_h, (120, 4))
    cfg = dict(maxiter=60, tol=1e-6)
    s_scan = it.solve(sys_, jnp.zeros(12), U0,
                      it.IlqrConfig(backward="scan", **cfg))
    s_pscan = it.solve(sys_, jnp.zeros(12), U0,
                       it.IlqrConfig(backward="pscan", **cfg))
    assert int(s_scan.status) == 1 and int(s_pscan.status) == 1
    assert abs(float(s_pscan.cost) - float(s_scan.cost)) < 1e-3 * max(
        1.0, abs(float(s_scan.cost)))


def test_x64_oracle_nx12():
    """f32 solve tracks the f64 solve (same config) on the repositioning
    problem — the n_x=12 analogue of tests/test_x64_parity.py."""
    from ilqr_tpu.utils.x64 import enable_x64_oracle

    sys_ = _sys()
    u_h = hover_controls(sys_.params)
    U0 = jnp.broadcast_to(u_h, (100, 4))
    cfg = it.IlqrConfig(maxiter=80, tol=1e-8)
    sol32 = it.solve(sys_, jnp.zeros(12), U0, cfg)

    with enable_x64_oracle():
        sys64 = _sys()
        sol64 = it.solve(sys64, jnp.zeros(12, dtype=jnp.float64),
                         jnp.broadcast_to(
                             hover_controls(sys64.params),
                             (100, 4)).astype(jnp.float64), cfg)
        cost64 = float(sol64.cost)
        X64 = jax.device_get(sol64.X)

    assert abs(float(sol32.cost) - cost64) < 1e-3 * max(1.0, abs(cost64))
    assert float(jnp.max(jnp.abs(sol32.X - X64))) < 2e-2


def test_mpc_quadrotor3d():
    """Receding-horizon repositioning: warm-started MPC drives the plant to
    the target (solver rk4 vs plant euler model mismatch)."""
    from ilqr_tpu.mpc import run_mpc

    Q, R, Q_f = default_weights()
    solver_sys = make_quadrotor3d(0.02, [0.5, 0.5, 0.5] + [0.0] * 9,
                                  Q, R, Q_f, integrator="rk4")
    plant_sys = make_quadrotor3d(0.02, [0.5, 0.5, 0.5] + [0.0] * 9,
                                 Q, R, Q_f, integrator="euler")
    u_h = hover_controls(solver_sys.params)
    res = run_mpc(solver_sys, plant_sys, jnp.zeros(12),
                  jnp.broadcast_to(u_h, (40, 4)), 80,
                  it.IlqrConfig(maxiter=5, tol=1e-5))
    assert bool(jnp.all(jnp.isfinite(res.X)))
    assert float(jnp.max(jnp.abs(res.X[-1, :3] - 0.5))) < 5e-2


def test_vmapped_batch_solves_nx12():
    sys_ = _sys()
    u_h = hover_controls(sys_.params)
    U0 = jnp.broadcast_to(u_h, (80, 4))
    x0s = jnp.zeros((4, 12)).at[:, 0].set(jnp.linspace(-0.2, 0.2, 4))
    sols = jax.vmap(lambda x: it.solve(
        sys_, x, U0, it.IlqrConfig(maxiter=40, tol=1e-5)))(x0s)
    assert bool(jnp.all(jnp.isfinite(sols.cost)))
    assert bool(jnp.all(sols.status == 1))
