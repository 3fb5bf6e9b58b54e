"""Full DDP (second-order dynamics terms) — ilqr_tpu/ops/linearize.py
`dynamics_hessians` + `backward_pass(hess=…)` + `IlqrConfig(ddp=True)`.

Oracles:
* finite differences on the pendulum's discrete step validate f_xx/f_ux/f_uu;
* an LTI system has zero dynamics Hessians → DDP must reproduce the iLQR
  result exactly;
* pendulum swing-up: DDP reaches the same optimum, in no more iterations
  than Gauss-Newton iLQR from the same start.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import dynamics_hessians

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'


def pendulum(integrator="rk4"):
    return it.make_pendulum(
        0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
        Q_f=100.0 * jnp.eye(2), d=0.1, integrator=integrator,
    )


def test_dynamics_hessians_match_analytic_pendulum():
    # Euler-integrated pendulum: f = [x1 + dt*x2, x2 + dt*(u - d*x2 -
    # (g/l) sin x1)].  The ONLY nonzero second derivative is
    # ∂²f_2/∂x1² = dt*(g/l)*sin(x1); dynamics are affine in u → f_ux = f_uu = 0.
    dt, g, l, d = 0.01, 9.81, 1.0, 0.1
    sys_ = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), g=g, l=l, d=d,
                            integrator="euler")
    x = jnp.array([0.7, -0.3])
    u = jnp.array([0.5])
    h = dynamics_hessians(sys_, jnp.stack([x, x + 1.0]), u[None])

    expected = np.zeros((2, 2, 2), dtype=np.float32)
    expected[1, 0, 0] = dt * (g / l) * np.sin(0.7)
    np.testing.assert_allclose(np.asarray(h.f_xx[0]), expected, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.f_ux[0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.f_uu[0]), 0.0, atol=1e-6)


def test_ddp_equals_ilqr_on_linear_system():
    # Double integrator: dynamics Hessians vanish, so ddp=True must agree
    # with the Gauss-Newton path bit-for-bit (same program modulo zero adds).
    A = jnp.array([[0.0, 1.0], [0.0, 0.0]])
    B = jnp.array([[0.0], [1.0]])
    sys_ = it.make_lti(A, B, dt=0.05, x_target=[1.0, 0.0],
                       Q=jnp.eye(2), R=0.1 * jnp.eye(1), Q_f=10 * jnp.eye(2))
    x0 = jnp.array([0.0, 0.0])
    U0 = jnp.zeros((40, 1))
    cfg = it.IlqrConfig(maxiter=50, tol=1e-9, backward="scan")
    sol = it.solve(sys_, x0, U0, cfg)
    sol_ddp = it.solve(sys_, x0, U0,
                       it.IlqrConfig(maxiter=50, tol=1e-9, ddp=True))
    h = dynamics_hessians(sys_, sol.X, sol.U)
    assert float(jnp.max(jnp.abs(h.f_xx))) == 0.0
    np.testing.assert_allclose(np.asarray(sol_ddp.U), np.asarray(sol.U),
                               atol=1e-6)
    assert float(sol_ddp.cost) == pytest.approx(float(sol.cost), abs=1e-6)


def test_ddp_pendulum_swingup_converges():
    sys_ = pendulum()
    x0 = jnp.zeros(2)
    U0 = jnp.zeros((200, 1))
    cfg_gn = it.IlqrConfig(maxiter=200, tol=1e-8, backward="scan")
    cfg_ddp = it.IlqrConfig(maxiter=200, tol=1e-8, ddp=True,
                            adaptive_reg=True, reg_init=1e-6)
    sol_gn = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_gn))(x0)
    sol_ddp = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_ddp))(x0)
    assert int(sol_ddp.status) == it.CONVERGED
    # Same basin → same optimum (f32 slack).
    assert float(sol_ddp.cost) == pytest.approx(float(sol_gn.cost), rel=1e-3)
    # Same terminal state as the Gauss-Newton solution.
    assert float(jnp.max(jnp.abs(sol_ddp.X[-1] - sol_gn.X[-1]))) < 0.05


def test_ddp_with_control_limits():
    sys_ = pendulum()
    x0 = jnp.zeros(2)
    U0 = jnp.zeros((200, 1))
    lim = 2.5
    sol = jax.jit(lambda x: it.solve(
        sys_, x, U0,
        it.IlqrConfig(maxiter=150, tol=1e-8, ddp=True, adaptive_reg=True,
                      reg_init=1e-6, u_min=-lim, u_max=lim),
    ))(x0)
    assert float(jnp.max(jnp.abs(sol.U))) <= lim + 1e-6
    sol_gn = it.solve(sys_, x0, U0, it.IlqrConfig(
        maxiter=150, tol=1e-8, u_min=-lim, u_max=lim))
    assert float(sol.cost) == pytest.approx(float(sol_gn.cost), rel=5e-3)


def test_ddp_config_validation():
    # ddp composes with the parallel backward (frozen-value sweeps) …
    it.IlqrConfig(ddp=True, backward="pscan")
    it.IlqrConfig(ddp=True, backward="pscan", ddp_sweeps=4)
    # … and, since round 3, also combined with hard control limits (the
    # frozen-active-set limited pass folds the second-order terms at its
    # carried value trace — tests/test_limited_parallel.py).
    it.IlqrConfig(ddp=True, backward="pscan", u_min=-1.0, u_max=1.0)
    with pytest.raises(ValueError, match="ddp_sweeps"):
        it.IlqrConfig(ddp_sweeps=0)


def test_parallel_ddp_backward_converges_to_sequential():
    """The frozen-value-trace suffix scans are a fixed-point iteration whose
    fixed point is the exact sequential DDP recursion."""
    from ilqr_tpu.ops.linearize import dynamics_hessians, linearize_trajectory
    from ilqr_tpu.ops.parallel_riccati import backward_pass_ddp_parallel
    from ilqr_tpu.ops.riccati import backward_pass
    from ilqr_tpu.ops.rollout import rollout

    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=10.0 * jnp.eye(2), d=0.1, integrator="rk4")
    x0 = jnp.array([1.0, 0.0])
    U = 0.5 * jnp.sin(jnp.linspace(0, 6, 300))[:, None]
    X, _ = rollout(sys_, x0, U)
    exp = linearize_trajectory(sys_, X, U)
    hess = dynamics_hessians(sys_, X, U)
    u1, K1, _, _ = backward_pass(exp, 0.0, hess=hess)
    u2, K2, _, ok = backward_pass_ddp_parallel(exp, 0.0, hess=hess, sweeps=8)
    assert bool(ok)
    np.testing.assert_allclose(np.array(u2), np.array(u1), atol=2e-4)
    np.testing.assert_allclose(np.array(K2), np.array(K1), atol=2e-4)
    # Few sweeps: inexact but already a close descent direction.
    u3, _, _, _ = backward_pass_ddp_parallel(exp, 0.0, hess=hess, sweeps=2)
    rel = float(jnp.max(jnp.abs(u3 - u1)) / (1.0 + jnp.max(jnp.abs(u1))))
    assert rel < 0.05


def test_solver_ddp_parallel_backward_matches_sequential():
    sys_ = pendulum()
    x0 = jnp.zeros(2)
    U0 = jnp.zeros((300, 1))
    cfg_seq = it.IlqrConfig(maxiter=150, tol=1e-8, ddp=True,
                            adaptive_reg=True, reg_init=1e-6)
    cfg_par = it.IlqrConfig(maxiter=150, tol=1e-8, ddp=True,
                            adaptive_reg=True, reg_init=1e-6,
                            backward="pscan", ddp_sweeps=4)
    a = it.solve(sys_, x0, U0, cfg_seq)
    b = it.solve(sys_, x0, U0, cfg_par)
    assert int(b.status) == 1
    assert float(b.cost) == pytest.approx(float(a.cost), rel=1e-4)
