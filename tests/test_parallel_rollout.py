"""Defect-correction (parallel-in-time) rollouts and the fully
horizon-sharded solve."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.parallel_rollout import (
    affine_prefix_scan,
    defect_rollout,
    linesearch_defect_rollouts,
)
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.ops.rollout import closed_loop_rollout

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'


def _linesearch_setting(N=400):
    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], jnp.eye(2), jnp.eye(1),
                            jnp.zeros((2, 2)), d=0.0, integrator="rk4")
    x0 = jnp.array([1.0, 0.0])
    U_old = jnp.zeros((N, 1))
    X_old, _ = it.rollout(sys_, x0, U_old)
    exp = linearize_trajectory(sys_, X_old, U_old)
    u_ff, K, _, _ = backward_pass(exp)
    return sys_, x0, X_old, U_old, u_ff, K, exp


def test_affine_prefix_scan_matches_recurrence():
    key = jax.random.PRNGKey(0)
    N, n = 50, 3
    A = 0.9 * jax.random.normal(key, (N, n, n)) * 0.3 + jnp.eye(n) * 0.8
    d = jax.random.normal(jax.random.PRNGKey(1), (N, n))
    delta0 = jnp.array([1.0, -2.0, 0.5])
    got = affine_prefix_scan(A, d, delta0)
    x = delta0
    seq = [x]
    for k in range(N):
        x = A[k] @ x + d[k]
        seq.append(x)
    np.testing.assert_allclose(got, jnp.stack(seq), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.0625])
def test_defect_rollout_matches_sequential(alpha):
    sys_, x0, X_old, U_old, u_ff, K, exp = _linesearch_setting()
    A_cl = exp.f_x + exp.f_u @ K
    Xr, Ur, cr = closed_loop_rollout(sys_, x0, alpha, X_old, U_old, u_ff, K)
    Xp, Up, cp, defect = defect_rollout(sys_, x0, alpha, X_old, U_old, u_ff, K,
                                        A_cl, iters=8)
    assert float(defect) < 1e-4
    np.testing.assert_allclose(Xp, Xr, atol=1e-3)
    np.testing.assert_allclose(float(cp), float(cr), rtol=1e-4)


def test_linesearch_defect_rollouts_batch():
    sys_, x0, X_old, U_old, u_ff, K, exp = _linesearch_setting(N=200)
    alphas = jnp.asarray([1.0, 0.5, 0.25])
    Xs, Us, cs, ds = linesearch_defect_rollouts(
        sys_, x0, alphas, X_old, U_old, u_ff, K, exp
    )
    assert Xs.shape == (3, 201, 2)
    assert bool(jnp.all(ds < 1e-3))


def test_solver_defect_mode_matches_scan_mode():
    sys_, x0, X_old, U0, _, _, _ = _linesearch_setting()
    cfg_s = it.IlqrConfig(maxiter=60, tol=1e-6)
    cfg_d = it.IlqrConfig(maxiter=60, tol=1e-6, rollout="defect")
    a = it.solve(sys_, x0, U0, cfg_s)
    b = it.solve(sys_, x0, U0, cfg_d)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4)
    assert int(b.status) == it.CONVERGED


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_solve_horizon_sharded_matches_unsharded():
    from ilqr_tpu.parallel.horizon_solve import solve_horizon_sharded
    from ilqr_tpu.parallel.mesh import make_mesh

    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], jnp.eye(2), jnp.eye(1),
                            jnp.zeros((2, 2)), d=0.0, integrator="rk4")
    x0, U0 = jnp.array([1.0, 0.0]), jnp.zeros((400, 1))
    cfg = it.IlqrConfig(maxiter=60, tol=1e-6, defect_iters=8)
    ref = it.solve(sys_, x0, U0, cfg)
    mesh = make_mesh({"time": 8})
    X, U, cost, k, status = jax.jit(
        lambda x, u: solve_horizon_sharded(sys_, x, u, cfg, mesh)
    )(x0, U0)
    assert int(status) == it.CONVERGED
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(X), np.asarray(ref.X), atol=1e-3)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_solve_horizon_sharded_ragged_matches_unsharded():
    """N % D != 0 runs via exact passthrough padding instead of raising
    Full 8-device mesh: collective-permute on a SUBmesh of the virtual CPU
    platform crashes XLA:CPU's rendezvous (5-vs-4-participant check
    failure) — an XLA:CPU quirk, not a framework path."""
    from ilqr_tpu.parallel.horizon_solve import solve_horizon_sharded
    from ilqr_tpu.parallel.mesh import make_mesh

    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], jnp.eye(2), jnp.eye(1),
                            jnp.zeros((2, 2)), d=0.0, integrator="rk4")
    N = 401  # 401 % 8 == 1
    x0, U0 = jnp.array([1.0, 0.0]), jnp.zeros((N, 1))
    cfg = it.IlqrConfig(maxiter=60, tol=1e-6, defect_iters=8)
    ref = it.solve(sys_, x0, U0, cfg)
    mesh = make_mesh({"time": 8})
    X, U, cost, k, status = jax.jit(
        lambda x, u: solve_horizon_sharded(sys_, x, u, cfg, mesh)
    )(x0, U0)
    assert int(status) == it.CONVERGED
    assert X.shape == (N + 1, 2) and U.shape == (N, 1)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(X), np.asarray(ref.X), atol=1e-3)


def test_solver_defect_mode_fallback_when_uncertified():
    # defect_tol = -1 certifies NOTHING: every iteration must take the exact
    # sequential fallback inside the jitted loop and reproduce scan mode
    # identically (same accepted α sequence, same trajectory).
    sys_, x0, _, U0, _, _, _ = _linesearch_setting()
    cfg_s = it.IlqrConfig(maxiter=60, tol=1e-6)
    cfg_d = it.IlqrConfig(maxiter=60, tol=1e-6, rollout="defect",
                          defect_iters=1, defect_tol=-1.0)
    a = it.solve(sys_, x0, U0, cfg_s)
    b = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_d))(x0)
    assert int(b.status) == it.CONVERGED
    # The two compiled graphs differ at 1-ulp level (candidate costs are
    # accumulated in different summation orders), so the stall iteration
    # that trips the Δcost ≤ tol test can shift by one.
    assert abs(int(b.iterations) - int(a.iterations)) <= 1
    # Identical accepted-α sequence up to (not incl.) the final stall
    # iteration: there Δcost sits at the f32 floor and 1-ulp differences
    # between the two compiled graphs (plain vs inside lax.cond) can flip
    # which α is "first improving".
    k = max(int(a.iterations) - 2, 0)
    np.testing.assert_allclose(np.asarray(b.alpha_trace)[:k],
                               np.asarray(a.alpha_trace)[:k])
    np.testing.assert_allclose(np.asarray(b.U), np.asarray(a.U), atol=1e-5)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-6)

    # Hybrid regime: one sweep only certifies small steps early on; the
    # fallback must keep the full schedule available and still converge to
    # the scan-mode optimum.
    cfg_h = it.IlqrConfig(maxiter=60, tol=1e-6, rollout="defect",
                          defect_iters=1, defect_tol=1e-4)
    c = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_h))(x0)
    assert int(c.status) == it.CONVERGED
    np.testing.assert_allclose(float(c.cost), float(a.cost), rtol=1e-4)


def test_open_loop_defect_rollout_matches_sequential():
    from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout

    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], jnp.eye(2), jnp.eye(1),
                            jnp.zeros((2, 2)), d=0.2, integrator="rk4")
    x0 = jnp.array([1.0, 0.0])
    U = 0.3 * jnp.sin(jnp.linspace(0, 12.0, 500))[:, None]
    X_ref, c_ref = it.rollout(sys_, x0, U)
    X, c, defect = jax.jit(lambda u: open_loop_defect_rollout(
        sys_, x0, u, iters=12))(U)
    assert float(defect) < 1e-4
    np.testing.assert_allclose(np.asarray(X), np.asarray(X_ref), atol=1e-3)
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-4)


def test_solver_init_rollout_defect_matches_scan():
    sys_, x0, _, U0, _, _, _ = _linesearch_setting()
    cfg_s = it.IlqrConfig(maxiter=60, tol=1e-6)
    cfg_d = it.IlqrConfig(maxiter=60, tol=1e-6, init_rollout="defect",
                          defect_iters=12)
    a = it.solve(sys_, x0, U0, cfg_s)
    b = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_d))(x0)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4)

    # Certificate fallback: with iters=0 the Newton sweeps cannot converge,
    # so the solver must take the sequential branch and still agree.
    cfg_f = it.IlqrConfig(maxiter=60, tol=1e-6, init_rollout="defect",
                          defect_iters=1, defect_tol=1e-12)
    c = jax.jit(lambda x: it.solve(sys_, x, U0, cfg_f))(x0)
    np.testing.assert_allclose(np.asarray(c.U), np.asarray(a.U), atol=5e-6)
