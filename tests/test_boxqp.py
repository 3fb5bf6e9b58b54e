"""boxQP projected Newton vs an exhaustive active-set oracle, and the
control-limited solver end-to-end."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.ops.boxqp import boxqp, boxqp_with_gains

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'


def _oracle(H, g, lo, hi):
    """Exact boxQP minimizer by enumerating all 3^n activity patterns."""
    H, g, lo, hi = map(np.asarray, (H, g, lo, hi))
    n = g.shape[0]
    best, best_val = None, np.inf
    for pattern in itertools.product((-1, 0, 1), repeat=n):
        clamped = [i for i, p in enumerate(pattern) if p != 0]
        free = [i for i, p in enumerate(pattern) if p == 0]
        d = np.zeros(n)
        d[clamped] = [lo[i] if pattern[i] < 0 else hi[i] for i in clamped]
        if free:
            rhs = -g[free]
            if clamped:
                rhs = rhs - H[np.ix_(free, clamped)] @ d[clamped]
            d[free] = np.linalg.solve(H[np.ix_(free, free)], rhs)
        if np.any(d < lo - 1e-9) or np.any(d > hi + 1e-9):
            continue
        val = 0.5 * d @ H @ d + g @ d
        if val < best_val - 1e-12:
            best, best_val = d, val
    return best, best_val


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (2, 2), (3, 3), (4, 4)])
def test_boxqp_matches_enumeration_oracle(n, seed):
    key = jax.random.split(jax.random.PRNGKey(seed), 2)
    M = jax.random.normal(key[0], (n, n))
    H = M @ M.T + n * jnp.eye(n)
    g = 3.0 * jax.random.normal(key[1], (n,))
    lo, hi = -0.5 * jnp.ones(n), 0.8 * jnp.ones(n)
    d, free = boxqp(H, g, lo, hi)
    d_ref, val_ref = _oracle(H, g, lo, hi)
    val = 0.5 * float(d @ H @ d) + float(g @ d)
    assert val <= val_ref + 1e-6
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-5)


def test_boxqp_unconstrained_interior():
    H = jnp.array([[2.0, 0.3], [0.3, 1.0]])
    g = jnp.array([0.1, -0.2])
    d, free = boxqp(H, g, -10 * jnp.ones(2), 10 * jnp.ones(2))
    np.testing.assert_allclose(np.asarray(d),
                               -np.linalg.solve(H, g), atol=1e-6)
    assert np.all(np.asarray(free) == 1.0)


def test_boxqp_gains_zero_on_clamped_rows():
    H = jnp.array([[1.0, 0.0], [0.0, 1.0]])
    g = jnp.array([-5.0, 0.0])          # pushes d0 to the hi bound
    rhs = jnp.ones((2, 3))
    d, free, K = boxqp_with_gains(H, g, -jnp.ones(2), jnp.ones(2), rhs)
    assert float(d[0]) == pytest.approx(1.0)
    np.testing.assert_allclose(np.asarray(K[0]), 0.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(K[1]), -1.0, atol=1e-6)


def _pendulum(d=0.0):
    return it.make_pendulum(0.01, [jnp.pi, 0.0], jnp.eye(2), jnp.eye(1),
                            jnp.diag(jnp.array([100.0, 10.0])), d=d,
                            integrator="rk4")


def test_limited_solve_respects_bounds_and_converges():
    sys_ = _pendulum()
    x0, U0 = jnp.array([0.0, 0.0]), jnp.zeros((300, 1))
    lim = 2.5
    cfg = it.IlqrConfig(maxiter=300, tol=1e-7, u_min=-lim, u_max=lim)
    sol = it.solve(sys_, x0, U0, cfg)
    assert float(jnp.max(jnp.abs(sol.U))) <= lim + 1e-6
    # The constraint must actually bind for this torque-hungry swing-up.
    assert float(jnp.max(jnp.abs(sol.U))) >= lim - 1e-3
    unc = it.solve(sys_, x0, U0, it.IlqrConfig(maxiter=300, tol=1e-7))
    assert float(sol.cost) >= float(unc.cost) - 1e-6


def test_loose_limits_match_unconstrained():
    sys_ = _pendulum()
    x0, U0 = jnp.array([1.0, 0.0]), jnp.zeros((200, 1))
    cfg_l = it.IlqrConfig(maxiter=100, tol=1e-6, u_min=-1e4, u_max=1e4)
    cfg_u = it.IlqrConfig(maxiter=100, tol=1e-6)
    a = it.solve(sys_, x0, U0, cfg_l)
    b = it.solve(sys_, x0, U0, cfg_u)
    np.testing.assert_allclose(float(a.cost), float(b.cost), rtol=1e-5)


def test_limits_config_validation():
    with pytest.raises(ValueError, match="together"):
        it.IlqrConfig(u_min=-1.0)
    # limits now compose with the parallel backward (frozen-active-set
    # hybrid, ops/limited_parallel.py) — pscan is accepted.
    it.IlqrConfig(u_min=-1.0, u_max=1.0, backward="pscan")
    # ...and with the clamped defect-correction rollouts (the defect
    # controls() map clips and the limited backward zeroes clamped K rows).
    it.IlqrConfig(u_min=-1.0, u_max=1.0, rollout="defect")
    # The removed pallas rollout engine is rejected with or without limits.
    with pytest.raises(ValueError, match="pallas"):
        it.IlqrConfig(u_min=-1.0, u_max=1.0, rollout="pallas")
