"""Engine selection after the move to plain XLA engines.

* Every engine value that selected a removed kernel is rejected.
* 'auto' has no platform branch: the traced program is identical whatever
  `jax.default_backend()` reports.
* The multi-candidate affine scan agrees with the sequential update pass.
* vmap(solve) — which routes through the custom_vmap wrappers in
  ops/rollout.py and ops/linearize.py — agrees with per-instance solves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.parallel_rollout import (
    affine_prefix_scan_multi,
    open_loop_defect_rollout,
)
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.shooting import MsConfig, _node_defects, _update_pass_multi


def _pendulum(integrator="euler"):
    return it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.0,
                            integrator=integrator)


def _dp():
    return it.make_double_pendulum(
        0.02, [jnp.pi, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="rk4")


@pytest.mark.parametrize("make", [
    lambda: it.IlqrConfig(backward="pallas"),
    lambda: it.IlqrConfig(rollout="pallas"),
    lambda: it.IlqrConfig(rollout="pallas", u_min=-1.0, u_max=1.0),
    lambda: it.IlqrConfig(ddp=True, backward="pallas"),
    lambda: MsConfig(update_engine="pallas"),
], ids=["backward", "rollout", "rollout_limited", "ddp_backward",
        "ms_update"])
def test_removed_engine_value_raises(make):
    with pytest.raises(ValueError, match="pallas"):
        make()


@pytest.mark.parametrize("make", [
    lambda: it.IlqrConfig(defect_engine="xla"),
    lambda: open_loop_defect_rollout(_pendulum(), jnp.zeros(2),
                                     jnp.zeros((4, 1)), engine="xla"),
    lambda: affine_prefix_scan_multi(jnp.zeros((4, 2, 2)),
                                     jnp.zeros((1, 4, 2)), jnp.zeros((1, 2)),
                                     engine="xla"),
], ids=["defect_engine", "defect_rollout_engine", "affine_scan_engine"])
def test_removed_engine_option_is_gone(make):
    """Options whose only other value picked a removed kernel are gone."""
    with pytest.raises(TypeError):
        make()


def test_auto_resolves_to_sequential_engines():
    cfg = it.IlqrConfig()
    assert (cfg.backward, cfg.resolved_rollout(),
            cfg.resolved_init_rollout()) == ("auto", "scan", "scan")
    named = it.IlqrConfig(rollout="chunked", init_rollout="defect")
    assert (named.resolved_rollout(), named.resolved_init_rollout()) == (
        "chunked", "defect")


def _auto_programs():
    from ilqr_tpu.mpc import run_mpc, run_mpc_ms

    dp, pend = _dp(), _pendulum("backward_euler")
    cfg = it.IlqrConfig(maxiter=3)
    # N = 300 is above every horizon threshold 'auto' has ever used.
    progs = [
        jax.make_jaxpr(lambda x, U: it.solve(dp, x, U, cfg))(
            jnp.zeros(4), jnp.zeros((300, 2))),
        jax.make_jaxpr(lambda x, U: it.solve(
            dp, x, U, it.IlqrConfig(maxiter=3, u_min=-1.0, u_max=1.0)))(
            jnp.zeros(4), jnp.zeros((300, 2))),
        jax.make_jaxpr(lambda x, U: run_mpc(pend, pend, x, U, 3, cfg))(
            jnp.zeros(2), jnp.zeros((300, 1))),
        jax.make_jaxpr(lambda x, U: run_mpc_ms(pend, pend, x, U, 3, cfg))(
            jnp.zeros(2), jnp.zeros((300, 1))),
        jax.make_jaxpr(lambda x, U: it.solve_ms(pend, x, U, config=cfg))(
            jnp.zeros(2), jnp.zeros((300, 1))),
    ]
    return [str(p) for p in progs]


def test_auto_has_no_platform_branch(monkeypatch):
    on_cpu = _auto_programs()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert jax.default_backend() == "gpu"
    on_gpu = _auto_programs()
    for a, b in zip(on_cpu, on_gpu):
        assert a == b


def test_affine_prefix_scan_multi_matches_recursion():
    rng = np.random.default_rng(0)
    N, n, A = 37, 3, 4
    P = 0.5 * rng.standard_normal((N, n, n)).astype(np.float32)
    q = rng.standard_normal((A, N, n)).astype(np.float32)
    d0 = rng.standard_normal((A, n)).astype(np.float32)
    got = np.asarray(affine_prefix_scan_multi(P, q, d0))
    want = np.zeros((A, N + 1, n))
    want[:, 0] = d0
    for k in range(N):
        want[:, k + 1] = np.einsum("ij,aj->ai", P[k], want[:, k]) + q[:, k]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N", [1, 16, 63])
def test_ms_update_xla_matches_seq(N):
    """The associative multi-candidate update ('xla') and the vmapped
    sequential update ('seq') compute the same affine recursion."""
    sys_ = _pendulum()
    key = jax.random.PRNGKey(N)
    X = 0.3 * jax.random.normal(key, (N + 1, 2))
    U = 0.5 * jax.random.normal(jax.random.PRNGKey(N + 1), (N, 1))
    alphas = jnp.asarray(it.IlqrConfig().alpha_schedule())

    @jax.jit
    def both(X, U):
        exp = linearize_trajectory(sys_, X, U)
        d = _node_defects(sys_, X, U)
        u_ff, K, _, _ = backward_pass(exp, 0.0, defects=d)
        return (_update_pass_multi(alphas, exp, d, u_ff, K, "seq"),
                _update_pass_multi(alphas, exp, d, u_ff, K, "xla"))

    seq, xla = both(X, U)
    for a, b in zip(xla, seq):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cfg", [
    it.IlqrConfig(maxiter=15, tol=1e-7),
    it.IlqrConfig(maxiter=15, tol=1e-7, init_rollout="defect"),
], ids=["auto", "defect_init"])
def test_vmapped_solve_matches_unbatched(cfg):
    """vmap(solve) — the batched custom_vmap rules — must agree with
    per-instance solves."""
    sys_ = _dp()
    x0s = jnp.array([[0.1, 0.0, 0.0, 0.0], [0.0, 0.2, 0.0, 0.0]])
    U0 = jnp.zeros((24, 2))
    solve = lambda x: it.solve(sys_, x, U0, cfg)
    batched = jax.jit(jax.vmap(solve))(x0s)
    single_solve = jax.jit(solve)
    for i in range(2):
        single = single_solve(x0s[i])
        np.testing.assert_allclose(float(batched.cost[i]),
                                   float(single.cost), rtol=1e-5)
