"""float64 oracle gates (VERDICT r1 item 10).

The framework runs f32 on the accelerator; `utils.x64.enable_x64_oracle` re-runs the
same algorithms at double precision so f32 claims (constrained-solver
violation floors, solve optima) are checked against a sharp oracle instead
of against themselves.  Reference analogue: the MATLAB/CasADi-IPOPT f64
cross-checks (`/root/reference/matlab/nonlinear_iLQR.m:54-103`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.utils.x64 import enable_x64_oracle, is_x64_enabled


pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'

def _pendulum(dtype):
    return it.make_pendulum(
        0.01, jnp.asarray([jnp.pi, 0.0], dtype), Q=jnp.eye(2, dtype=dtype),
        R=0.1 * jnp.eye(1, dtype=dtype), Q_f=100 * jnp.eye(2, dtype=dtype),
        d=0.0, integrator="rk4")


def test_unconstrained_solve_matches_f64_oracle():
    cfg = it.IlqrConfig(maxiter=100, tol=1e-7)
    sol32 = it.solve(_pendulum(jnp.float32), jnp.zeros(2, jnp.float32),
                     jnp.zeros((300, 1), jnp.float32), cfg)
    with enable_x64_oracle():
        assert is_x64_enabled()
        sol64 = it.solve(_pendulum(jnp.float64), jnp.zeros(2, jnp.float64),
                         jnp.zeros((300, 1), jnp.float64), cfg)
    assert sol64.X.dtype == jnp.float64
    # The f32 optimum must sit within f32 resolution of the f64 oracle's.
    np.testing.assert_allclose(float(sol32.cost), float(sol64.cost),
                               rtol=1e-4)
    assert not is_x64_enabled()


def test_constrained_violation_floor_is_precision_limited():
    """The AL solver's documented f32 violation floor (~eps32·cost-scale,
    API.md) must be a PRECISION artifact, not an algorithm defect: the same
    algorithm under the f64 oracle must reach a much tighter violation."""
    from ilqr_tpu.constrained import (
        AlConfig,
        box_control_constraints,
        solve_constrained,
    )

    def run(dtype, ctol, tol):
        cons = box_control_constraints(-2.0, 2.0)
        # Deep inner convergence needs regularization once μ is large — the
        # unregularized inner solver stalls at ~3.6e-3 violation even in f64
        # (an algorithmic floor, not precision; measured this round).
        alc = AlConfig(max_outer=15, ctol=ctol)
        c = it.IlqrConfig(maxiter=200, tol=tol, adaptive_reg=True,
                          reg_init=1e-6)
        return solve_constrained(
            _pendulum(dtype), cons, jnp.zeros(2, dtype),
            jnp.zeros((300, 1), dtype), c, alc)

    # f32's achievable floor on this problem measures ~1.7e-3 (inner |Δcost|
    # hits eps32·cost resolution before the AL gradient is driven further).
    sol32 = run(jnp.float32, 1e-3, 1e-6)
    assert float(sol32.violation) <= 2e-3
    with enable_x64_oracle():
        sol64 = run(jnp.float64, 1e-7, 1e-12)
    # f64 reaches a violation floor orders of magnitude below f32's ctol —
    # the f32 floor is precision-limited, and the optima agree (both also
    # match the boxQP control-limited solve's 182.709, an independent
    # algorithm on the same problem — tests/test_limited_parallel.py).
    assert float(sol64.violation) <= 1e-7
    np.testing.assert_allclose(float(sol32.cost), float(sol64.cost),
                               rtol=1e-3)


def test_parallel_riccati_matches_f64_oracle():
    """f32 association-order sensitivity of the associative backward pass
    (NOTES.md) stays within f32 resolution of the f64 sequential oracle."""
    from ilqr_tpu.ops.linearize import linearize_trajectory
    from ilqr_tpu.ops.parallel_riccati import backward_pass_associative
    from ilqr_tpu.ops.riccati import backward_pass
    from ilqr_tpu.ops.rollout import rollout

    def expansion(dtype):
        sys_ = _pendulum(dtype)
        U = 0.3 * jnp.sin(jnp.linspace(0, 6, 512, dtype=dtype))[:, None]
        X, _ = rollout(sys_, jnp.zeros(2, dtype), U)
        return linearize_trajectory(sys_, X, U)

    uff32, _, _, _ = backward_pass_associative(expansion(jnp.float32), 0.0)
    with enable_x64_oracle():
        uff64, _, _, _ = backward_pass(expansion(jnp.float64), 0.0)
    scale = float(jnp.max(jnp.abs(uff64)))
    err = float(jnp.max(jnp.abs(uff32 - uff64.astype(jnp.float32)))) / scale
    assert err < 1e-4, err


# ---------------------------------------------------------------------------
# Double-pendulum family f64 gates (VERDICT r4 next-round #7).
#
# Measured facts (round 5, this machine): on the chaotic DP swing-up the
# REFERENCE ITSELF basin-hops with precision — its f32 run converges to
# cost 214.310 (tests/golden/double_pendulum_ol.npz), its f64 run to 42.774
# (double_pendulum_ol_f64.npz); same code, same config.  Trajectory-level
# parity against the reference is therefore ill-posed on this family.  What
# IS well-posed — and what these gates pin — is (a) OUR solver's f32
# solution against OUR f64 oracle at TRAJECTORY level (the solver is
# basin-stable across precision: cost 37.0636 vs 37.0637, X within 5e-3),
# and (b) cost dominance over the reference in BOTH its precisions.
# ---------------------------------------------------------------------------


def _dp(dtype):
    return it.make_double_pendulum(
        0.01, jnp.asarray([jnp.pi, 0, 0, 0], dtype),
        Q=jnp.diag(jnp.asarray([10.0, 10.0, 0.1, 0.1], dtype)),
        R=jnp.diag(jnp.asarray([0.1, 0.1], dtype)),
        Q_f=jnp.diag(jnp.asarray([1000.0, 1000.0, 100.0, 100.0], dtype)),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler")


def test_dp_f32_solution_matches_own_f64_oracle_trajectory_level():
    cfg = it.IlqrConfig(maxiter=200, tol=1e-6)
    s32 = it.solve(_dp(jnp.float32), jnp.zeros(4, jnp.float32),
                   jnp.zeros((500, 2), jnp.float32), cfg)
    with enable_x64_oracle():
        s64 = it.solve(_dp(jnp.float64), jnp.zeros(4, jnp.float64),
                       jnp.zeros((500, 2), jnp.float64), cfg)
    assert int(s32.status) == it.CONVERGED and int(s64.status) == it.CONVERGED
    np.testing.assert_allclose(float(s32.cost), float(s64.cost), rtol=1e-5)
    # Trajectory-level agreement (measured 5e-3 X / 6.8e-3 U max).
    np.testing.assert_allclose(np.asarray(s32.X),
                               np.asarray(s64.X, np.float32), atol=2e-2)
    np.testing.assert_allclose(np.asarray(s32.U),
                               np.asarray(s64.U, np.float32), atol=3e-2)


def test_dp_f64_cost_dominates_reference_both_precisions():
    import os

    cfg = it.IlqrConfig(maxiter=200, tol=1e-6)
    with enable_x64_oracle():
        s64 = it.solve(_dp(jnp.float64), jnp.zeros(4, jnp.float64),
                       jnp.zeros((500, 2), jnp.float64), cfg)
    golden_dir = os.path.join(os.path.dirname(__file__), "golden")
    ref32 = float(np.load(os.path.join(
        golden_dir, "double_pendulum_ol.npz"))["cost"])        # 214.310
    ref64 = float(np.load(os.path.join(
        golden_dir, "double_pendulum_ol_f64.npz"))["cost"])    # 42.774
    assert float(s64.cost) <= ref64 * 1.0 + 1e-9
    assert float(s64.cost) <= ref32 * 1.0
    # Both f64 solutions reach the upright target exactly.
    np.testing.assert_allclose(np.asarray(s64.X)[-1][:2], [np.pi, 0.0],
                               atol=1e-3)


def test_ua_dp_f32_cost_matches_own_f64_oracle():
    """UA double pendulum (N=800, maxiter=700, backward_euler): 527 chaotic
    iterations amplify rounding into ~0.3 trajectory wiggle, but the
    converged COST is precision-pinned (measured 100.1529 vs 100.1534)."""

    def ua(dtype):
        return it.make_double_pendulum(
            0.01, jnp.asarray([jnp.pi, 0, 0, 0], dtype),
            Q=jnp.diag(jnp.asarray([1.0, 1.0, 0.1, 0.1], dtype)),
            R=jnp.diag(jnp.asarray([1.0], dtype)),
            Q_f=jnp.diag(jnp.asarray([1000.0, 1000.0, 100.0, 100.0], dtype)),
            d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, underactuated=True,
            integrator="backward_euler")

    cfg = it.IlqrConfig(maxiter=700, tol=1e-5)
    s32 = it.solve(ua(jnp.float32), jnp.zeros(4, jnp.float32),
                   jnp.zeros((800, 1), jnp.float32), cfg)
    with enable_x64_oracle():
        s64 = it.solve(ua(jnp.float64), jnp.zeros(4, jnp.float64),
                       jnp.zeros((800, 1), jnp.float64), cfg)
    np.testing.assert_allclose(float(s32.cost), float(s64.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(s32.X),
                               np.asarray(s64.X, np.float32), atol=0.5)
    # Both end upright.
    np.testing.assert_allclose(np.asarray(s64.X)[-1][:2], [np.pi, 0.0],
                               atol=2e-2)
