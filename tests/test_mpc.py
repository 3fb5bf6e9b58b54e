"""MPC tests: closed-loop swing-up with solver/plant mismatch (reference
workloads P9-P11) and the batched variant."""
import jax
import jax.numpy as jnp
import numpy as np

import ilqr_tpu as it
from ilqr_tpu.mpc import run_mpc, run_mpc_batched


def _pendulum_pair():
    # Reference MPC config: run_iLQR_MPC.py:16-75 (solver backward_euler,
    # plant midpoint — deliberate model mismatch).
    mk = lambda integ: it.make_pendulum(
        0.01, [jnp.pi, 0.0], Q=jnp.diag(jnp.array([10.0, 1.0])),
        R=jnp.eye(1), Q_f=jnp.diag(jnp.array([10.0, 10.0])), d=0.0,
        integrator=integ,
    )
    return mk("backward_euler"), mk("midpoint")


def test_mpc_pendulum_swingup():
    solver_sys, plant_sys = _pendulum_pair()
    N_h = 200  # T_horizon=2.0
    res = run_mpc(
        solver_sys, plant_sys, jnp.zeros(2), jnp.zeros((N_h, 1)),
        n_sim=400, config=it.IlqrConfig(maxiter=10, tol=1e-5),
    )
    xN = np.asarray(res.X[-1])
    assert abs(xN[0] - np.pi) < 0.05, f"did not swing up: {xN}"
    assert abs(xN[1]) < 0.1
    assert res.U.shape == (400, 1)
    assert np.all(np.asarray(res.solve_iters) <= 10)


def test_mpc_warm_start_reduces_iterations():
    """Warm starting should make later solves cheap (the point of the
    shift-and-hold pattern, run_iLQR_MPC.py:137)."""
    solver_sys, plant_sys = _pendulum_pair()
    res = run_mpc(
        solver_sys, plant_sys, jnp.zeros(2), jnp.zeros((200, 1)),
        n_sim=300, config=it.IlqrConfig(maxiter=10, tol=1e-5),
    )
    iters = np.asarray(res.solve_iters)
    # Tail solves (near-stationary tracking) should converge in very few
    # iterations compared to the budget.
    assert iters[-50:].mean() < 6.0


def test_mpc_batched_matches_single():
    solver_sys, plant_sys = _pendulum_pair()
    x0s = jnp.stack([jnp.zeros(2), jnp.array([0.3, 0.0])])
    res_b = run_mpc_batched(
        solver_sys, plant_sys, x0s, jnp.zeros((100, 1)), n_sim=50,
        config=it.IlqrConfig(maxiter=5),
    )
    res_1 = run_mpc(
        solver_sys, plant_sys, x0s[1], jnp.zeros((100, 1)), n_sim=50,
        config=it.IlqrConfig(maxiter=5),
    )
    assert res_b.X.shape == (2, 51, 2)
    np.testing.assert_allclose(
        np.asarray(res_b.X[1]), np.asarray(res_1.X), atol=1e-4
    )


def test_mpc_rti_swingup_and_reduces_solves():
    from ilqr_tpu.mpc import run_mpc_rti

    solver_sys, plant_sys = _pendulum_pair()
    N_h = 200
    cfg = it.IlqrConfig(maxiter=10, tol=1e-5)
    res5 = jax.jit(lambda x: run_mpc_rti(
        solver_sys, plant_sys, x, jnp.zeros((N_h, 1)), n_sim=400,
        config=cfg, resolve_every=5))(jnp.zeros(2))
    xN = np.asarray(res5.X[-1])
    assert abs(xN[0] - np.pi) < 0.05, f"did not swing up: {xN}"
    assert abs(xN[1]) < 0.1
    # 5x fewer solves: per-solve diagnostics have length n_sim/5.
    assert res5.solve_iters.shape == (80,)
    assert res5.U.shape == (400, 1)

    # resolve_every=1 stays close to the plain MPC loop's closed-loop cost
    # (not identical: RTI applies feedback from the same solve, run_mpc
    # applies the first planned control directly).
    res1 = run_mpc_rti(solver_sys, plant_sys, jnp.zeros(2),
                       jnp.zeros((N_h, 1)), 400, cfg, resolve_every=1)
    base = run_mpc(solver_sys, plant_sys, jnp.zeros(2),
                   jnp.zeros((N_h, 1)), 400, cfg)
    np.testing.assert_allclose(float(res1.cost), float(base.cost), rtol=2e-2)
    # Infrequent re-solving costs a little closed-loop performance, not much.
    assert float(res5.cost) < 2.0 * float(base.cost)


def test_mpc_rti_validates_divisibility():
    from ilqr_tpu.mpc import run_mpc_rti

    solver_sys, plant_sys = _pendulum_pair()
    try:
        run_mpc_rti(solver_sys, plant_sys, jnp.zeros(2), jnp.zeros((50, 1)),
                    n_sim=401, resolve_every=5)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "divisible" in str(e)


def test_mpc_constrained_torque_limited_swingup():
    """AL-constrained MPC with multiplier warm-starting: swings up while the
    applied torques respect the limit; the unconstrained MPC exceeds it."""
    from ilqr_tpu.constrained import AlConfig, box_control_constraints
    from ilqr_tpu.mpc import run_mpc_constrained

    solver_sys, plant_sys = _pendulum_pair()
    # lim=6 binds (unconstrained peak ~11.4) but keeps one-swing feasibility;
    # tighter limits need multi-swing pumping the local solver won't find.
    N_h, n_sim, lim = 200, 400, 6.0
    cons = box_control_constraints(jnp.array([-lim]), jnp.array([lim]))

    res_un = run_mpc(
        solver_sys, plant_sys, jnp.zeros(2), jnp.zeros((N_h, 1)),
        n_sim=n_sim, config=it.IlqrConfig(maxiter=10, tol=1e-5))
    assert float(jnp.max(jnp.abs(res_un.U))) > lim   # limit is binding

    res = run_mpc_constrained(
        solver_sys, plant_sys, cons, jnp.zeros(2), jnp.zeros((N_h, 1)),
        n_sim=n_sim, config=it.IlqrConfig(maxiter=15, tol=1e-6),
        al_config=AlConfig(max_outer=2, ctol=1e-3, mu0=1.0))
    xN = np.asarray(res.X[-1])
    assert abs(xN[0] - np.pi) < 0.05, f"did not swing up: {xN}"
    assert abs(xN[1]) < 0.1
    assert float(jnp.max(jnp.abs(res.U))) <= lim + 5e-3
    # Multiplier warm-starting across steps: the per-step plans end feasible
    # (tail of the run, after the multipliers have converged).
    assert float(jnp.max(res.violation[-100:])) <= 1e-3


def test_mpc_barrier_torque_limited_swingup():
    """Fixed-(mu, delta) relaxed-barrier MPC: constant per-step work, bounded
    torques, still swings up."""
    from ilqr_tpu.constrained import box_control_constraints
    from ilqr_tpu.mpc import run_mpc_barrier

    solver_sys, plant_sys = _pendulum_pair()
    N_h, n_sim, lim = 200, 400, 6.0
    cons = box_control_constraints(jnp.array([-lim]), jnp.array([lim]))

    res = run_mpc_barrier(
        solver_sys, plant_sys, cons, jnp.zeros(2), jnp.zeros((N_h, 1)),
        n_sim=n_sim, config=it.IlqrConfig(maxiter=10, tol=1e-6),
        mu=1e-2, delta=0.05)
    xN = np.asarray(res.X[-1])
    assert abs(xN[0] - np.pi) < 0.05, f"did not swing up: {xN}"
    assert abs(xN[1]) < 0.1
    # Relaxed barrier admits O(mu/ lim)-scale excursions; keep a loose bound.
    assert float(jnp.max(jnp.abs(res.U))) <= lim + 5e-2


def test_mpc_parallel_inner_engines_match_sequential():
    """The parallel-in-time inner chains (pscan backward + defect rollouts,
    selected by name) must reproduce the sequential engines' closed loop."""
    import ilqr_tpu as it
    from ilqr_tpu.mpc import run_mpc

    s_s = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                           Q_f=jnp.zeros((2, 2)), d=0.01,
                           integrator="backward_euler")
    s_p = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                           Q_f=jnp.zeros((2, 2)), d=0.01,
                           integrator="midpoint")
    x0 = jnp.array([1.0, 0.0])
    U0 = jnp.zeros((60, 1))
    seq = run_mpc(s_s, s_p, x0, U0, 80,
                  it.IlqrConfig(maxiter=6, tol=1e-5, rollout="scan",
                                init_rollout="scan", backward="scan"))
    par = run_mpc(s_s, s_p, x0, U0, 80,
                  it.IlqrConfig(maxiter=6, tol=1e-5, rollout="defect",
                                init_rollout="defect", backward="pscan"))
    np.testing.assert_allclose(float(par.cost), float(seq.cost), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(par.X[-1]), np.asarray(seq.X[-1]),
                               atol=1e-2)


def test_defect_latch_warm_start():
    """solve() exposes the parallel-line-search latch and accepts it back:
    a False latch forces the exact line search from iteration one (same
    optimum, no parallel-path attempts), and MPC loops thread it through
    their scan carry (run_mpc/_rti)."""
    sys_ = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.0, integrator="euler")
    x0, U0 = jnp.array([1.0, 0.0]), jnp.zeros((300, 1))
    cfg = it.IlqrConfig(maxiter=80, tol=1e-7, rollout="defect",
                        init_rollout="scan")
    s_on = it.solve(sys_, x0, U0, cfg)
    s_off = it.solve(sys_, x0, U0, cfg, defect_latch=False)
    # Healthy pendulum: the parallel path certifies throughout -> latch
    # stays up; forcing it down must not change the optimum.
    assert bool(s_on.defect_latch)
    assert not bool(s_off.defect_latch)
    assert abs(float(s_on.cost) - float(s_off.cost)) < 1e-3
    # The sequential engine reports the latch as down (no parallel path).
    s_seq = it.solve(sys_, x0, U0, it.IlqrConfig(maxiter=80, tol=1e-7,
                                                 rollout="scan"))
    assert not bool(s_seq.defect_latch)
