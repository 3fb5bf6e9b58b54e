"""Generate golden parity trajectories by RUNNING the reference implementation.

The reference has no test suite; its de-facto integration test is agreement
with an independent solver (SURVEY.md §4).  For the new framework the trusted
oracle is the reference package itself, executed on CPU from
/root/reference/python (imported, not copied).  This script records the
converged (X, U, cost, iterations) for the three open-loop BASELINE.json
configs; tests/test_parity.py asserts the framework matches within
tolerance.

Run manually:  python tests/golden/make_golden.py
"""
import os
import sys

sys.path.insert(0, "/root/reference/python")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from class_files.iLQR_class import iLQR
from class_files.systems.pendulum_sys import MyPendulum
from class_files.systems.double_pendulum_sys import MyDoublePendulum
from class_files.systems.UA_double_pendulum_sys import MyUADoublePendulum

OUT = os.path.dirname(os.path.abspath(__file__))


def save(name, solver, X, U, cost):
    np.savez(
        os.path.join(OUT, name),
        X=np.asarray(X),
        U=np.asarray(U),
        cost=np.asarray(cost),
    )
    print(f"{name}: cost={float(cost):.6f} X_final={np.asarray(X)[:, -1]}")


def pendulum_ol():
    # Config of /root/reference/python/run_iLQR_open_loop.py:16-68
    dt, T = 0.01, 4.0
    N = len(jnp.arange(0, T + dt, dt)) - 1
    sys_ = MyPendulum(
        dt=dt, x_target=jnp.array([jnp.pi, 0.0]),
        Q=jnp.eye(2), R=jnp.eye(1), Q_f=jnp.zeros((2, 2)),
        g=9.81, l=1.0, d=0.0, integrator="backward_euler", use_jit=True,
    )
    solver = iLQR(sys_, T, jnp.array([1.0, 0.0]), jnp.zeros((1, N)),
                  tol=1e-5, maxiter=100, verbose=False)
    X, U, cost = solver.optimize_trajectory()
    save("pendulum_ol.npz", solver, X, U, cost)


def double_pendulum_ol():
    # Config of run_double_pendulum_open_loop.py:14-75
    dt, T = 0.01, 5.0
    N = len(jnp.arange(0, T + dt, dt)) - 1
    sys_ = MyDoublePendulum(
        dt=dt, x_target=jnp.array([jnp.pi, 0.0, 0.0, 0.0]),
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([0.1, 0.1])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        g=9.81, m1=1.0, m2=1.0, l1=1.0, l2=1.0, d1=0.1, d2=0.1,
        theta1=1.0 / 12.0, theta2=1.0 / 12.0,
        integrator="euler", use_jit=True,
    )
    solver = iLQR(sys_, T, jnp.zeros(4), jnp.zeros((2, N)),
                  tol=1e-6, maxiter=200, verbose=False)
    X, U, cost = solver.optimize_trajectory()
    save("double_pendulum_ol.npz", solver, X, U, cost)


def ua_double_pendulum_ol():
    # Config of run_iLQR_OL_UA_Pendulum.py:14-75
    dt, T = 0.01, 8.0
    N = len(jnp.arange(0, T + dt, dt)) - 1
    sys_ = MyUADoublePendulum(
        dt=dt, x_target=jnp.array([jnp.pi, 0.0, 0.0, 0.0]),
        Q=jnp.diag(jnp.array([1.0, 1.0, 0.1, 0.1])),
        R=jnp.diag(jnp.array([1.0])),
        Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
        g=9.81, m1=1.0, m2=1.0, l1=1.0, l2=1.0, d1=0.1, d2=0.1,
        theta1=1.0 / 12.0, theta2=1.0 / 12.0,
        integrator="backward_euler", use_jit=True,
    )
    solver = iLQR(sys_, T, jnp.zeros(4), jnp.zeros((1, N)),
                  tol=1e-5, maxiter=700, verbose=False)
    X, U, cost = solver.optimize_trajectory()
    save("ua_double_pendulum_ol.npz", solver, X, U, cost)


def dynamics_samples():
    """Golden per-sample dynamics/cost values for model-level parity: the
    reference's f_fcn (per integrator), l_fcn, l_f_fcn on random (x, u)."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(32, 4)).astype(np.float32)
    us = rng.normal(size=(32, 2)).astype(np.float32)

    out = dict(xs=xs, us=us)
    for integ in ["euler", "midpoint", "rk4", "backward_euler"]:
        sys_ = MyDoublePendulum(
            dt=0.01, x_target=jnp.array([jnp.pi, 0.0, 0.0, 0.0]),
            Q=jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1])),
            R=jnp.diag(jnp.array([0.1, 0.1])),
            Q_f=jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0])),
            g=9.81, m1=1.0, m2=1.3, l1=1.0, l2=0.8, d1=0.1, d2=0.2,
            theta1=1.0 / 12.0, theta2=1.3 * 0.8**2 / 12.0,
            integrator=integ, use_jit=True,
        )
        out[f"f_{integ}"] = np.stack(
            [np.asarray(sys_.f_fcn(x, u)) for x, u in zip(xs, us)]
        )
        out[f"fx_{integ}"] = np.stack(
            [np.asarray(sys_.f_x_fcn(x, u)) for x, u in zip(xs, us)]
        )
        out[f"fu_{integ}"] = np.stack(
            [np.asarray(sys_.f_u_fcn(x, u)) for x, u in zip(xs, us)]
        )
    out["l"] = np.stack([np.asarray(sys_.l_fcn(x, u)) for x, u in zip(xs, us)])
    out["l_f"] = np.stack([np.asarray(sys_.l_f_fcn(x)) for x in xs])
    np.savez(os.path.join(OUT, "dynamics_samples.npz"), **out)
    print("dynamics_samples.npz written")


if __name__ == "__main__" and "--f64-only" not in sys.argv:
    pendulum_ol()
    double_pendulum_ol()
    ua_double_pendulum_ol()
    dynamics_samples()
    os._exit(0)


# ---------------------------------------------------------------------------
# float64 goldens (round 5, VERDICT r4 #7): the same reference code run
# under jax_enable_x64.  Measured: on the chaotic DP swing-up the REFERENCE
# ITSELF basin-hops with precision — f32 converges to cost 214.310, f64 to
# 42.774 (same code, same config) — while this framework's solver lands on
# cost 37.06 in BOTH precisions (better than the reference in either mode).
# Trajectory-level parity against the reference is therefore ill-posed on
# this problem; the f64 gates in tests/test_x64_parity.py instead pin
# (a) OUR f32 vs OUR f64 at trajectory level and (b) cost dominance over
# both reference precisions.
# ---------------------------------------------------------------------------


def f64_goldens():
    import importlib

    jax.config.update("jax_enable_x64", True)
    try:
        # Config of run_double_pendulum_open_loop.py:16-70, f64.
        dt, T = 0.01, 5.0
        N = 500
        Q = jnp.diag(jnp.array([10.0, 10.0, 0.1, 0.1]))
        R = jnp.diag(jnp.array([0.1, 0.1]))
        Qf = jnp.diag(jnp.array([1000.0, 1000.0, 100.0, 100.0]))
        sys_ref = MyDoublePendulum(
            dt=dt, x_target=jnp.array([jnp.pi, 0.0, 0.0, 0.0]), Q=Q, R=R,
            Q_f=Qf, g=9.81, m1=1.0, m2=1.0, l1=1.0, l2=1.0, d1=0.1, d2=0.1,
            theta1=1 / 12, theta2=1 / 12, integrator="euler", use_jit=True)
        solver = iLQR(system=sys_ref, T=T, x_0=jnp.zeros(4),
                      U_init=jnp.zeros((2, N)), tol=1e-6, maxiter=200,
                      verbose=False)
        X, U, cost = solver.optimize_trajectory()
        save("double_pendulum_ol_f64.npz", solver, X, U, cost)
    finally:
        jax.config.update("jax_enable_x64", False)


if __name__ == "__main__" and "--f64-only" in sys.argv:
    f64_goldens()
