"""Direct collocation oracle: the same OCP as a *simultaneous* NLP.

The reference's strongest verification mechanism solves the identical
optimal-control problem as a CasADi/IPOPT collocation NLP — states AND
controls as decision variables, dynamics as equality constraints
(`/root/reference/matlab/nonlinear_iLQR.m:54-103`, `casadi_sol.m`) — and
overlays the trajectories against the iLQR solution.  That is a different
TRANSCRIPTION FAMILY from shooting: iLQR (and the L-BFGS direct-shooting
oracle in tests/test_cross_validation.py) eliminate the states through the
rollout; collocation keeps them and enforces dynamics as constraints, so
agreement rules out errors shared by all shooting-type methods.

This module is that oracle, CasADi-free, built the way a sparse NLP solver
actually works (IPOPT solves the collocation KKT system with a sparse
indefinite factorization, MUMPS/MA57 — not a dense solve, and not a Riccati
recursion): a damped Newton-KKT SQP on z = (X₁…X_N, U₀…U_{N−1}) with

    min  Σₖ l(xₖ, uₖ) + l_f(x_N)
    s.t. cₖ(z) = 0,   k = 0…N−1

and two defect forms:
  * ``defect='step'`` (default): cₖ = step(system, xₖ, uₖ) − xₖ₊₁ — the
    system's own discrete dynamics, so the NLP optimum is EXACTLY the
    discrete optimum iLQR targets, for any integrator;
  * ``defect='trapezoidal'``: cₖ = xₖ + dt/2·(f_c(xₖ,uₖ) + f_c(xₖ₊₁,uₖ))
    − xₖ₊₁ — classic trapezoidal collocation on the continuous dynamics
    (ZOH controls, matching the framework's 'trapezoidal' integrator, for
    which the two forms coincide).

Independence from the solver stack (the point of an oracle): derivatives
are evaluated by JAX autodiff as vmapped PER-STEP blocks (exact Lagrangian
Hessian, including constraint curvature), but the Newton algebra runs on
the HOST in float64 — scipy sparse LU (SuperLU) on the block-tridiagonal
KKT matrix, numpy assembly, Python line-search loop.  No Riccati recursion,
no smallmat closed forms, no XLA linear solves, no
lax.while_loop.  The structured assembly is also what makes the oracle
scale: the dense-z ``jax.hessian`` of the previous revision compiled an
O((N·n)²)-sized XLA program (which crashed XLA:CPU codegen for the DP
problem under pytest-xdist workers and capped usable horizons near N≈120);
the per-step form compiles a few tiny programs and handles the full
reference DP swing-up horizon (N=500, `run_double_pendulum_open_loop.py:
16-70`) in seconds.

Precision: the oracle always computes in float64 (`jax.enable_x64` scoped
inside, host algebra in numpy f64) regardless of the caller's JAX mode —
an oracle exists to be sharper than the system under test.  The returned
arrays are float64.  The earlier f32-mode KKT floor (~0.4 on the stiff
Q_f=1000 DP cascade) is therefore moot: f64 is not a degraded fallback but
the documented contract, matching the reference whose CasADi/IPOPT check
is genuine double precision while the JAX side runs f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.rollout import rollout


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CollocationSolution:
    X: Any          # (N+1, n_x) states (x0 prepended)
    U: Any          # (N, n_u) controls
    cost: Any       # scalar objective at the solution
    kkt_residual: Any   # scalar: max |∇L| ∪ |c| at the solution
    iterations: Any


def _make_eval_fns(system: System, defect: str, N: int, n_x: int, n_u: int):
    """Jitted per-step derivative/merit evaluators (built under x64)."""
    dt = system.dt
    p = system.params

    def stage(x, u):
        return system.stage_cost(p, x, u)

    def con(x, u, xn):
        # c_k(x_k, u_k, x_{k+1}) for one step.
        if defect == "step":
            return step(system, x, u) - xn
        f = system.f_cont
        return x + 0.5 * dt * (f(p, x, u) + f(p, xn, u)) - xn

    def con_packed(w):
        x, u, xn = w[:n_x], w[n_x:n_x + n_u], w[n_x + n_u:]
        return con(x, u, xn)

    def lag_w(w, lam):
        return con_packed(w) @ lam

    @jax.jit
    def derivs(X, U, lam):
        """All KKT blocks at (X, U, lam) — vmapped over the horizon."""
        Xk, Xn = X[:-1], X[1:]
        lx = jax.vmap(jax.grad(stage, argnums=0))(Xk, U)
        lu = jax.vmap(jax.grad(stage, argnums=1))(Xk, U)
        lxx = jax.vmap(jax.hessian(stage, argnums=0))(Xk, U)
        luu = jax.vmap(jax.hessian(stage, argnums=1))(Xk, U)
        lux = jax.vmap(jax.jacfwd(jax.grad(stage, argnums=1), argnums=0))(
            Xk, U)
        lfx = jax.grad(lambda x: system.terminal_cost(p, x))(X[-1])
        lfxx = jax.hessian(lambda x: system.terminal_cost(p, x))(X[-1])
        c = jax.vmap(con)(Xk, U, Xn)
        A = jax.vmap(jax.jacfwd(con, argnums=0))(Xk, U, Xn)
        B = jax.vmap(jax.jacfwd(con, argnums=1))(Xk, U, Xn)
        C = jax.vmap(jax.jacfwd(con, argnums=2))(Xk, U, Xn)
        W = jax.vmap(jax.hessian(lag_w, argnums=0))(
            jnp.concatenate([Xk, U, Xn], axis=1), lam)
        return dict(lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux, lfx=lfx,
                    lfxx=lfxx, c=c, A=A, B=B, C=C, W=W)

    @jax.jit
    def obj_con(X, U):
        cost = jnp.sum(jax.vmap(stage)(X[:-1], U)) + system.terminal_cost(
            p, X[-1])
        c = jax.vmap(con)(X[:-1], U, X[1:])
        return cost, c

    @jax.jit
    def merit_candidates(X, U, dX, dU, alphas, rho):
        def one(a):
            cost, c = obj_con(X + a * dX, U + a * dU)
            return cost + rho * jnp.sum(jnp.abs(c))

        return jax.vmap(one)(alphas)

    return derivs, obj_con, merit_candidates


def _assemble_kkt(d, N, n_x, n_u, mu):
    """Block-tridiagonal KKT matrix + residual in interleaved ordering.

    Variable block k (k = 0…N−1): [u_k (n_u), λ_k (n_x), x_{k+1} (n_x)];
    x_0 is data, not a variable.  Constraint c_k couples (x_k, u_k, x_{k+1})
    and the stage cost couples (x_k, u_k), so every nonzero lives within two
    adjacent blocks — bandwidth O(n_x+n_u), independent of N.
    """
    m = n_u + 2 * n_x
    n = N * m
    iu = np.arange(N) * m                     # u_k start
    il = iu + n_u                             # λ_k start
    ix = il + n_x                             # x_{k+1} start
    # Column index of x_k as a variable: ix[k-1] for k ≥ 1; x_0 is fixed.
    ixk = np.concatenate([[-1], ix[:-1]])     # -1 marks "not a variable"

    rows, cols, vals = [], [], []

    def put(r0, c0, block, mask_r=None, mask_c=None):
        """Scatter dense (N, a, b) blocks at per-step offsets r0, c0 (N,)."""
        Nb, a, b = block.shape
        r = r0[:, None, None] + np.arange(a)[None, :, None]
        cc = c0[:, None, None] + np.arange(b)[None, None, :]
        keep = (r0 >= 0)[:, None, None] & (c0 >= 0)[:, None, None]
        keep = np.broadcast_to(keep, block.shape)
        rows.append(np.broadcast_to(r, block.shape)[keep])
        cols.append(np.broadcast_to(cc, block.shape)[keep])
        vals.append(block[keep])

    def put_sym(r0, c0, block):
        put(r0, c0, block)
        put(c0, r0, np.swapaxes(block, 1, 2))

    # Hessian of the Lagrangian (exact): stage-cost blocks + constraint
    # curvature W_k over (x_k, u_k, x_{k+1}) + terminal l_f_xx.
    put(iu, iu, d["luu"])
    put(ixk, ixk, d["lxx"])
    put_sym(iu, ixk, d["lux"])
    lfxx = d["lfxx"][None]
    put(ix[-1:], ix[-1:], lfxx)
    W = d["W"]
    sl_x, sl_u, sl_n = slice(0, n_x), slice(n_x, n_x + n_u), slice(
        n_x + n_u, None)
    put(ixk, ixk, W[:, sl_x, sl_x])
    put(iu, iu, W[:, sl_u, sl_u])
    put(ix, ix, W[:, sl_n, sl_n])
    put_sym(iu, ixk, W[:, sl_u, sl_x])
    put_sym(ix, ixk, W[:, sl_n, sl_x])
    put_sym(ix, iu, W[:, sl_n, sl_u])
    # Levenberg damping on the primal diagonal only.
    prim = np.concatenate([(iu[:, None] + np.arange(n_u)).ravel(),
                           (ix[:, None] + np.arange(n_x)).ravel()])
    rows.append(prim)
    cols.append(prim)
    vals.append(np.full(prim.shape, mu))
    # Constraint Jacobian rows (λ_k) and symmetric transposes.
    put_sym(il, ixk, d["A"])
    put_sym(il, iu, d["B"])
    put_sym(il, ix, d["C"])

    KKT = scipy.sparse.csc_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))

    # Residual (negated RHS): stationarity wrt u_k / x_k, and c_k.
    lam = d["lam"]
    r_u = d["lu"] + np.einsum("kiu,ki->ku", d["B"], lam)
    r_x = np.empty((N, n_x))
    r_x[:-1] = (d["lx"][1:]
                + np.einsum("kij,ki->kj", d["A"][1:], lam[1:])
                + np.einsum("kij,ki->kj", d["C"][:-1], lam[:-1]))
    r_x[-1] = d["lfx"] + d["C"][-1].T @ lam[-1]
    rhs = np.zeros(n)
    rhs[(iu[:, None] + np.arange(n_u)).ravel()] = -r_u.ravel()
    rhs[(ix[:, None] + np.arange(n_x)).ravel()] = -r_x.ravel()
    rhs[(il[:, None] + np.arange(n_x)).ravel()] = -d["c"].ravel()
    kkt_inf = max(np.max(np.abs(r_u)), np.max(np.abs(r_x)),
                  np.max(np.abs(d["c"])))
    return KKT, rhs, kkt_inf, (iu, il, ix)


@f32_matmuls
def solve_collocation(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    defect: str = "step",
    maxiter: int = 150,
    tol: float = 1e-6,
    damping: float = 1e-6,
    X_init: jnp.ndarray | None = None,
) -> CollocationSolution:
    """Solve the OCP as a simultaneous NLP (sparse damped Newton-KKT, f64).

    ``X_init=None`` seeds the states with the rollout of ``U_init`` (a
    feasible start); pass e.g. a straight-line interpolation to start
    infeasible — collocation does not need dynamically consistent iterates.
    """
    if defect not in ("step", "trapezoidal"):
        raise ValueError(f"defect must be 'step'|'trapezoidal', got {defect}")
    N, n_u = U_init.shape
    n_x = x0.shape[0]

    with jax.enable_x64(True):
        derivs, obj_con, merit_candidates = _make_eval_fns(
            system, defect, N, n_x, n_u)
        x0_ = jnp.asarray(np.asarray(x0), dtype=jnp.float64)
        U = jnp.asarray(np.asarray(U_init), dtype=jnp.float64)
        if X_init is None:
            X, _ = rollout(system, x0_, U)
            X = jnp.asarray(np.asarray(X), dtype=jnp.float64)
        else:
            X = jnp.concatenate(
                [x0_[None],
                 jnp.asarray(np.asarray(X_init), jnp.float64)[1:]])
        lam = jnp.zeros((N, n_x), dtype=jnp.float64)
        alphas = jnp.asarray([0.5 ** i for i in range(16)], jnp.float64)

        mu = float(damping)
        iters = 0
        kkt_inf = np.inf
        for _ in range(maxiter):
            d = {k: np.asarray(v) for k, v in derivs(X, U, lam).items()}
            d["lam"] = np.asarray(lam)
            KKT, rhs, kkt_inf, (iu, il, ix) = _assemble_kkt(
                d, N, n_x, n_u, mu)
            if kkt_inf < tol:
                break
            iters += 1
            sol = scipy.sparse.linalg.spsolve(KKT, rhs)
            if not np.all(np.isfinite(sol)):
                mu = max(mu, damping) * 10.0
                if mu > 1e8:
                    break
                continue
            dU = sol[(iu[:, None] + np.arange(n_u)).ravel()].reshape(N, n_u)
            dXt = sol[(ix[:, None] + np.arange(n_x)).ravel()].reshape(N, n_x)
            dlam = sol[(il[:, None] + np.arange(n_x)).ravel()].reshape(
                N, n_x)
            dX = jnp.concatenate(
                [jnp.zeros((1, n_x), jnp.float64), jnp.asarray(dXt)])
            dU_j = jnp.asarray(dU)

            # ℓ1-merit backtracking (first improving α); the exact-penalty
            # weight must dominate the multipliers.
            rho = max(10.0, 2.0 * float(np.max(np.abs(
                np.asarray(lam) + dlam))))
            cand = np.asarray(merit_candidates(
                X, U, dX, dU_j, alphas, jnp.float64(rho)))
            cost0, c0 = obj_con(X, U)
            m0 = float(cost0) + rho * float(np.sum(np.abs(np.asarray(c0))))
            ok = np.isfinite(cand) & (cand < m0)
            if ok.any():
                a = float(alphas[int(np.argmax(ok))])
                X = X + a * dX
                U = U + a * dU_j
                lam = lam + a * jnp.asarray(dlam)
                # Adaptive floor: strong Levenberg damping globalizes the
                # stiff swing-up cascades far from the solution, but a fixed
                # floor stalls the Newton tail — let the floor track the KKT
                # residual so the final iterations are (near-)undamped.
                mu = max(mu * 0.3, min(damping, kkt_inf))
            else:
                mu = max(mu, damping) * 10.0
                if mu > 1e8:
                    break

        # kkt_inf above is measured at the top of the loop, BEFORE the final
        # accepted step — on a maxiter exit it is one iterate stale.
        # Re-measure at the final (X, U, lam) (ADVICE r4 low #5).
        d = {k: np.asarray(v) for k, v in derivs(X, U, lam).items()}
        d["lam"] = np.asarray(lam)
        _, _, kkt_inf, _ = _assemble_kkt(d, N, n_x, n_u, mu)

        cost, _ = obj_con(X, U)
        sol = CollocationSolution(
            X=X, U=U, cost=cost,
            kkt_residual=jnp.asarray(kkt_inf, dtype=X.dtype),
            iterations=jnp.asarray(iters))
    return sol


# ---------------------------------------------------------------------------
# Inequality-constrained oracle: log-barrier continuation on the Newton-KKT
# collocation solver above (VERDICT r4 next-round #5).
#
# The reference's verification philosophy overlays an INDEPENDENT solver on
# the same OCP (`matlab/nonlinear_iLQR.m:54-103`, CasADi/IPOPT).  IPOPT is a
# primal-dual interior-point method; this oracle is its primal (Fiacco-
# McCormick) sibling: for a decreasing barrier weight μ_b, solve the
# equality-constrained barrier NLP
#
#     min  Σ l(x,u) − μ_b·Σ log(−g(x,u))   s.t. dynamics defects = 0
#
# with the EXISTING sparse f64 Newton-KKT machinery (the barrier terms ride
# the stage/terminal costs, so the block-tridiagonal KKT structure and every
# line of `solve_collocation` are reused unchanged), warm-starting each
# level from the previous one.  Infeasible line-search candidates produce
# NaN barrier values and are rejected by the ℓ1-merit's isfinite gate — the
# natural fraction-to-boundary rule.  At the final level the stationarity
# residual of the barrier problem equals the stationarity of the ORIGINAL
# KKT system with multiplier estimates z = μ_b/(−g) ≥ 0, and the
# complementarity gap is exactly μ_b per constraint — both reported.
#
# This validates `ilqr_tpu.constrained` (AL/ALTRO on GN-iLQR, a completely
# different algorithm family: penalty vs barrier, Riccati vs sparse LU,
# f32 device vs f64 host) the way the reference validates its solver.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConstrainedCollocationSolution:
    X: Any              # (N+1, n_x) states (f64)
    U: Any              # (N, n_u) controls (f64)
    cost: Any           # scalar ORIGINAL objective (no barrier terms)
    kkt_residual: Any   # stationarity+feasibility of the original KKT
    comp_gap: Any       # complementarity gap per constraint (= final μ_b)
    violation: Any      # max(0, g) over all stages (≤ 0 means feasible)
    iterations: Any     # total inner Newton iterations


def _barrier_system(system: System, cons, mu_b: float) -> System:
    """Wrap a system so its costs carry the −μ_b·Σlog(−g) barrier terms."""
    base_f = system.f_cont
    base_l = system.stage_cost
    base_lf = system.terminal_cost
    gi, gt = cons.stage_ineq, cons.terminal_ineq

    def f_cont(params, x, u):
        return base_f(params["base"], x, u)

    def stage(params, x, u):
        c = base_l(params["base"], x, u)
        g = gi(params["cp"], x, u)
        if g.shape[0]:
            c = c - params["mu_b"] * jnp.sum(jnp.log(-g))
        return c

    def term(params, x):
        c = base_lf(params["base"], x)
        g = gt(params["cp"], x)
        if g.shape[0]:
            c = c - params["mu_b"] * jnp.sum(jnp.log(-g))
        return c

    return system.replace(
        params=dict(base=system.params, cp=cons.params,
                    mu_b=jnp.asarray(mu_b, jnp.float64)),
        f_cont=f_cont, stage_cost=stage, terminal_cost=term)


def solve_collocation_constrained(
    system: System,
    constraints,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    defect: str = "step",
    mu_b0: float = 1.0,
    mu_b_min: float = 1e-6,
    mu_b_factor: float = 0.1,
    maxiter_inner: int = 60,
    tol: float = 1e-7,
    X_init: jnp.ndarray | None = None,
) -> ConstrainedCollocationSolution:
    """Inequality-constrained OCP as a barrier-collocation NLP (f64, host).

    ``constraints`` is an `ilqr_tpu.constrained.ConstraintSet` with
    inequality blocks only (g ≤ 0; equality blocks beyond the dynamics are
    not supported here).  The SEED must be strictly feasible: every
    g(x_k, u_k) < 0 along the rollout of ``U_init`` (or along ``X_init``) —
    barrier methods start inside the feasible region.
    """
    p = constraints.params
    n_he = jax.eval_shape(constraints.stage_eq, p, x0, U_init[0]).shape[0]
    n_hte = jax.eval_shape(constraints.terminal_eq, p, x0).shape[0]
    if n_he or n_hte:
        raise ValueError(
            "solve_collocation_constrained handles inequality blocks only "
            "(stage/terminal equality constraints beyond the dynamics are "
            "not supported)")

    with jax.enable_x64(True):
        x064 = jnp.asarray(np.asarray(x0), jnp.float64)
        U = jnp.asarray(np.asarray(U_init), jnp.float64)
        X = X_init
        total_iters = 0
        mu_b = float(mu_b0)
        kkt = np.inf
        while True:
            wrapped = _barrier_system(system, constraints, mu_b)
            # Inner tolerance tracks the barrier level (solving each level
            # to death wastes Newton steps — Fiacco-McCormick).
            inner_tol = max(tol, 1e-2 * mu_b)
            sol = solve_collocation(
                wrapped, x064, U, defect=defect, maxiter=maxiter_inner,
                tol=inner_tol, X_init=X)
            X, U = sol.X, sol.U
            total_iters += int(sol.iterations)
            kkt = float(sol.kkt_residual)
            if mu_b <= mu_b_min:
                break
            mu_b = max(mu_b * mu_b_factor, mu_b_min)

    # Original-objective cost + violation at the solution.  Fresh x64 scope:
    # the inner solves' scoped enable_x64 exits restore whatever mode they
    # saw at entry, so re-assert it for the final f64 evaluation.
    with jax.enable_x64(True):
        def orig_cost(Xs, Us):
            l = jax.vmap(lambda x, u: system.stage_cost(system.params, x, u))(
                Xs[:-1], Us)
            return jnp.sum(l) + system.terminal_cost(system.params, Xs[-1])

        gs = jax.vmap(lambda x, u: constraints.stage_ineq(p, x, u))(
            X[:-1], U)
        gt = constraints.terminal_ineq(p, X[-1])
        parts = [jnp.max(gs)] if gs.size else []
        if gt.size:
            parts.append(jnp.max(gt))
        viol = jnp.maximum(
            jnp.asarray(0.0, jnp.float64),
            jnp.max(jnp.stack(parts)) if parts else jnp.asarray(
                -jnp.inf, jnp.float64))
        return ConstrainedCollocationSolution(
            X=X, U=U, cost=orig_cost(X, U),
            kkt_residual=jnp.asarray(kkt, jnp.float64),
            comp_gap=jnp.asarray(mu_b, jnp.float64),
            violation=viol,
            iterations=jnp.asarray(total_iters))
