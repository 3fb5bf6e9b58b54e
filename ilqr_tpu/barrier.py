"""Relaxed log-barrier constrained iLQR (interior-point style), on-device.

The reference's only gesture at constraints is a commented-out log-barrier on
the control (`/root/reference/python/class_files/systems/pendulum_sys.py:84-85`).
This module completes that idea properly: inequality constraints

    min_{U}  Σ l(x_k, u_k) + l_f(x_N)
    s.t.     g(x_k, u_k) <= 0   (stage),   g_f(x_N) <= 0   (terminal)

are handled by adding the RELAXED log-barrier penalty  μ Σ β(−g_i; δ)  to the
cost, where β(z; δ) = −ln z for z ≥ δ and the C² quadratic extension

    β(z; δ) = ((z − 2δ)² / δ² − 1) / 2 − ln δ         for z < δ

below it (Feller & Ebenbauer 2017; Grandia et al. 2019 use exactly this form
for MPC).  Unlike a pure log-barrier, the relaxed barrier is defined
EVERYWHERE — no strictly feasible initialization is required, and infeasible
line-search candidates get large-but-finite costs instead of NaN.  An outer
loop shrinks μ along the central path; each inner problem is a smooth
unconstrained iLQR solve.

Why this exists next to the augmented-Lagrangian solver (`constrained.py`)
and boxQP (`ops/boxqp.py`): the barrier penalty is C², so the inner problem
stays a *plain* iLQR problem.  Both backward-pass backends — sequential
scan, associative O(log N) scan — and the parallel-in-time defect line
search compose unchanged (AL's Gauss-Newton penalty is only C⁰ in its
curvature mask).  So constrained solving at long horizons can keep the
O(log N) critical path.

Both loops run inside one jitted program: the outer μ-schedule is a
`lax.scan` (fixed trip count, warm-started controls), the inner solve a
`lax.while_loop` — zero host round-trips, so `solve_barrier` vmaps and
shards exactly like the unconstrained solver.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ilqr_tpu.constrained import INFEASIBLE, ConstraintSet, _violations
from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion, linearize_trajectory
from ilqr_tpu.ops.rollout import linesearch_rollouts, rollout
from ilqr_tpu.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    RUNNING,
    IlqrConfig,
    _backward,
)


# --------------------------------------------------------------------------
# Relaxed log-barrier β(z; δ) on the slack z = −g (feasible ⇔ z > 0).
# C² everywhere; convex; β'' > 0, so the Gauss-Newton penalty Hessian
# Σ μ β''(z_i) ∇g_i ∇g_iᵀ is PSD by construction.
# --------------------------------------------------------------------------

def relaxed_log_barrier(z, delta):
    """β(z; δ): −ln z for z ≥ δ, quadratic C² extension below."""
    zs = jnp.maximum(z, delta)          # guard: ln only sees z ≥ δ > 0
    log_part = -jnp.log(zs)
    quad_part = 0.5 * (((z - 2.0 * delta) / delta) ** 2 - 1.0) - jnp.log(delta)
    return jnp.where(z >= delta, log_part, quad_part)


def _beta_d1(z, delta):
    """β'(z; δ)."""
    zs = jnp.maximum(z, delta)
    return jnp.where(z >= delta, -1.0 / zs, (z - 2.0 * delta) / (delta * delta))


def _beta_d2(z, delta):
    """β''(z; δ) > 0."""
    zs = jnp.maximum(z, delta)
    return jnp.where(z >= delta, 1.0 / (zs * zs), 1.0 / (delta * delta))


@dataclasses.dataclass(frozen=True)
class BarrierConfig:
    """Static outer-loop (central-path) configuration."""

    n_outer: int = 6            # μ-schedule length (fixed trip count)
    mu0: float = 1.0            # initial barrier weight
    mu_factor: float = 0.2      # μ shrink per outer iteration (< 1)
    delta: float = 0.1          # initial relaxation threshold on the slack
    # δ must shrink WITH μ: the infeasible branch's quadratic stiffness is
    # μ/δ², so fixed δ would let violations grow as μ → 0.  With
    # δ_j = δ·mu_factor^j the stiffness grows like mu_factor^{-j} and the
    # violation contracts along the central path.  None → mu_factor.
    delta_factor: float = None
    ctol: float = 1e-3          # violation tolerance for the CONVERGED status

    def __post_init__(self):
        if self.n_outer < 1:
            raise ValueError(f"n_outer must be >= 1, got {self.n_outer}")
        if not 0.0 < self.mu_factor < 1.0:
            raise ValueError(
                f"mu_factor must be in (0, 1), got {self.mu_factor}")
        if self.delta <= 0.0:
            raise ValueError(f"delta must be > 0, got {self.delta}")
        if self.delta_factor is not None and not 0.0 < self.delta_factor <= 1.0:
            raise ValueError(
                f"delta_factor must be in (0, 1], got {self.delta_factor}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BarrierSolution:
    X: Any                  # (N+1, n_x) final trajectory
    U: Any                  # (N, n_u) final controls
    cost: Any               # scalar TRUE cost (no barrier terms)
    violation: Any          # scalar max constraint violation
    status: Any             # CONVERGED / LINESEARCH_FAILED / INFEASIBLE
    inner_iterations: Any   # total iLQR iterations across the μ-schedule
    mu: Any                 # final barrier weight
    violation_trace: Any    # (n_outer,) max violation per outer iteration
    cost_trace: Any         # (n_outer,) true cost per outer iteration


def _stage_barrier(cons, mu, delta, x, u):
    g = cons.stage_ineq(cons.params, x, u)
    return mu * jnp.sum(relaxed_log_barrier(-g, delta))


def _terminal_barrier(cons, mu, delta, x):
    g = cons.terminal_ineq(cons.params, x)
    return mu * jnp.sum(relaxed_log_barrier(-g, delta))


def _barrier_traj_cost(system, cons, mu, delta, X, U, base_cost):
    """True cost + barrier penalty of a rollout, batched over time."""
    pen = jnp.sum(jax.vmap(
        lambda x, u: _stage_barrier(cons, mu, delta, x, u))(X[:-1], U))
    pen = pen + _terminal_barrier(cons, mu, delta, X[-1])
    return base_cost + pen


def _augment_expansion(exp: TrajectoryExpansion, cons, mu, delta, X, U
                       ) -> TrajectoryExpansion:
    """Add the barrier's exact gradient and Gauss-Newton Hessian to the
    trajectory expansion (constraint curvature dropped, mirroring
    `constrained._augment_expansion`; β'' > 0 keeps the added blocks PSD)."""

    def stage_terms(x, u):
        pen = lambda xx, uu: _stage_barrier(cons, mu, delta, xx, uu)
        p_x = jax.grad(pen, argnums=0)(x, u)
        p_u = jax.grad(pen, argnums=1)(x, u)
        g = cons.stage_ineq(cons.params, x, u)
        gx = jax.jacfwd(cons.stage_ineq, argnums=1)(cons.params, x, u)
        gu = jax.jacfwd(cons.stage_ineq, argnums=2)(cons.params, x, u)
        w = mu * _beta_d2(-g, delta)            # (n_g,) positive weights
        p_xx = (gx.T * w) @ gx
        p_uu = (gu.T * w) @ gu
        p_ux = (gu.T * w) @ gx
        return p_x, p_u, p_xx, p_ux, p_uu

    p_x, p_u, p_xx, p_ux, p_uu = jax.vmap(stage_terms)(X[:-1], U)

    tpen = lambda xx: _terminal_barrier(cons, mu, delta, xx)
    t_x = jax.grad(tpen)(X[-1])
    gt = cons.terminal_ineq(cons.params, X[-1])
    gtx = jax.jacfwd(cons.terminal_ineq, argnums=1)(cons.params, X[-1])
    w_t = mu * _beta_d2(-gt, delta)
    t_xx = (gtx.T * w_t) @ gtx

    return TrajectoryExpansion(
        f_x=exp.f_x, f_u=exp.f_u,
        l_x=exp.l_x + p_x, l_u=exp.l_u + p_u,
        l_xx=exp.l_xx + p_xx, l_ux=exp.l_ux + p_ux, l_uu=exp.l_uu + p_uu,
        v_x=exp.v_x + t_x, v_xx=exp.v_xx + t_xx,
    )


def _inner_solve(system, cons, x0, U_init, mu, delta, config: IlqrConfig):
    """iLQR on the barrier-augmented cost: solver.py's loop with the barrier
    terms fused into the expansion before the (ANY-backend) backward pass and
    line-search candidates scored under the exact barrier cost."""
    alphas = jnp.asarray(config.alpha_schedule(), dtype=U_init.dtype)
    n_u = U_init.shape[-1]

    X0, base0 = rollout(system, x0, U_init)
    cost0 = _barrier_traj_cost(system, cons, mu, delta, X0, U_init, base0)

    init = dict(
        X=X0, U=U_init, cost=cost0, base_cost=base0,
        prev_cost=jnp.inf, k=jnp.asarray(0), status=jnp.asarray(RUNNING),
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["k"] < config.maxiter)

    def body(s):
        converged = (s["k"] > 0) & (
            jnp.abs(s["cost"] - s["prev_cost"]) <= config.tol)

        def mark(s):
            return {**s, "status": jnp.asarray(CONVERGED)}

        def iterate(s):
            exp = linearize_trajectory(system, s["X"], s["U"])
            exp = _augment_expansion(exp, cons, mu, delta, s["X"], s["U"])
            u_ff, K, dV, bp_ok = _backward(exp, s["U"], jnp.asarray(
                config.reg_init, dtype=s["cost"].dtype), config)

            X_c, U_c, base_costs = linesearch_rollouts(
                system, x0, alphas, s["X"], s["U"], u_ff, K,
                u_limits=config.limit_arrays(n_u, U_init.dtype),
            )
            costs = jax.vmap(
                lambda Xc, Uc, bc:
                    _barrier_traj_cost(system, cons, mu, delta, Xc, Uc, bc)
            )(X_c, U_c, base_costs)
            accept = (costs <= s["cost"]) & jnp.isfinite(costs) & bp_ok
            any_accept = jnp.any(accept)
            idx = jnp.argmax(accept)

            def accepted(s):
                return {
                    **s, "X": X_c[idx], "U": U_c[idx],
                    "prev_cost": s["cost"], "cost": costs[idx],
                    "base_cost": base_costs[idx], "k": s["k"] + 1,
                }

            def rejected(s):
                return {**s, "status": jnp.asarray(LINESEARCH_FAILED)}

            return jax.lax.cond(any_accept, accepted, rejected, s)

        return jax.lax.cond(converged, mark, iterate, s)

    s = jax.lax.while_loop(cond, body, init)
    return s["X"], s["U"], s["base_cost"], s["k"], s["status"]


@f32_matmuls
def solve_barrier(
    system: System,
    constraints: ConstraintSet,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    barrier_config: BarrierConfig = BarrierConfig(),
) -> BarrierSolution:
    """Solve the inequality-constrained problem on the central path.

    Pure; safe to jit/vmap/shard.  Inequality constraints only — route
    equality constraints to `solve_constrained` (a log-barrier has no
    interior for h = 0).  Because the inner problems are smooth, `config`
    may select either backward backend (`backward='scan'|'pscan'`) and
    the defect-correction parallel line search.
    """
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {U_init.shape}")
    p = constraints.params
    n_he = jax.eval_shape(constraints.stage_eq, p, x0, U_init[0]).shape[0]
    n_hte = jax.eval_shape(constraints.terminal_eq, p, x0).shape[0]
    if n_he + n_hte > 0:
        raise ValueError(
            "barrier solver handles inequality constraints only; "
            "use solve_constrained for equality constraints")
    n_gi = jax.eval_shape(constraints.stage_ineq, p, x0, U_init[0]).shape[0]
    n_gti = jax.eval_shape(constraints.terminal_ineq, p, x0).shape[0]
    if n_gi + n_gti == 0:
        raise ValueError("constraint set is empty; use ilqr_tpu.solve instead")

    dtype = U_init.dtype
    bc = barrier_config
    js = jnp.arange(bc.n_outer, dtype=dtype)
    mus = bc.mu0 * bc.mu_factor ** js
    dfac = bc.mu_factor if bc.delta_factor is None else bc.delta_factor
    deltas = bc.delta * dfac ** js

    def outer(carry, mu_delta):
        U, inner_total = carry
        mu, delta = mu_delta
        X, U1, base_cost, k_inner, status = _inner_solve(
            system, constraints, x0, U, mu, delta, config)
        viol = _violations(constraints, X, U1)
        return (U1, inner_total + k_inner), (X, base_cost, viol, status)

    (U_f, inner_total), (Xs, costs, viols, statuses) = jax.lax.scan(
        outer, (U_init, jnp.asarray(0)), (mus, deltas))

    X_f, cost_f, viol_f = Xs[-1], costs[-1], viols[-1]
    inner_ok = statuses[-1] != LINESEARCH_FAILED
    status = jnp.where(
        viol_f <= bc.ctol, CONVERGED,
        jnp.where(inner_ok, INFEASIBLE, LINESEARCH_FAILED))
    return BarrierSolution(
        X=X_f, U=U_f, cost=cost_f, violation=viol_f, status=status,
        inner_iterations=inner_total, mu=mus[-1],
        violation_trace=viols, cost_trace=costs,
    )
