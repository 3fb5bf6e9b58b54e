"""Augmented-Lagrangian constrained iLQR (ALTRO-style), fully on-device.

Greenfield capability with no reference counterpart: the reference's only
treatment of constraints is a commented-out log-barrier on the control
(`/root/reference/python/class_files/systems/pendulum_sys.py:84-85`).  This
module solves

    min_{U}  Σ l(x_k, u_k) + l_f(x_N)
    s.t.     g(x_k, u_k) <= 0,   h(x_k, u_k) = 0      (stage, k = 0..N-1)
             g_f(x_N)   <= 0,    h_f(x_N)   = 0       (terminal)

by the Powell-Hestenes-Rockafellar augmented Lagrangian: an outer loop updates
multipliers/penalty, an inner iLQR minimizes the augmented cost.  Both loops
are `lax.while_loop`s inside one jitted program — zero host round-trips — so
the constrained solver vmaps/shards exactly like the unconstrained one.

Structure: the AL penalty's gradient/Gauss-Newton terms are added
to the *trajectory-wide* `TrajectoryExpansion` (one vmapped constraint
linearization per iteration, batched over time), so every backward-pass
backend — sequential scan, associative scan — composes
unchanged.  Line-search candidates are re-scored under the exact augmented
cost as one vmapped batch.

References (PAPERS.md): Howell, Jackson & Manchester, "ALTRO: A Fast Solver
for Constrained Trajectory Optimization" (IROS 2019) — the AL + iLQR
structure and Gauss-Newton penalty Hessian used here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

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

# Additional status: AL outer loop exhausted with violation above tolerance.
INFEASIBLE = 4


def _zero_con(params, *args):
    """Placeholder for an absent constraint block: zero-size residual."""
    return jnp.zeros((0,))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Constraint functions as pure callables over (params, x[, u]).

    Residual conventions: inequality ``g(x,u) <= 0`` elementwise; equality
    ``h(x,u) = 0``.  Absent blocks default to zero-size residuals, so all
    downstream algebra is uniform (shape-(0,) arrays cost nothing).
    """

    params: Any = None
    stage_ineq: Callable = dataclasses.field(
        default=_zero_con, metadata=dict(static=True))
    stage_eq: Callable = dataclasses.field(
        default=_zero_con, metadata=dict(static=True))
    terminal_ineq: Callable = dataclasses.field(
        default=_zero_con, metadata=dict(static=True))
    terminal_eq: Callable = dataclasses.field(
        default=_zero_con, metadata=dict(static=True))


def box_control_constraints(u_min, u_max) -> ConstraintSet:
    """``u_min <= u <= u_max`` as a stage inequality block.

    Useful as an AL cross-check of the projected-Newton boxQP path
    (`IlqrConfig.u_min/u_max`, ops/boxqp.py), and as the template for custom
    constraints.
    """
    lo = jnp.asarray(u_min)
    hi = jnp.asarray(u_max)

    def g(params, x, u):
        return jnp.concatenate([u - params["hi"], params["lo"] - u])

    return ConstraintSet(params=dict(lo=lo, hi=hi), stage_ineq=g)


def state_bound_constraints(x_min, x_max, terminal: bool = True) -> ConstraintSet:
    """``x_min <= x <= x_max`` as stage (and optionally terminal) inequalities.

    Bounds must be finite arrays of shape (n_x,); for one-sided bounds pick a
    large finite sentinel for the free side (±inf would poison the AL penalty
    terms).  The reference has no state constraints at all — its only sketch
    of constraint handling is a commented-out input log-barrier
    (`pendulum_sys.py:84-85`).
    """
    lo = jnp.asarray(x_min)
    hi = jnp.asarray(x_max)

    def g(params, x, u):
        return jnp.concatenate([x - params["hi"], params["lo"] - x])

    def g_term(params, x):
        return jnp.concatenate([x - params["hi"], params["lo"] - x])

    return ConstraintSet(
        params=dict(lo=lo, hi=hi),
        stage_ineq=g,
        terminal_ineq=g_term if terminal else _zero_con,
    )


def goal_constraint(x_goal) -> ConstraintSet:
    """Exact terminal state ``x_N = x_goal`` as a terminal equality block."""

    def h(params, x):
        return x - params["x_goal"]

    return ConstraintSet(params=dict(x_goal=jnp.asarray(x_goal)),
                         terminal_eq=h)


def merge_constraints(a: ConstraintSet, b: ConstraintSet) -> ConstraintSet:
    """Concatenate two constraint sets into one (residuals stacked)."""

    def cat(fa, fb, *sig):
        def f(params, *args):
            return jnp.concatenate(
                [fa(params["a"], *args), fb(params["b"], *args)])
        return f

    return ConstraintSet(
        params=dict(a=a.params, b=b.params),
        stage_ineq=cat(a.stage_ineq, b.stage_ineq),
        stage_eq=cat(a.stage_eq, b.stage_eq),
        terminal_ineq=cat(a.terminal_ineq, b.terminal_ineq),
        terminal_eq=cat(a.terminal_eq, b.terminal_eq),
    )


@dataclasses.dataclass(frozen=True)
class AlConfig:
    """Static outer-loop (augmented-Lagrangian) configuration."""

    max_outer: int = 20
    ctol: float = 1e-4          # max-violation convergence tolerance
    mu0: float = 1.0            # initial penalty
    mu_factor: float = 10.0     # penalty escalation per outer iteration
    mu_max: float = 1e8
    lam_max: float = 1e8        # multiplier clamp (safeguard)
    # Escalate mu only when the multiplier update alone is too slow: violation
    # must shrink by this factor per outer iteration to hold mu steady
    # (standard AL safeguard — Conn/Gould/Toint, used by ALTRO).
    viol_decrease: float = 0.25

    def __post_init__(self):
        if self.max_outer < 1:
            raise ValueError(f"max_outer must be >= 1, got {self.max_outer}")
        if self.mu_factor <= 1.0:
            raise ValueError(
                f"mu_factor must be > 1, got {self.mu_factor}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConstrainedSolution:
    X: Any              # (N+1, n_x) final trajectory
    U: Any              # (N, n_u) final controls
    cost: Any           # scalar TRUE cost (no penalty terms)
    violation: Any      # scalar max constraint violation
    status: Any         # CONVERGED / LINESEARCH_FAILED / INFEASIBLE
    outer_iterations: Any   # AL outer iterations executed
    inner_iterations: Any   # total iLQR iterations across outer loop
    lam_stage_ineq: Any     # (N, n_gi) final multipliers
    lam_stage_eq: Any       # (N, n_he)
    lam_terminal_ineq: Any  # (n_gti,)
    lam_terminal_eq: Any    # (n_hte,)
    mu: Any                 # final penalty
    violation_trace: Any    # (max_outer,) max violation per outer iter
    cost_trace: Any         # (max_outer,) true cost per outer iter


# --------------------------------------------------------------------------
# PHR penalty pieces.
#
# Inequality g <= 0:  phi(g; lam, mu) = (max(0, lam + mu g)^2 - lam^2) / (2 mu)
#   d phi / d g      = max(0, lam + mu g)            (the "effective" rho)
#   GN  d2 phi / dg2 = mu * 1[lam + mu g > 0]
# Equality h = 0:     phi(h; lam, mu) = lam h + (mu/2) h^2
#   d phi / d h = lam + mu h ;  d2 = mu
# Multiplier updates: lam <- max(0, lam + mu g) ;  lam <- lam + mu h.
# --------------------------------------------------------------------------

def _phi_ineq(g, lam, mu):
    rho = jnp.maximum(0.0, lam + mu * g)
    return jnp.sum((rho * rho - lam * lam) / (2.0 * mu))


def _phi_eq(h, lam, mu):
    return jnp.sum(lam * h + 0.5 * mu * h * h)


def _stage_penalty(cons, lam_gi, lam_he, mu, x, u):
    g = cons.stage_ineq(cons.params, x, u)
    h = cons.stage_eq(cons.params, x, u)
    return _phi_ineq(g, lam_gi, mu) + _phi_eq(h, lam_he, mu)


def _terminal_penalty(cons, lam_gti, lam_hte, mu, x):
    g = cons.terminal_ineq(cons.params, x)
    h = cons.terminal_eq(cons.params, x)
    return _phi_ineq(g, lam_gti, mu) + _phi_eq(h, lam_hte, mu)


def _augmented_traj_cost(system, cons, lams, mu, X, U, base_cost):
    """True-cost + AL penalty of a rollout, batched over time."""
    pen = jnp.sum(jax.vmap(
        lambda lg, lh, x, u: _stage_penalty(cons, lg, lh, mu, x, u)
    )(lams["gi"], lams["he"], X[:-1], U))
    pen = pen + _terminal_penalty(cons, lams["gti"], lams["hte"], mu, X[-1])
    return base_cost + pen


def _al_stage_terms(cons, lg, lh, mu, x, u):
    """Per-stage AL penalty gradient + Gauss-Newton Hessian terms
    (p_x, p_u, p_xx, p_ux, p_uu) — the single-stage unit shared by
    `_augment_expansion` and the horizon-sharded constrained-MS iteration
    (`ilqr_tpu.parallel.horizon_solve`)."""
    pen = lambda xx, uu: _stage_penalty(cons, lg, lh, mu, xx, uu)
    p_x = jax.grad(pen, argnums=0)(x, u)
    p_u = jax.grad(pen, argnums=1)(x, u)
    # Gauss-Newton Hessian: mu * J' D J with D the active mask — assembled
    # from constraint Jacobians, not the (discontinuous) penalty Hessian.
    g = cons.stage_ineq(cons.params, x, u)
    gx = jax.jacfwd(cons.stage_ineq, argnums=1)(cons.params, x, u)
    gu = jax.jacfwd(cons.stage_ineq, argnums=2)(cons.params, x, u)
    hx = jax.jacfwd(cons.stage_eq, argnums=1)(cons.params, x, u)
    hu = jax.jacfwd(cons.stage_eq, argnums=2)(cons.params, x, u)
    # Curvature mask: active if violated OR carrying a multiplier (ALTRO's
    # projection set), NOT the exact-penalty set (lam + mu g > 0).  A point
    # with lam > 0 just inside the boundary has zero exact curvature, and
    # using that set lets the Newton step sprint through the kink — the
    # quadratic model must keep such points stiff.
    act = ((g >= 0.0) | (lg > 0.0)).astype(x.dtype)
    p_xx = mu * (gx.T * act) @ gx + mu * hx.T @ hx
    p_uu = mu * (gu.T * act) @ gu + mu * hu.T @ hu
    p_ux = mu * (gu.T * act) @ gx + mu * hu.T @ hx
    return p_x, p_u, p_xx, p_ux, p_uu


def _al_terminal_terms(cons, lgti, lhte, mu, xN):
    """Terminal AL penalty gradient + GN Hessian (t_x, t_xx)."""
    tpen = lambda xx: _terminal_penalty(cons, lgti, lhte, mu, xx)
    t_x = jax.grad(tpen)(xN)
    gt = cons.terminal_ineq(cons.params, xN)
    gtx = jax.jacfwd(cons.terminal_ineq, argnums=1)(cons.params, xN)
    htx = jax.jacfwd(cons.terminal_eq, argnums=1)(cons.params, xN)
    act_t = ((gt >= 0.0) | (lgti > 0.0)).astype(xN.dtype)
    t_xx = mu * (gtx.T * act_t) @ gtx + mu * htx.T @ htx
    return t_x, t_xx


def _augment_expansion(exp: TrajectoryExpansion, cons, lams, mu, X, U
                       ) -> TrajectoryExpansion:
    """Add the AL penalty's gradient and Gauss-Newton Hessian to the
    trajectory expansion (constraint curvature dropped, as in ALTRO)."""
    p_x, p_u, p_xx, p_ux, p_uu = jax.vmap(
        lambda lg, lh, x, u: _al_stage_terms(cons, lg, lh, mu, x, u)
    )(lams["gi"], lams["he"], X[:-1], U)
    t_x, t_xx = _al_terminal_terms(cons, lams["gti"], lams["hte"], mu, X[-1])

    return TrajectoryExpansion(
        f_x=exp.f_x, f_u=exp.f_u,
        l_x=exp.l_x + p_x, l_u=exp.l_u + p_u,
        l_xx=exp.l_xx + p_xx, l_ux=exp.l_ux + p_ux, l_uu=exp.l_uu + p_uu,
        v_x=exp.v_x + t_x, v_xx=exp.v_xx + t_xx,
    )


def _violations(cons, X, U):
    """Max violation over the trajectory: max(g, 0) and |h|, stage+terminal."""
    def stage(x, u):
        g = cons.stage_ineq(cons.params, x, u)
        h = cons.stage_eq(cons.params, x, u)
        vals = jnp.concatenate([jnp.maximum(g, 0.0), jnp.abs(h)])
        return jnp.max(vals, initial=0.0)

    v_stage = jnp.max(jax.vmap(stage)(X[:-1], U), initial=0.0)
    gt = cons.terminal_ineq(cons.params, X[-1])
    ht = cons.terminal_eq(cons.params, X[-1])
    v_term = jnp.max(
        jnp.concatenate([jnp.maximum(gt, 0.0), jnp.abs(ht)]), initial=0.0)
    return jnp.maximum(v_stage, v_term)


def _inner_solve(system, cons, x0, U_init, lams, mu, config: IlqrConfig):
    """iLQR on the augmented cost: the solver.py loop with (a) AL terms fused
    into the expansion before the backward pass and (b) line-search candidates
    scored under the exact augmented cost."""
    alphas = jnp.asarray(config.alpha_schedule(), dtype=U_init.dtype)
    n_u = U_init.shape[-1]

    X0, base0 = rollout(system, x0, U_init)
    cost0 = _augmented_traj_cost(system, cons, lams, mu, X0, U_init, base0)

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
            exp = _augment_expansion(exp, cons, lams, mu, s["X"], s["U"])
            u_ff, K, dV, bp_ok = _backward(exp, s["U"], jnp.asarray(
                config.reg_init, dtype=s["cost"].dtype), config)

            X_c, U_c, base_costs = linesearch_rollouts(
                system, x0, alphas, s["X"], s["U"], u_ff, K,
                u_limits=config.limit_arrays(n_u, U_init.dtype),
            )
            costs = jax.vmap(
                lambda Xc, Uc, bc:
                    _augmented_traj_cost(system, cons, lams, mu, Xc, Uc, bc)
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


def _inner_solve_ms(system, cons, x0, U_init, X_init, lams, mu,
                    config: IlqrConfig, ms):
    """Multiple-shooting inner solve on the augmented cost (GNMS ×
    ALTRO): defect-aware backward on the penalty-augmented expansion, affine
    multi-candidate update pass, acceptance on the L1 exact-penalty merit
    φ = J_aug + ν·Σ‖d‖₁.  See `ilqr_tpu.shooting` for the MS machinery.
    Returns (X, U, base_cost, iterations, status)."""
    from ilqr_tpu.shooting import (
        _backward_ms,
        _node_cost,
        _node_defects,
        _update_pass_multi,
    )

    alphas = jnp.asarray(config.alpha_schedule(), dtype=U_init.dtype)
    base0 = _node_cost(system, X_init, U_init)
    aug0 = _augmented_traj_cost(system, cons, lams, mu, X_init, U_init, base0)

    init = dict(
        X=X_init, U=U_init, base=base0, aug=aug0,
        prev_merit=jnp.inf, nu=jnp.asarray(ms.nu0, dtype=base0.dtype),
        k=jnp.asarray(0), status=jnp.asarray(RUNNING),
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["k"] < config.maxiter)

    def body(s):
        d = _node_defects(system, s["X"], s["U"])
        defect = jnp.max(jnp.abs(d))
        merit = s["aug"] + s["nu"] * jnp.sum(jnp.abs(d))
        converged = (
            (s["k"] > 0)
            & (jnp.abs(merit - s["prev_merit"]) <= config.tol)
            & (defect <= ms.dtol)
        )

        def mark(s):
            return {**s, "status": jnp.asarray(CONVERGED)}

        def iterate(s):
            exp = linearize_trajectory(system, s["X"], s["U"])
            exp = _augment_expansion(exp, cons, lams, mu, s["X"], s["U"])
            u_ff, K, _, bp_ok = _backward_ms(
                exp, d, jnp.asarray(config.reg_init, dtype=s["aug"].dtype),
                config)
            dXs, dUs = _update_pass_multi(alphas, exp, d, u_ff, K,
                                          ms.update_engine)

            def score(dX, dU):
                X_c, U_c = s["X"] + dX, s["U"] + dU
                b = _node_cost(system, X_c, U_c)
                a = _augmented_traj_cost(system, cons, lams, mu, X_c, U_c, b)
                dn = jnp.sum(jnp.abs(_node_defects(system, X_c, U_c)))
                return X_c, U_c, b, a, a + s["nu"] * dn

            X_cs, U_cs, bases, augs, merits = jax.vmap(score)(dXs, dUs)
            accept = (merits <= merit) & jnp.isfinite(merits) & bp_ok
            any_accept = jnp.any(accept)
            idx = jnp.argmax(accept)

            def accepted(s):
                return {
                    **s, "X": X_cs[idx], "U": U_cs[idx],
                    "base": bases[idx], "aug": augs[idx],
                    "prev_merit": merit, "k": s["k"] + 1,
                }

            def rejected(s):
                stationary = (defect <= ms.dtol) & (
                    jnp.min(merits) >= merit - config.tol)
                new_nu = s["nu"] * ms.nu_factor
                fail = new_nu > ms.nu_max
                status = jnp.where(
                    stationary, CONVERGED,
                    jnp.where(fail, LINESEARCH_FAILED, RUNNING))
                return {
                    **s, "nu": jnp.minimum(new_nu, ms.nu_max),
                    "prev_merit": jnp.inf, "k": s["k"] + 1, "status": status,
                }

            return jax.lax.cond(any_accept, accepted, rejected, s)

        return jax.lax.cond(converged, mark, iterate, s)

    s = jax.lax.while_loop(cond, body, init)
    return s["X"], s["U"], s["base"], s["k"], s["status"]


@f32_matmuls
def solve_constrained_ms(
    system: System,
    constraints: ConstraintSet,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    X_init: jnp.ndarray | None = None,
    config: IlqrConfig = IlqrConfig(),
    al_config: AlConfig = AlConfig(),
    ms=None,
    lam_init: dict = None,
    mu_init=None,
) -> ConstrainedSolution:
    """Constrained solve with a MULTIPLE-SHOOTING inner solver (ALTRO's
    actual shape: augmented Lagrangian × infeasible-start Gauss-Newton
    shooting).  Same contract as `solve_constrained`, plus:

    * ``X_init`` — any (N+1, n_x) state warm start, dynamically infeasible
      allowed (straight-line `ilqr_tpu.interpolate_states`, a stale plan);
      defaults to the rollout of ``U_init`` (`config.init_rollout='defect'`
      builds it in O(log N) with a finite-guard constant-x0 fallback);
    * the state trajectory carries over BETWEEN outer iterations (the
      previous inner solution warm-starts the next, multipliers and primal
      together), where `solve_constrained` re-rolls out from scratch;
    * every inner stage is parallel-in-time (defect-aware Riccati on any
      backend + one multi-candidate affine prefix scan per iteration), so it
      composes with ``config.backward='pscan'`` — the O(log N)
      critical path survives constrained solving, like `ilqr_tpu.barrier`
      but for general equality+inequality constraints.
    """
    from ilqr_tpu.shooting import MsConfig

    if ms is None:
        ms = MsConfig()
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {U_init.shape}")
    N = U_init.shape[0]
    dtype = U_init.dtype
    p = constraints.params
    n_gi = jax.eval_shape(constraints.stage_ineq, p, x0, U_init[0]).shape[0]
    n_he = jax.eval_shape(constraints.stage_eq, p, x0, U_init[0]).shape[0]
    n_gti = jax.eval_shape(constraints.terminal_ineq, p, x0).shape[0]
    n_hte = jax.eval_shape(constraints.terminal_eq, p, x0).shape[0]
    if n_gi + n_he + n_gti + n_hte == 0:
        raise ValueError("constraint set is empty; use ilqr_tpu.solve_ms "
                         "instead")

    if X_init is None:
        if config.resolved_init_rollout() == "defect":
            from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout

            X_p, _, _ = open_loop_defect_rollout(
                system, x0, U_init, iters=config.defect_iters)
            X_init = jnp.where(
                jnp.all(jnp.isfinite(X_p)), X_p,
                jnp.broadcast_to(x0, (N + 1,) + x0.shape))
        else:
            X_init, _ = rollout(system, x0, U_init)
    if X_init.shape != (N + 1, system.n_x):
        raise ValueError(
            f"X_init must have shape ({N + 1}, {system.n_x}), "
            f"got {X_init.shape}")
    X_init = X_init.at[0].set(x0)

    lams0 = dict(
        gi=jnp.zeros((N, n_gi), dtype), he=jnp.zeros((N, n_he), dtype),
        gti=jnp.zeros((n_gti,), dtype), hte=jnp.zeros((n_hte,), dtype),
    )
    if lam_init is not None:
        lams0 = {k: jnp.asarray(lam_init[k], dtype).reshape(lams0[k].shape)
                 for k in lams0}
    nan = jnp.full((al_config.max_outer,), jnp.nan, dtype=dtype)
    init = dict(
        X=X_init, U=U_init,
        cost=jnp.asarray(jnp.inf, dtype), violation=jnp.asarray(jnp.inf, dtype),
        lams=lams0,
        mu=jnp.asarray(al_config.mu0 if mu_init is None else mu_init, dtype),
        j=jnp.asarray(0), inner_total=jnp.asarray(0),
        status=jnp.asarray(RUNNING),
        violation_trace=nan, cost_trace=nan,
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["j"] < al_config.max_outer)

    def body(s):
        X, U, base_cost, k_inner, inner_status = _inner_solve_ms(
            system, constraints, x0, s["U"], s["X"], s["lams"], s["mu"],
            config, ms)
        viol = _violations(constraints, X, U)

        def upd_stage(lg, lh, x, u):
            g = constraints.stage_ineq(constraints.params, x, u)
            h = constraints.stage_eq(constraints.params, x, u)
            return (jnp.maximum(0.0, lg + s["mu"] * g),
                    lh + s["mu"] * h)

        lg, lh = jax.vmap(upd_stage)(
            s["lams"]["gi"], s["lams"]["he"], X[:-1], U)
        gt = constraints.terminal_ineq(constraints.params, X[-1])
        ht = constraints.terminal_eq(constraints.params, X[-1])
        lgt = jnp.maximum(0.0, s["lams"]["gti"] + s["mu"] * gt)
        lht = s["lams"]["hte"] + s["mu"] * ht
        clamp = lambda l: jnp.clip(l, -al_config.lam_max, al_config.lam_max)
        lams = dict(gi=clamp(lg), he=clamp(lh), gti=clamp(lgt), hte=clamp(lht))

        feasible = viol <= al_config.ctol
        del inner_status
        stalled = (s["mu"] >= al_config.mu_max) & (viol >= 0.99 * s["violation"])
        status = jnp.where(
            feasible, CONVERGED, jnp.where(stalled, INFEASIBLE, RUNNING))
        j = s["j"]
        improving = viol <= al_config.viol_decrease * s["violation"]
        mu_next = jnp.where(
            improving, s["mu"],
            jnp.minimum(s["mu"] * al_config.mu_factor, al_config.mu_max))
        return {
            **s, "X": X, "U": U, "cost": base_cost, "violation": viol,
            "lams": lams, "mu": mu_next,
            "j": j + 1, "inner_total": s["inner_total"] + k_inner,
            "status": status,
            "violation_trace": s["violation_trace"].at[j].set(viol),
            "cost_trace": s["cost_trace"].at[j].set(base_cost),
        }

    s = jax.lax.while_loop(cond, body, init)
    status = jnp.where(
        (s["status"] == RUNNING) & (s["j"] >= al_config.max_outer),
        INFEASIBLE, s["status"])
    return ConstrainedSolution(
        X=s["X"], U=s["U"], cost=s["cost"], violation=s["violation"],
        status=status, outer_iterations=s["j"],
        inner_iterations=s["inner_total"],
        lam_stage_ineq=s["lams"]["gi"], lam_stage_eq=s["lams"]["he"],
        lam_terminal_ineq=s["lams"]["gti"], lam_terminal_eq=s["lams"]["hte"],
        mu=s["mu"], violation_trace=s["violation_trace"],
        cost_trace=s["cost_trace"],
    )


@f32_matmuls
def solve_constrained(
    system: System,
    constraints: ConstraintSet,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    al_config: AlConfig = AlConfig(),
    lam_init: dict = None,
    mu_init=None,
) -> ConstrainedSolution:
    """Solve the constrained problem. Pure; safe to jit/vmap/shard.

    Multiplier shapes are inferred by tracing the constraint callables once
    at (x0, U_init[0]) — constraint residual sizes must be static.

    ``lam_init`` warm-starts the multipliers: a dict with keys
    ``gi (N, n_gi) / he (N, n_he) / gti (n_gti,) / hte (n_hte,)`` (e.g. the
    ``lam_*`` fields of a previous `ConstrainedSolution`, shifted along the
    horizon for MPC).  ``mu_init`` warm-starts the penalty.  Both default to
    the cold start (zeros / ``al_config.mu0``).
    """
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {U_init.shape}")
    N = U_init.shape[0]
    dtype = U_init.dtype
    p = constraints.params
    n_gi = jax.eval_shape(constraints.stage_ineq, p, x0, U_init[0]).shape[0]
    n_he = jax.eval_shape(constraints.stage_eq, p, x0, U_init[0]).shape[0]
    n_gti = jax.eval_shape(constraints.terminal_ineq, p, x0).shape[0]
    n_hte = jax.eval_shape(constraints.terminal_eq, p, x0).shape[0]
    if n_gi + n_he + n_gti + n_hte == 0:
        raise ValueError("constraint set is empty; use ilqr_tpu.solve instead")

    lams0 = dict(
        gi=jnp.zeros((N, n_gi), dtype), he=jnp.zeros((N, n_he), dtype),
        gti=jnp.zeros((n_gti,), dtype), hte=jnp.zeros((n_hte,), dtype),
    )
    if lam_init is not None:
        lams0 = {k: jnp.asarray(lam_init[k], dtype).reshape(lams0[k].shape)
                 for k in lams0}
    nan = jnp.full((al_config.max_outer,), jnp.nan, dtype=dtype)
    init = dict(
        X=jnp.zeros((N + 1, system.n_x), dtype), U=U_init,
        cost=jnp.asarray(jnp.inf, dtype), violation=jnp.asarray(jnp.inf, dtype),
        lams=lams0,
        mu=jnp.asarray(al_config.mu0 if mu_init is None else mu_init, dtype),
        j=jnp.asarray(0), inner_total=jnp.asarray(0),
        status=jnp.asarray(RUNNING),
        violation_trace=nan, cost_trace=nan,
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["j"] < al_config.max_outer)

    def body(s):
        X, U, base_cost, k_inner, inner_status = _inner_solve(
            system, constraints, x0, s["U"], s["lams"], s["mu"], config)
        viol = _violations(constraints, X, U)

        # Multiplier updates at the inner solution.
        def upd_stage(lg, lh, x, u):
            g = constraints.stage_ineq(constraints.params, x, u)
            h = constraints.stage_eq(constraints.params, x, u)
            return (jnp.maximum(0.0, lg + s["mu"] * g),
                    lh + s["mu"] * h)

        lg, lh = jax.vmap(upd_stage)(
            s["lams"]["gi"], s["lams"]["he"], X[:-1], U)
        gt = constraints.terminal_ineq(constraints.params, X[-1])
        ht = constraints.terminal_eq(constraints.params, X[-1])
        lgt = jnp.maximum(0.0, s["lams"]["gti"] + s["mu"] * gt)
        lht = s["lams"]["hte"] + s["mu"] * ht
        clamp = lambda l: jnp.clip(l, -al_config.lam_max, al_config.lam_max)
        lams = dict(gi=clamp(lg), he=clamp(lh), gti=clamp(lgt), hte=clamp(lht))

        feasible = viol <= al_config.ctol
        # An inner line-search failure is treated as inner convergence ("the
        # augmented cost cannot be improved at this penalty level") — the
        # multiplier/penalty update typically restores progress, so the outer
        # loop continues until feasibility or max_outer.
        del inner_status
        # Stall exit: penalty already at its cap and the violation no longer
        # shrinking — further outer iterations cannot make progress (in f32
        # the achievable violation floors near the augmented cost's relative
        # resolution, ~1e-7·cost per inner step).
        stalled = (s["mu"] >= al_config.mu_max) & (viol >= 0.99 * s["violation"])
        status = jnp.where(
            feasible, CONVERGED, jnp.where(stalled, INFEASIBLE, RUNNING))
        j = s["j"]
        # Hold mu when the multiplier update alone is contracting the
        # violation fast enough; escalate otherwise.
        improving = viol <= al_config.viol_decrease * s["violation"]
        mu_next = jnp.where(
            improving, s["mu"],
            jnp.minimum(s["mu"] * al_config.mu_factor, al_config.mu_max))
        return {
            **s, "X": X, "U": U, "cost": base_cost, "violation": viol,
            "lams": lams,
            "mu": mu_next,
            "j": j + 1, "inner_total": s["inner_total"] + k_inner,
            "status": status,
            "violation_trace": s["violation_trace"].at[j].set(viol),
            "cost_trace": s["cost_trace"].at[j].set(base_cost),
        }

    s = jax.lax.while_loop(cond, body, init)
    status = jnp.where(
        (s["status"] == RUNNING) & (s["j"] >= al_config.max_outer),
        INFEASIBLE, s["status"])
    return ConstrainedSolution(
        X=s["X"], U=s["U"], cost=s["cost"], violation=s["violation"],
        status=status, outer_iterations=s["j"],
        inner_iterations=s["inner_total"],
        lam_stage_ineq=s["lams"]["gi"], lam_stage_eq=s["lams"]["he"],
        lam_terminal_ineq=s["lams"]["gti"], lam_terminal_eq=s["lams"]["hte"],
        mu=s["mu"], violation_trace=s["violation_trace"],
        cost_trace=s["cost_trace"],
    )
