"""Gauss-Newton multiple shooting (GNMS): iLQR over an (X, U) node pair.

The reference solver — and `ilqr_tpu.solve` — is SINGLE shooting: the state
trajectory is always the exact rollout of the controls, so the only possible
warm start is a control sequence, and every line-search candidate costs one
O(N) sequential rollout.  Multiple shooting (Giftthaler et al. 2018, "A
Family of Iterative Gauss-Newton Shooting Methods for Nonlinear Optimal
Control") makes the states decision variables too, coupled by defect
(gap) constraints

    d_k = f(x_k, u_k) − x_{k+1}  →  0,

which buys two things this framework cares about:

* **infeasible warm starts** — initialize X with anything (straight-line
  interpolation to the goal, a stale MPC plan, a coarse-grid solution); the
  solver closes the gaps while optimizing, where single shooting would have
  to first discover a comparable trajectory through rollouts;
* **an iteration with no sequential nonlinearity** — with defects allowed, the update pass is
  the AFFINE recursion δx⁺ = f_x δx + f_u δu + α·d (no nonlinear rollout
  inside the line search at all), and the new defects/costs are evaluated by
  one vmapped (embarrassingly parallel over time) pass.  Nothing in the
  iteration is sequentially nonlinear; the affine scan has an O(log N)
  associative form shared with `ops/parallel_rollout`.

Algorithm per iteration:
  1. defects d_k and stage costs: one vmapped evaluation over time;
  2. `linearize_trajectory` at the (X, U) nodes (vmapped);
  3. defect-aware Riccati backward pass (`ops/riccati.py::backward_pass`
     with ``defects=d`` — V_x → V_x + V_xx·d in the linear Q-terms);
  4. multi-candidate affine update pass over the α schedule (vmapped scan):
     δu = α·u_ff + K δx,  δx⁺ = f_x δx + f_u δu + α·d — at α=1 the
     linearized gaps close exactly; at α they contract by (1−α);
  5. accept the first α improving the L1 exact-penalty merit
     φ = J(X, U) + ν·Σ‖d‖₁; ν escalates when the line search stalls.

Reference counterpart: none (capability beyond the reference, which is
single-shooting iLQR only — `iLQR_class.py:250-313`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    MAXITER,
    RUNNING,
    IlqrConfig,
)


@dataclasses.dataclass(frozen=True)
class MsConfig:
    """Multiple-shooting extras on top of `IlqrConfig` (static, hashable).

    nu0/nu_factor/nu_max: L1 exact-penalty weight schedule for the merit
    function φ = J + ν·Σ‖d‖₁.  ν must dominate the constraint multipliers
    (≈ ‖V_x‖∞ along the trajectory) for the penalty to be exact; instead of
    estimating them, a failed line search escalates ν and retries (consuming
    an iteration), up to nu_max.
    dtol: max-norm defect feasibility tolerance required for convergence.
    update_engine: how the multi-α affine update pass runs — 'seq' (vmapped
    sequential scan) or 'xla' (O(log N) associative prefix scan,
    `ops.parallel_rollout.affine_prefix_scan_multi`); 'auto' is 'seq'.  Both
    compute the SAME affine recursion — unlike single shooting there is no
    nonlinear rollout to approximate, so the parallel engine is exact, not
    defect-certified.
    """

    nu0: float = 10.0
    nu_factor: float = 10.0
    nu_max: float = 1e8
    dtol: float = 1e-4
    update_engine: str = "auto"

    def __post_init__(self):
        if self.update_engine not in ("auto", "seq", "xla"):
            raise ValueError(
                f"update_engine must be 'auto'|'seq'|'xla', "
                f"got {self.update_engine!r}"
            )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MsSolution:
    X: Any           # (N+1, n_x) state nodes (feasible at convergence)
    U: Any           # (N, n_u) controls
    cost: Any        # scalar cost of (X, U) node pair
    defect: Any      # scalar max-norm shooting gap
    iterations: Any
    status: Any      # CONVERGED / LINESEARCH_FAILED / MAXITER
    u_ff: Any
    K: Any
    cost_trace: Any    # (maxiter,) nan-padded
    defect_trace: Any  # (maxiter,) nan-padded
    alpha_trace: Any   # (maxiter,) nan-padded


def interpolate_states(x0: jnp.ndarray, x_goal: jnp.ndarray, N: int):
    """Straight-line (N+1, n_x) state warm start from x0 to x_goal — the
    canonical infeasible multiple-shooting initialization."""
    w = jnp.linspace(0.0, 1.0, N + 1, dtype=x0.dtype)[:, None]
    return (1.0 - w) * x0[None, :] + w * jnp.asarray(x_goal, x0.dtype)[None, :]


def _node_cost(system: System, X, U):
    """Cost of an (X, U) node pair — defined for INFEASIBLE trajectories too
    (stage costs at the stored nodes; one vmapped evaluation)."""
    stage = jax.vmap(lambda x, u: system.stage_cost(system.params, x, u))
    return jnp.sum(stage(X[:-1], U)) + system.terminal_cost(system.params, X[-1])


def _node_defects(system: System, X, U):
    """d_k = f(x_k, u_k) − x_{k+1}; vmapped over time."""
    f = jax.vmap(lambda x, u: step(system, x, u))
    return f(X[:-1], U) - X[1:]


@f32_matmuls
def _update_pass(alpha, exp, d, u_ff, K):
    """Affine multiple-shooting update: δx₀ = 0, δu = α·u_ff + K δx,
    δx⁺ = f_x δx + f_u δu + α·d.  Returns (δX (N+1), δU (N))."""

    def body(dx, inp):
        f_x, f_u, d_k, uff_k, K_k = inp
        du = alpha * uff_k + K_k @ dx
        dx1 = f_x @ dx + f_u @ du + alpha * d_k
        return dx1, (dx, du)

    n_x = d.shape[-1]
    dx_N, (dX_head, dU) = jax.lax.scan(
        body, jnp.zeros((n_x,), d.dtype), (exp.f_x, exp.f_u, d, u_ff, K)
    )
    dX = jnp.concatenate([dX_head, dx_N[None]], axis=0)
    return dX, dU


@f32_matmuls
def _update_pass_multi(alphas, exp, d, u_ff, K, engine: str):
    """All line-search candidates' affine updates at once.

    Substituting δu = α·u_ff + K δx gives the closed-loop affine recursion
    δx⁺ = (f_x + f_u K) δx + α·(f_u u_ff + d): one transition chain shared by
    every α with per-candidate drive vectors — exactly the shape of
    `ops.parallel_rollout.affine_prefix_scan_multi` (O(log N) depth).  EXACT
    for both engines (the update pass is affine; nothing to certify).
    Returns (δX (A, N+1, n_x), δU (A, N, n_u)).
    """
    if engine in ("auto", "seq"):
        return jax.vmap(lambda a: _update_pass(a, exp, d, u_ff, K))(alphas)

    from ilqr_tpu.ops.parallel_rollout import affine_prefix_scan_multi

    A = alphas.shape[0]
    n_x = d.shape[-1]
    P = exp.f_x + exp.f_u @ K                              # (N, n_x, n_x)
    base = (exp.f_u @ u_ff[..., None])[..., 0] + d         # (N, n_x)
    q = alphas[:, None, None] * base[None]                 # (A, N, n_x)
    dX = affine_prefix_scan_multi(
        P, q, jnp.zeros((A, n_x), d.dtype))                 # (A, N+1, n_x)
    dU = (alphas[:, None, None] * u_ff[None]
          + (K[None] @ dX[:, :-1, :, None])[..., 0])        # (A, N, n_u)
    return dX, dU


def _backward_ms(exp, d, reg, config: IlqrConfig):
    """Defect-aware backward pass honoring `config.backward` (mirrors
    `solver._backward`): 'scan'/'auto' sequential, 'pscan' associative
    O(log N) — both support the GNMS defects."""
    if config.backward == "pscan":
        from ilqr_tpu.ops.parallel_riccati import backward_pass_associative

        return backward_pass_associative(exp, reg, defects=d)
    return backward_pass(exp, reg, defects=d)


@f32_matmuls
def solve_ms(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    X_init: jnp.ndarray | None = None,
    config: IlqrConfig = IlqrConfig(),
    ms: MsConfig = MsConfig(),
) -> MsSolution:
    """Multiple-shooting trajectory optimization. Pure; safe to jit/vmap.

    X_init: optional (N+1, n_x) state warm start — may be dynamically
    infeasible (see `interpolate_states`); row 0 is overwritten with x0.
    Defaults to the open-loop rollout of U_init (then iteration 1 matches
    single-shooting iLQR exactly, d ≡ 0).
    """
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {U_init.shape}"
        )
    if x0.shape != (system.n_x,):
        raise ValueError(f"x0 must have shape ({system.n_x},), got {x0.shape}")
    N, n_u = U_init.shape
    n_x = x0.shape[0]
    if X_init is None:
        # Default state warm start: the rollout of U_init (iteration 1 then
        # matches single shooting, d ≡ 0).  config.init_rollout='defect'
        # builds it with the O(log N) parallel-in-time Newton sweeps instead
        # of the O(N) sequential chain, which at long horizons can dominate
        # the whole MS solve.  Unlike in
        # `solve`, an unconverged defect rollout needs no fallback: the
        # residual gaps are exactly what the MS iteration closes anyway, so
        # the certificate only seeds cost0/merit bookkeeping.
        if config.resolved_init_rollout() == "defect":
            from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout

            X_p, _, _ = open_loop_defect_rollout(
                system, x0, U_init, iters=config.defect_iters)
            # Unlike `solve`, an UNCONVERGED defect rollout needs no exact
            # fallback — residual gaps are what the MS iteration closes.
            # Only divergence to non-finite values must be excluded: fall
            # back to the constant-x0 trajectory (maximally infeasible but
            # finite), still never paying the O(N) sequential chain.
            X_init = jnp.where(
                jnp.all(jnp.isfinite(X_p)),
                X_p,
                jnp.broadcast_to(x0, (N + 1,) + x0.shape),
            )
        else:
            from ilqr_tpu.ops.rollout import rollout

            X_init, _ = rollout(system, x0, U_init)
    if X_init.shape != (N + 1, n_x):
        raise ValueError(
            f"X_init must have shape ({N + 1}, {n_x}), got {X_init.shape}"
        )
    X_init = X_init.at[0].set(x0)
    alphas = jnp.asarray(config.alpha_schedule(), dtype=U_init.dtype)

    cost0 = _node_cost(system, X_init, U_init)
    nan = jnp.full((config.maxiter,), jnp.nan, dtype=cost0.dtype)
    init = dict(
        X=X_init, U=U_init,
        u_ff=jnp.zeros((N, n_u), U_init.dtype),
        K=jnp.zeros((N, n_u, n_x), U_init.dtype),
        cost=cost0,
        prev_merit=jnp.inf,
        nu=jnp.asarray(ms.nu0, dtype=cost0.dtype),
        reg=jnp.asarray(config.reg_init, dtype=cost0.dtype),
        k=jnp.asarray(0),
        status=jnp.asarray(RUNNING),
        cost_trace=nan, defect_trace=nan, alpha_trace=nan,
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["k"] < config.maxiter)

    def body(s):
        d = _node_defects(system, s["X"], s["U"])
        defect = jnp.max(jnp.abs(d))
        merit = s["cost"] + s["nu"] * jnp.sum(jnp.abs(d))
        converged = (
            (s["k"] > 0)
            & (jnp.abs(merit - s["prev_merit"]) <= config.tol)
            & (defect <= ms.dtol)
        )

        def mark_converged(s):
            return {**s, "status": jnp.asarray(CONVERGED)}

        def iterate(s):
            exp = linearize_trajectory(system, s["X"], s["U"])
            u_ff, K, _, bp_ok = _backward_ms(exp, d, s["reg"], config)

            dXs, dUs = _update_pass_multi(alphas, exp, d, u_ff, K,
                                          ms.update_engine)

            def score(dX, dU):
                X_c, U_c = s["X"] + dX, s["U"] + dU
                c = _node_cost(system, X_c, U_c)
                dn = jnp.sum(jnp.abs(_node_defects(system, X_c, U_c)))
                return X_c, U_c, c, c + s["nu"] * dn

            X_cs, U_cs, costs, merits = jax.vmap(score)(dXs, dUs)
            accept = (merits <= merit) & jnp.isfinite(merits) & bp_ok
            any_accept = jnp.any(accept)
            idx = jnp.argmax(accept)  # first improving α, schedule order

            def accepted(s):
                k = s["k"]
                reg = s["reg"] / config.reg_factor if config.adaptive_reg else s["reg"]
                if config.adaptive_reg:
                    reg = jnp.maximum(reg, 0.0)
                d_new = jnp.max(jnp.abs(_node_defects(system, X_cs[idx], U_cs[idx])))
                return {
                    **s,
                    "X": X_cs[idx], "U": U_cs[idx],
                    "u_ff": u_ff, "K": K,
                    "cost": costs[idx],
                    "prev_merit": merit,
                    "reg": reg,
                    "k": k + 1,
                    "cost_trace": s["cost_trace"].at[k].set(costs[idx]),
                    "defect_trace": s["defect_trace"].at[k].set(d_new),
                    "alpha_trace": s["alpha_trace"].at[k].set(alphas[idx]),
                }

            def rejected(s):
                # Feasible and no candidate improves the merit by more than
                # tol → stationary point: converged (escalating ν cannot help
                # once the gaps are closed).  Otherwise escalate the penalty
                # weight (the usual stall: ν below the active multipliers
                # makes gap-closing steps look bad) and, if configured, the
                # regularization; retry next iteration.
                stationary = (defect <= ms.dtol) & (
                    jnp.min(merits) >= merit - config.tol
                )
                new_nu = s["nu"] * ms.nu_factor
                new_reg = (
                    jnp.maximum(s["reg"], 1e-6) * config.reg_factor
                    if config.adaptive_reg else s["reg"]
                )
                fail = new_nu > ms.nu_max
                status = jnp.where(
                    stationary,
                    CONVERGED,
                    jnp.where(fail, LINESEARCH_FAILED, RUNNING),
                )
                return {
                    **s,
                    "nu": jnp.minimum(new_nu, ms.nu_max),
                    "reg": new_reg,
                    "prev_merit": jnp.inf,
                    "k": s["k"] + 1,
                    "status": status,
                }

            return jax.lax.cond(any_accept, accepted, rejected, s)

        return jax.lax.cond(converged, mark_converged, iterate, s)

    s = jax.lax.while_loop(cond, body, init)
    status = jnp.where(
        (s["status"] == RUNNING) & (s["k"] >= config.maxiter),
        MAXITER,
        s["status"],
    )
    d_final = jnp.max(jnp.abs(_node_defects(system, s["X"], s["U"])))
    return MsSolution(
        X=s["X"], U=s["U"], cost=s["cost"], defect=d_final,
        iterations=s["k"], status=status, u_ff=s["u_ff"], K=s["K"],
        cost_trace=s["cost_trace"], defect_trace=s["defect_trace"],
        alpha_trace=s["alpha_trace"],
    )
