"""iLQR solver with the entire optimization loop on-device.

Algorithmic parity target: `/root/reference/python/class_files/iLQR_class.py:250-313`
(initial rollout, backward pass, backtracking line search with
accept-iff ``cost_new <= cost``, convergence on ``|Δcost| <= tol``, line-search
failure → stop).  The reference runs that loop on the host with a device
round-trip per line-search probe; here it is a single jitted
``lax.while_loop`` — one device program per solve, which is what makes
vmapping over thousands of MPC instances and sharding over a mesh viable.

Key structural differences (behavior-preserving):
* derivatives are hoisted out of the Riccati scan into one vmapped
  trajectory-wide linearization (`ilqr_tpu.ops.linearize`);
* the α backtracking schedule is evaluated as one vmapped rollout batch and
  the *first improving* α is selected — identical accept order to the
  reference's sequential loop (`iLQR_class.py:281-301`);
* optional Q_uu regularization with adaptive escalation (off by default for
  parity — the reference has none);
* optional O(log N)-depth associative-scan backward pass
  (`ilqr_tpu.ops.parallel_riccati`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.linearize import linearize_trajectory_smart
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.ops.rollout import (
    linesearch_rollouts_smart,
    open_loop_init_smart,
    rollout_flagged,
)

# Solve status codes (returned in IlqrSolution.status).
RUNNING, CONVERGED, LINESEARCH_FAILED, MAXITER = 0, 1, 2, 3

# Engine values that no longer exist, and what replaces each.
_REMOVED = {
    "backward": {"pallas": "'pscan' (the XLA associative scan)"},
    "rollout": {"pallas": "'scan' (the vmapped sequential rollouts)"},
}


@dataclasses.dataclass(frozen=True)
class IlqrConfig:
    """Static solver configuration (hashable → usable as a jit static arg).

    Defaults mirror the reference solver's constructor defaults
    (`iLQR_class.py:18-27`, line-search protocol at `:279-301`).
    """

    maxiter: int = 100
    tol: float = 1e-5
    alpha0: float = 1.0
    alpha_factor: float = 0.5
    n_alphas: int = 10
    min_alpha: float = 1e-8
    # Backward engine: 'scan' (sequential Riccati recursion) or 'pscan'
    # (O(log N)-depth associative suffix scan, ops/parallel_riccati.py).
    # 'auto' is 'scan' on every platform.
    backward: str = "auto"
    # Full DDP: add the second-order dynamics terms V_x·f_xx/f_ux/f_uu to the
    # Q-expansion (Jacobson & Mayne).  Quadratic local convergence near the
    # optimum at the price of an extra Hessian evaluation per iteration and a
    # possibly-indefinite Q_uu — pair with adaptive_reg=True on hard problems.
    # backward='scan'/'auto' runs the exact sequential recursion;
    # 'pscan' runs ddp_sweeps frozen-value-trace suffix scans
    # (O(sweeps·log N) depth, fixed point = the exact recursion —
    # ops/parallel_riccati.py::backward_pass_ddp_parallel).  The same applies
    # to the iLQG ``noise`` terms.
    ddp: bool = False
    # Frozen-value fixed-point sweeps for the PARALLEL ddp/noise backward
    # (measured u_ff agreement with the sequential recursion on the pendulum:
    # 0.6% at 2 sweeps, 6e-6 at 4; inexact gains cost outer iterations, not
    # correctness — the line search guards descent).
    ddp_sweeps: int = 3
    # Line-search rollout engine: 'scan' = one vmapped XLA rollout batch over
    # all α; 'defect' =
    # parallel-in-time Newton-Picard sweeps (O(log N) depth); 'chunked' =
    # multiple-shooting rollouts (exact nonlinear chunks of length ~√N
    # vmapped, O(C) boundary Newton correction — larger contraction region
    # than 'defect' on drift-prone systems, ops/chunked_rollout.py).  The
    # parallel modes share a two-phase schedule (first-α alone, then the full
    # candidate batch only if it is rejected) and an exact-sequential fallback
    # when certification fails.  'auto' is 'scan'.
    rollout: str = "auto"
    # Defect-correction rollout settings (rollout='defect'): max Newton-Picard
    # sweeps per rollout and the certification threshold above which a
    # candidate is rejected as unconverged.  Sweeps early-exit once the defect
    # drops below 1e-3·defect_tol (dynamics evaluation dominates sweep cost;
    # the margin keeps defect-induced cost error well under the convergence
    # tol — with quadratic Newton contraction it costs at most ~1 extra sweep).
    defect_iters: int = 8
    defect_tol: float = 1e-3
    # Chunk length for rollout='chunked' (0 = auto: ≈ √N clamped to
    # [16, 512] for the phase-1 candidate, ~8× that for the full phase-2
    # schedule whose aggressive candidates need the larger certification
    # region — ops/chunked_rollout.py::auto_chunk_len/coarse_chunk_len).
    # A nonzero value overrides both phases.
    chunk_len: int = 0
    # Initial open-loop rollout engine: 'scan' (sequential, exact) or
    # 'defect' (parallel-in-time Newton sweeps, ops/parallel_rollout.py;
    # O(log N) depth instead of the O(N) chain that dominates long-horizon
    # solve latency).  'defect' self-certifies: if the final defect exceeds
    # defect_tol the solver falls back to the sequential rollout (lax.cond).
    # 'auto' is 'scan'.
    init_rollout: str = "auto"
    reg_init: float = 0.0
    reg_factor: float = 10.0
    reg_max: float = 1e9
    adaptive_reg: bool = False
    # Hard box limits on controls (control-limited iLQR, ops/boxqp.py): a
    # scalar or length-n_u tuple each, or None for unconstrained (the
    # reference's only treatment is a commented-out log-barrier,
    # `pendulum_sys.py:84-85`).  Static → changing limits recompiles.
    u_min: Any = None
    u_max: Any = None
    boxqp_iters: int = 8
    # Active-set sweep CAP of the PARALLEL control-limited backward
    # (ops/limited_parallel.py): each sweep is one O(log N) suffix scan with
    # the clamped set frozen + a projected-Newton set update; the iteration
    # exits early once the set stops changing.  Used when limits are combined
    # with backward='pscan'.
    active_set_sweeps: int = 12
    # iLQG stochastic dynamics (ilqr_tpu.ilqg): a pure function
    # noise_fn(x, u) -> (n_x, n_w) giving the noise-direction matrix C of
    # x⁺ = f(x, u) + C(x, u)·ξ, ξ ~ N(0, I).  The backward pass minimizes the
    # EXPECTED cost (noise-covariance Q-terms); nominal rollouts, line search
    # and the convergence test stay deterministic.  backward='scan'/'auto' is
    # the exact sequential recursion; 'pscan' the frozen-value parallel form
    # (see ddp above).
    noise: Any = None

    def __post_init__(self):
        for field, allowed in (
                ("backward", ("auto", "scan", "pscan")),
                ("rollout", ("auto", "scan", "defect", "chunked")),
                ("init_rollout", ("auto", "scan", "defect"))):
            value = getattr(self, field)
            if value in _REMOVED.get(field, {}):
                raise ValueError(
                    f"{field}={value!r} was removed; use "
                    f"{_REMOVED[field][value]}")
            if value not in allowed:
                raise ValueError(
                    f"{field} must be one of {allowed}, got {value!r}")
        if (self.u_min is None) != (self.u_max is None):
            raise ValueError("u_min and u_max must be set together")
        if self.ddp_sweeps < 1:
            raise ValueError(f"ddp_sweeps must be >= 1, got {self.ddp_sweeps}")
        if self.maxiter < 1:
            raise ValueError(f"maxiter must be >= 1, got {self.maxiter}")

    def resolved_rollout(self) -> str:
        """Line-search engine after 'auto' resolution (static, trace-time).

        'auto' is the sequential 'scan' engine on every platform; the
        parallel-in-time engines ('defect', 'chunked') are chosen by name.
        """
        return "scan" if self.rollout == "auto" else self.rollout

    def resolved_init_rollout(self) -> str:
        """Initial-rollout engine after 'auto' resolution (trace-time)."""
        return "scan" if self.init_rollout == "auto" else self.init_rollout

    def limit_arrays(self, n_u: int, dtype):
        """(lo, hi) broadcast to (n_u,), or None if unconstrained."""
        if self.u_min is None:
            return None
        lo = jnp.broadcast_to(jnp.asarray(self.u_min, dtype=dtype), (n_u,))
        hi = jnp.broadcast_to(jnp.asarray(self.u_max, dtype=dtype), (n_u,))
        return lo, hi

    def alpha_schedule(self) -> Tuple[float, ...]:
        """The reference's backtracking schedule as a static tuple
        (α0, α0·γ, …), truncated at min_alpha (`iLQR_class.py:279-301`)."""
        out, a = [], self.alpha0
        for _ in range(self.n_alphas):
            out.append(a)
            a *= self.alpha_factor
            if a < self.min_alpha:
                break
        return tuple(out)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IlqrSolution:
    X: Any          # (N+1, n_x) optimal state trajectory
    U: Any          # (N, n_u) optimal controls
    cost: Any       # scalar converged cost
    iterations: Any # number of outer iterations executed
    status: Any     # CONVERGED / LINESEARCH_FAILED / MAXITER
    u_ff: Any       # (N, n_u) last feedforward
    K: Any          # (N, n_u, n_x) last feedback gains
    cost_trace: Any   # (maxiter,) cost after each iteration (nan-padded)
    alpha_trace: Any  # (maxiter,) accepted α per iteration (nan-padded)
    grad_trace: Any   # (maxiter,) max |u_ff| per iteration (nan-padded)
    # Final state of the parallel-line-search latch (True = the parallel
    # rollouts were still certifying when the solve ended).  Warm-startable:
    # feed it back as `solve(..., defect_latch=...)` so a drift-prone MPC
    # problem stops re-paying phase1+phase2+exact-fallback on EVERY step
    # (the latch otherwise resets per solve call inside the MPC scan).
    defect_latch: Any


def _backward(exp, U, reg, config: IlqrConfig, hess=None, noise=None):
    parallel = config.backward == "pscan"
    if config.u_min is not None:
        lo, hi = config.limit_arrays(U.shape[-1], U.dtype)
        if parallel:
            from ilqr_tpu.ops.limited_parallel import (
                backward_pass_limited_parallel,
            )

            return backward_pass_limited_parallel(
                exp, U, lo, hi, reg, sweeps=config.active_set_sweeps,
                hess=hess, noise=noise)
        from ilqr_tpu.ops.riccati import backward_pass_limited

        return backward_pass_limited(exp, U, lo, hi, reg,
                                     qp_iters=config.boxqp_iters, hess=hess,
                                     noise=noise)
    if config.ddp or noise is not None:
        if parallel:
            from ilqr_tpu.ops.parallel_riccati import (
                backward_pass_ddp_parallel,
            )

            return backward_pass_ddp_parallel(
                exp, reg, hess=hess, noise=noise, sweeps=config.ddp_sweeps)
        return backward_pass(exp, reg, hess=hess, noise=noise)
    if parallel:
        from ilqr_tpu.ops.parallel_riccati import backward_pass_associative

        return backward_pass_associative(exp, reg)
    return backward_pass(exp, reg)


@f32_matmuls
def solve(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    defect_latch: Any = None,
) -> IlqrSolution:
    """Solve the trajectory-optimization problem. Pure; safe to jit/vmap.

    Time-major layout: U_init (N, n_u); returns X (N+1, n_x).

    ``defect_latch`` (optional bool array) warm-starts the parallel
    line-search latch from a previous related solve (MPC loops thread
    `IlqrSolution.defect_latch` through their scan carry); ``None`` starts
    fresh — the parallel path is tried iff the resolved rollout engine is
    parallel-in-time.
    """
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        # Mirrors the reference's constructor-time validation
        # (`iLQR_class.py:50-52`), adapted to time-major layout.
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {U_init.shape}"
        )
    if x0.shape != (system.n_x,):
        raise ValueError(f"x0 must have shape ({system.n_x},), got {x0.shape}")
    alphas = jnp.asarray(config.alpha_schedule(), dtype=U_init.dtype)
    N, n_u = U_init.shape
    n_x = x0.shape[0]

    limits = config.limit_arrays(n_u, U_init.dtype)
    if limits is not None:
        # Feasible initial guess: the initial rollout applies U_init verbatim.
        U_init = jnp.clip(U_init, limits[0], limits[1])
    rollout_mode = config.resolved_rollout()
    if config.resolved_init_rollout() == "defect":
        # custom_vmap wrapper: single-instance = defect sweeps with the
        # sequential fallback; under vmap(solve) = the plain batched
        # rollout — the defect machinery's cond→select lowering would
        # otherwise run BOTH branches per instance.
        X0, cost0 = open_loop_init_smart(
            system, x0, U_init, config.defect_iters, config.defect_tol)
    else:
        X0, cost0 = rollout_flagged(system, x0, U_init)
    nan = jnp.full((config.maxiter,), jnp.nan, dtype=cost0.dtype)

    init = dict(
        X=X0,
        U=U_init,
        u_ff=jnp.zeros((N, n_u), U_init.dtype),
        K=jnp.zeros((N, n_u, n_x), U_init.dtype),
        cost=cost0,
        prev_cost=jnp.inf,
        k=jnp.asarray(0),
        reg=jnp.asarray(config.reg_init, dtype=cost0.dtype),
        status=jnp.asarray(RUNNING),
        cost_trace=nan,
        alpha_trace=nan,
        grad_trace=nan,
        # Parallel-line-search latch (see the defect/chunked branch).
        use_defect=(jnp.asarray(rollout_mode in ("defect", "chunked"))
                    if defect_latch is None
                    else jnp.asarray(defect_latch)
                    & (rollout_mode in ("defect", "chunked"))),
    )

    def cond(s):
        return (s["status"] == RUNNING) & (s["k"] < config.maxiter)

    def body(s):
        # Convergence test at the top of the iteration, skipped on the first
        # (`iLQR_class.py:267`).
        converged = (s["k"] > 0) & (jnp.abs(s["cost"] - s["prev_cost"]) <= config.tol)

        def mark_converged(s):
            return {**s, "status": jnp.asarray(CONVERGED)}

        def iterate(s):
            exp = linearize_trajectory_smart(system, s["X"], s["U"])
            if config.ddp:
                from ilqr_tpu.ops.linearize import dynamics_hessians

                hess = dynamics_hessians(system, s["X"], s["U"])
            else:
                hess = None
            if config.noise is not None:
                from ilqr_tpu.ilqg import noise_expansion

                noise = tuple(noise_expansion(config.noise, s["X"], s["U"]))
            else:
                noise = None
            u_ff, K, dV, bp_ok = _backward(exp, s["U"], s["reg"], config,
                                           hess, noise)

            if rollout_mode in ("defect", "chunked"):
                if rollout_mode == "chunked":
                    from ilqr_tpu.ops.chunked_rollout import (
                        chunked_rollout,
                        coarse_chunk_len,
                        linesearch_chunked_rollouts,
                    )

                    # Phase 1 (the α=1 fast path) uses the fine auto length;
                    # phase 2 — reached only when the first candidate was
                    # rejected, i.e. the step is aggressive — pays ~8× longer
                    # chunks for a far larger certification region (the fine
                    # scheme's boundary Newton diverges exactly on those
                    # aggressive candidates; see coarse_chunk_len).  An
                    # explicit config.chunk_len overrides both.
                    L2 = config.chunk_len or coarse_chunk_len(N)

                    def single_par(alpha, A_cl, exit_tol):
                        return chunked_rollout(
                            system, x0, alpha, s["X"], s["U"], u_ff, K, A_cl,
                            sweeps=config.defect_iters,
                            chunk_len=config.chunk_len,
                            exit_tol=exit_tol, u_limits=limits)

                    def multi_par(A_cl, exit_tol):
                        return linesearch_chunked_rollouts(
                            system, x0, alphas, s["X"], s["U"], u_ff, K, A_cl,
                            sweeps=config.defect_iters,
                            chunk_len=L2,
                            exit_tol=exit_tol, u_limits=limits)
                else:
                    from ilqr_tpu.ops.parallel_rollout import (
                        defect_rollout,
                        linesearch_defect_rollouts,
                    )

                    def single_par(alpha, A_cl, exit_tol):
                        return defect_rollout(
                            system, x0, alpha, s["X"], s["U"], u_ff, K, A_cl,
                            iters=config.defect_iters,
                            exit_tol=exit_tol, u_limits=limits)

                    def multi_par(A_cl, exit_tol):
                        return linesearch_defect_rollouts(
                            system, x0, alphas, s["X"], s["U"], u_ff, K, exp,
                            iters=config.defect_iters,
                            exit_tol=exit_tol, u_limits=limits)

                n_alpha = alphas.shape[0]
                # Scale-aware tolerances: certifying ABSOLUTE defects
                # penalizes large-state systems (a 100k-step cartpole drifts
                # to |x|~1e2 and never certifies at 1e-3) — measure against
                # the current trajectory's scale instead.
                scale = 1.0 + jnp.max(jnp.abs(s["X"]))
                cert_tol = config.defect_tol * scale
                exit_tol = 1e-3 * cert_tol

                def exact_ls(_):
                    Xs, Us, cs = linesearch_rollouts_smart(
                        system, x0, alphas, s["X"], s["U"], u_ff, K,
                        u_limits=limits)
                    return (Xs, Us, cs, jnp.ones_like(cs, dtype=bool),
                            jnp.asarray(False))

                def defect_ls(_):
                    A_cl = exp.f_x + exp.f_u @ K

                    # Phase 1: the FIRST candidate in the backtracking
                    # schedule alone (it is the accepted one in almost every
                    # iteration of a healthy solve, and accept-first-improving
                    # means accepting it needs no knowledge of the later
                    # candidates).  Sweep cost is dominated by dynamics
                    # evaluation, so sweeping one candidate instead of the
                    # whole schedule is ~n_alpha× cheaper.
                    X1, U1, cost1, d1 = single_par(alphas[0], A_cl, exit_tol)
                    ok1 = ((d1 < cert_tol) & jnp.isfinite(cost1)
                           & (cost1 <= s["cost"]))

                    def phase1(_):
                        Xs = jnp.broadcast_to(X1, (n_alpha,) + X1.shape)
                        Us = jnp.broadcast_to(U1, (n_alpha,) + U1.shape)
                        cs = jnp.full((n_alpha,), jnp.inf,
                                      dtype=cost1.dtype).at[0].set(cost1)
                        cert = jnp.zeros((n_alpha,), bool).at[0].set(True)
                        return Xs, Us, cs, cert, jnp.asarray(True)

                    # Phase 2 (first candidate rejected): all α via the
                    # shared multi-candidate scan.  Only defect-certified
                    # candidates are eligible; accept-first-improving is only
                    # faithful if every candidate EARLIER in the schedule
                    # than the winner has a known (exact) cost.  If an
                    # uncertified candidate precedes the first
                    # certified-improving one — or nothing certifies at all
                    # (the Newton-Picard sweeps diverge far from the
                    # linearization point) — fall back to the exact
                    # sequential rollouts instead of silently creeping along
                    # tiny certified α.  The branches only *execute* when
                    # taken (lax.cond) on unbatched solves; under vmap they
                    # lower to selects and all run — the official batched
                    # surfaces (`parallel.batch.solve_batched`,
                    # `mpc.run_mpc_batched`) therefore pin 'auto' to the
                    # vmapped scan engine; raw vmap(solve) at N≥256 stays
                    # correct but pays both branches.
                    def phase2(_):
                        X_c, U_c, costs, defects = multi_par(A_cl, exit_tol)
                        certified = defects < cert_tol
                        acc_par = ((costs <= s["cost"]) & jnp.isfinite(costs)
                                   & certified)
                        idx_par = jnp.argmax(acc_par)
                        preceding_uncertified = jnp.any(
                            ~certified & (jnp.arange(n_alpha) < idx_par))
                        par_ok = jnp.any(acc_par) & ~preceding_uncertified

                        def exact(_):
                            Xs, Us, cs, cert, _ = exact_ls(None)
                            return Xs, Us, cs, cert, jnp.asarray(False)

                        def keep(_):
                            return X_c, U_c, costs, certified, jnp.asarray(True)

                        return jax.lax.cond(par_ok, keep, exact, None)

                    return jax.lax.cond(ok1, phase1, phase2, None)

                # Latch: once the parallel path has failed certification and
                # paid the exact fallback, later iterations go straight to
                # the exact line search — a problem that left the contraction
                # regime would otherwise pay phase1+phase2+fallback EVERY
                # iteration.
                X_c, U_c, costs, certified, par_success = jax.lax.cond(
                    s["use_defect"], defect_ls, exact_ls, None)
            else:
                X_c, U_c, costs = linesearch_rollouts_smart(
                    system, x0, alphas, s["X"], s["U"], u_ff, K,
                    u_limits=config.limit_arrays(n_u, U_init.dtype),
                )
                certified = jnp.ones_like(costs, dtype=bool)
                par_success = jnp.asarray(True)
            use_defect_next = s["use_defect"] & par_success
            accept = (costs <= s["cost"]) & jnp.isfinite(costs) & bp_ok & certified
            any_accept = jnp.any(accept)
            # First improving α — same order as the reference backtracking loop.
            idx = jnp.argmax(accept)

            def accepted(s):
                k = s["k"]
                X_new, U_new = X_c[idx], U_c[idx]
                new_cost = costs[idx]
                reg = s["reg"] / config.reg_factor if config.adaptive_reg else s["reg"]
                if config.adaptive_reg:
                    reg = jnp.maximum(reg, 0.0)
                return {
                    **s,
                    "X": X_new,
                    "U": U_new,
                    "u_ff": u_ff,
                    "K": K,
                    "prev_cost": s["cost"],
                    "cost": new_cost,
                    "reg": reg,
                    "k": k + 1,
                    "cost_trace": s["cost_trace"].at[k].set(new_cost),
                    "alpha_trace": s["alpha_trace"].at[k].set(alphas[idx]),
                    "grad_trace": s["grad_trace"].at[k].set(jnp.max(jnp.abs(u_ff))),
                    "use_defect": use_defect_next,
                }

            def rejected(s):
                if config.adaptive_reg:
                    # Escalate regularization and retry (consumes an iteration);
                    # give up once reg exceeds the cap.
                    new_reg = jnp.maximum(s["reg"], 1e-6) * config.reg_factor
                    fail = new_reg > config.reg_max
                    return {
                        **s,
                        "reg": new_reg,
                        "k": s["k"] + 1,
                        "prev_cost": jnp.inf,  # don't trigger spurious convergence
                        "status": jnp.where(fail, LINESEARCH_FAILED, RUNNING),
                        "use_defect": use_defect_next,
                    }
                # Parity behavior: line-search failure stops the solve
                # (`iLQR_class.py:304-307`).
                return {**s, "status": jnp.asarray(LINESEARCH_FAILED)}

            return jax.lax.cond(any_accept, accepted, rejected, s)

        return jax.lax.cond(converged, mark_converged, iterate, s)

    s = jax.lax.while_loop(cond, body, init)
    status = jnp.where(
        (s["status"] == RUNNING) & (s["k"] >= config.maxiter),
        MAXITER,
        s["status"],
    )
    return IlqrSolution(
        X=s["X"], U=s["U"], cost=s["cost"], iterations=s["k"], status=status,
        u_ff=s["u_ff"], K=s["K"], cost_trace=s["cost_trace"],
        alpha_trace=s["alpha_trace"], grad_trace=s["grad_trace"],
        defect_latch=s["use_defect"],
    )
