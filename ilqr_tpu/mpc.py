"""Receding-horizon MPC — warm-started iLQR per step, fully on-device.

Loop semantics mirror the reference MPC drivers
(`/root/reference/python/run_iLQR_MPC.py:116-140`): at each simulated step,
solve the horizon problem from the current state with a small iteration
budget, apply only the first control, step a (possibly different) plant model,
and shift-and-hold the solution as the next warm start
(`U_guess = concat(U[1:], U[-1:])`, `run_iLQR_MPC.py:137`).

Differences from the reference:
* the entire simulation loop is one `lax.scan` — zero host round-trips for an
  N_sim-step closed-loop run (the reference re-enters Python per step);
* solver/plant model mismatch is first-class: two `System` pytrees (the
  reference builds two instances with different integrators,
  `run_iLQR_MPC.py:58-75`);
* `run_mpc_batched` vmaps the whole closed loop over a batch of initial
  states and shards the batch axis over a device mesh
  (`ilqr_tpu.parallel.batch`) — the BASELINE.json "4096 vmapped MPC
  instances" config.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.solver import IlqrConfig, solve


# Steps to keep the parallel line search disabled after a certification
# failure before re-probing it (see run_mpc's cooldown carry).  Default 0 =
# re-probe every solve: the in-solve latch already bounds the fallback cost
# to once per solve, while a carried latch forces the slower exact line
# search onto healthy solves after every transient failure.  Set >0 only
# for workloads where certification failures are persistent runs, not
# interspersed.
_LATCH_COOLDOWN = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MpcResult:
    X: Any           # (N_sim+1, n_x) closed-loop state trajectory
    U: Any           # (N_sim, n_u) applied controls
    cost: Any        # scalar: accumulated true plant stage cost + terminal
    solve_iters: Any  # (N_sim,) iLQR iterations used per step
    solve_status: Any  # (N_sim,) per-step solver status


@f32_matmuls
def run_mpc(
    solver_system: System,
    plant_system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
) -> MpcResult:
    """Closed-loop MPC simulation. U_init: (N_horizon, n_u) first warm start."""

    def mpc_step(carry, _):
        x, U_warm, cooldown = carry
        sol = solve(solver_system, x, U_warm, config,
                    defect_latch=cooldown == 0)
        u0 = sol.U[0]
        x_next = step(plant_system, x, u0)
        # Shift-and-hold warm start (`run_iLQR_MPC.py:137`).
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
        c = plant_system.stage_cost(plant_system.params, x, u0)
        # Certification-failure cooldown in the scan carry: a solve whose
        # parallel line search tripped to the exact fallback disables the
        # parallel path for the next _LATCH_COOLDOWN steps, then re-probes.
        cooldown_next = jnp.where(
            sol.defect_latch, jnp.zeros_like(cooldown),
            jnp.where(cooldown == 0, _LATCH_COOLDOWN, cooldown - 1))
        return (x_next, U_next, cooldown_next), (
            x, u0, c, sol.iterations, sol.status)

    (x_N, _, _), (X_head, U, cs, iters, status) = jax.lax.scan(
        mpc_step, (x0, U_init, jnp.asarray(0)), None, length=n_sim
    )
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return MpcResult(X=X, U=U, cost=cost, solve_iters=iters, solve_status=status)


@f32_matmuls
def run_mpc_rti(
    solver_system: System,
    plant_system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    resolve_every: int = 1,
) -> MpcResult:
    """Real-time-iteration MPC: re-solve every ``resolve_every`` steps and
    track the current plan with its own time-varying gains in between
    (``u = u_plan + K (x − x_plan)``) — the standard trick for meeting
    control rates faster than the solver.

    No reference counterpart (the reference re-solves at every step,
    `run_iLQR_MPC.py:116-140`); ``resolve_every=1`` reduces to `run_mpc`'s
    behavior with feedback applied from the same solve.  ``n_sim`` must be
    divisible by ``resolve_every``.
    """
    if n_sim % resolve_every != 0:
        raise ValueError(
            f"n_sim={n_sim} not divisible by resolve_every={resolve_every}")
    n_outer = n_sim // resolve_every
    limits = config.limit_arrays(U_init.shape[-1], U_init.dtype)

    def outer(carry, _):
        x, U_warm, cooldown = carry
        sol = solve(solver_system, x, U_warm, config,
                    defect_latch=cooldown == 0)

        def inner(x, j):
            u = sol.U[j] + matvec_(sol.K[j], x - sol.X[j])
            if limits is not None:
                u = jnp.clip(u, limits[0], limits[1])
            c = plant_system.stage_cost(plant_system.params, x, u)
            x1 = step(plant_system, x, u)
            return x1, (x, u, c)

        x_end, (Xs, Us, cs) = jax.lax.scan(
            inner, x, jnp.arange(resolve_every))
        # Shift-and-hold warm start by the executed block length.
        U_next = jnp.concatenate(
            [sol.U[resolve_every:],
             jnp.broadcast_to(sol.U[-1], (resolve_every,) + sol.U[-1].shape)],
            axis=0)
        cooldown_next = jnp.where(
            sol.defect_latch, jnp.zeros_like(cooldown),
            jnp.where(cooldown == 0, _LATCH_COOLDOWN, cooldown - 1))
        return (x_end, U_next, cooldown_next), (
            Xs, Us, cs, sol.iterations, sol.status)

    matvec_ = lambda M, v: M @ v
    (x_N, _, _), (Xs, Us, cs, iters, status) = jax.lax.scan(
        outer, (x0, U_init, jnp.asarray(0)), None, length=n_outer)
    X_head = Xs.reshape((-1,) + Xs.shape[2:])
    U = Us.reshape((-1,) + Us.shape[2:])
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return MpcResult(X=X, U=U, cost=cost, solve_iters=iters,
                     solve_status=status)


@f32_matmuls
def run_mpc_batched(
    solver_system: System,
    plant_system: System,
    x0_batch: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
) -> MpcResult:
    """vmap the full closed loop over a batch of initial states.

    x0_batch: (B, n_x).  Every per-instance quantity gains a leading B axis.
    Shard the batch axis over a mesh with
    `ilqr_tpu.parallel.batch.shard_batch` before calling for multi-chip runs.
    """
    return jax.vmap(
        lambda x0: run_mpc(solver_system, plant_system, x0, U_init, n_sim,
                           config)
    )(x0_batch)


@f32_matmuls
def run_mpc_ms(
    solver_system: System,
    plant_system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    ms=None,
) -> MpcResult:
    """Closed-loop MPC on the multiple-shooting solver (`ilqr_tpu.shooting`).

    Same receding-horizon semantics as `run_mpc`, but BOTH the controls and
    the state nodes are shift-and-hold warm starts:

        U_next = concat(U[1:], U[-1:]),  X_next = concat(X[1:], X[-1:]).

    The shifted plan is dynamically infeasible at the new plant state (its
    first node is last step's prediction, not the measured x), which single
    shooting must repair with a full nonlinear re-rollout; `solve_ms` instead
    takes it verbatim — the mismatch is just one more defect the Gauss-Newton
    step closes.  This is the standard shifted-primal warm start of
    multiple-shooting MPC (e.g. acados/GNMS practice).  No reference
    counterpart (the reference MPC shifts controls only,
    `run_iLQR_MPC.py:137`).

    With ``config.maxiter=1`` this is a real-time iteration: one GNMS
    iteration per step has NO nonlinear rollout anywhere (the shifted-plan
    mismatch is a defect, the update pass is affine), so with
    ``backward='pscan'`` and ``MsConfig(update_engine='xla')`` the whole
    step is vmapped evaluations plus two O(log H) scans.
    """
    from ilqr_tpu.ops.rollout import rollout
    from ilqr_tpu.shooting import MsConfig, solve_ms

    if ms is None:
        ms = MsConfig()
    X_init, _ = rollout(solver_system, x0, U_init)

    def mpc_step(carry, _):
        x, U_warm, X_warm = carry
        sol = solve_ms(solver_system, x, U_warm, X_init=X_warm, config=config,
                       ms=ms)
        u0 = sol.U[0]
        x_next = step(plant_system, x, u0)
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
        X_next = jnp.concatenate([sol.X[1:], sol.X[-1:]], axis=0)
        c = plant_system.stage_cost(plant_system.params, x, u0)
        return (x_next, U_next, X_next), (x, u0, c, sol.iterations, sol.status)

    (x_N, _, _), (X_head, U, cs, iters, status) = jax.lax.scan(
        mpc_step, (x0, U_init, X_init), None, length=n_sim
    )
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return MpcResult(X=X, U=U, cost=cost, solve_iters=iters, solve_status=status)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConstrainedMpcResult:
    X: Any             # (N_sim+1, n_x) closed-loop state trajectory
    U: Any             # (N_sim, n_u) applied controls
    cost: Any          # scalar: accumulated true plant stage cost + terminal
    violation: Any     # (N_sim,) per-step max constraint violation at the plan
    solve_iters: Any   # (N_sim,) inner iLQR iterations used per step
    solve_status: Any  # (N_sim,) per-step solver status


@f32_matmuls
def run_mpc_constrained(
    solver_system: System,
    plant_system: System,
    constraints,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    al_config=None,
) -> ConstrainedMpcResult:
    """Receding-horizon MPC with general constraints (augmented Lagrangian).

    Greenfield capability (the reference MPC is unconstrained,
    `run_iLQR_MPC.py:116-140`).  Per step the AL solver runs with a small
    budget and is warm-started on BOTH the shifted controls and the SHIFTED
    MULTIPLIERS + penalty from the previous step — across steps the
    multipliers converge, so a per-step `AlConfig(max_outer=2..3)` reaches
    violations a cold-started solve would need the full outer loop for
    (the ALTRO-MPC pattern, Nguyen et al. 2020).  One `lax.scan` over the
    simulation — zero host round-trips; vmap-able like `run_mpc`.
    """
    from ilqr_tpu.constrained import AlConfig, solve_constrained

    if al_config is None:
        al_config = AlConfig(max_outer=3, ctol=1e-3)

    def shift(lam):   # shift stage multipliers with the horizon, hold last
        return jnp.concatenate([lam[1:], lam[-1:]], axis=0)

    def mpc_step(carry, _):
        x, U_warm, lams, mu = carry
        sol = solve_constrained(
            solver_system, constraints, x, U_warm, config, al_config,
            lam_init=lams, mu_init=mu)
        u0 = sol.U[0]
        x_next = step(plant_system, x, u0)
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
        lams_next = dict(
            gi=shift(sol.lam_stage_ineq), he=shift(sol.lam_stage_eq),
            gti=sol.lam_terminal_ineq, hte=sol.lam_terminal_eq)
        c = plant_system.stage_cost(plant_system.params, x, u0)
        out = (x, u0, c, sol.violation, sol.inner_iterations, sol.status)
        return (x_next, U_next, lams_next, sol.mu), out

    # Trace multiplier shapes once for the scan carry (cold start).
    sol0_shape = jax.eval_shape(
        lambda: solve_constrained(solver_system, constraints, x0, U_init,
                                  config, al_config))
    dtype = U_init.dtype
    lams0 = dict(
        gi=jnp.zeros(sol0_shape.lam_stage_ineq.shape, dtype),
        he=jnp.zeros(sol0_shape.lam_stage_eq.shape, dtype),
        gti=jnp.zeros(sol0_shape.lam_terminal_ineq.shape, dtype),
        hte=jnp.zeros(sol0_shape.lam_terminal_eq.shape, dtype))
    mu0 = jnp.asarray(al_config.mu0, dtype)

    (x_N, _, _, _), (X_head, U, cs, viols, iters, status) = jax.lax.scan(
        mpc_step, (x0, U_init, lams0, mu0), None, length=n_sim)
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return ConstrainedMpcResult(X=X, U=U, cost=cost, violation=viols,
                                solve_iters=iters, solve_status=status)


@f32_matmuls
def run_mpc_barrier(
    solver_system: System,
    plant_system: System,
    constraints,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    mu: float = 1e-2,
    delta: float = 0.05,
) -> ConstrainedMpcResult:
    """Relaxed-barrier MPC: FIXED (μ, δ) every step (Feller & Ebenbauer 2017).

    No central path in the loop — each step solves ONE smooth barrier-
    penalized problem from the shifted warm start, giving a constant,
    predictable per-step latency (ideal for real-time control).  The fixed
    relaxed barrier makes the closed loop anti-windup by construction:
    infeasible states get finite costs and the controller steers back to the
    interior.  Accepts any backward backend in `config` (the penalty is C²).
    """
    from ilqr_tpu.barrier import BarrierConfig, solve_barrier

    bc = BarrierConfig(n_outer=1, mu0=mu, delta=delta, delta_factor=1.0)

    def mpc_step(carry, _):
        x, U_warm = carry
        sol = solve_barrier(solver_system, constraints, x, U_warm, config, bc)
        u0 = sol.U[0]
        x_next = step(plant_system, x, u0)
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
        c = plant_system.stage_cost(plant_system.params, x, u0)
        out = (x, u0, c, sol.violation, sol.inner_iterations, sol.status)
        return (x_next, U_next), out

    (x_N, _), (X_head, U, cs, viols, iters, status) = jax.lax.scan(
        mpc_step, (x0, U_init), None, length=n_sim)
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return ConstrainedMpcResult(X=X, U=U, cost=cost, violation=viols,
                                solve_iters=iters, solve_status=status)
