"""Implicit differentiation through the converged iLQR solve.

The solver (`ilqr_tpu.solver.solve`) runs its outer loop in a
``lax.while_loop``, which JAX cannot reverse-differentiate — and unrolling
the loop for autodiff would be both memory-hungry and wrong in spirit (the
gradient of a *converged* solution should not depend on the path the solver
took).  ``solve_implicit`` instead attaches a ``jax.custom_vjp`` derived from
the implicit function theorem:

    At convergence the open-loop controls ``U*`` satisfy stationarity of the
    total trajectory cost,  G(U*, θ, x0) := ∇_U J(U*, θ, x0) = 0,  where
    J(U, θ, x0) is the cost of the open-loop rollout of U from x0 under
    system parameters θ.  Differentiating G = 0:

        dU*/dθ = −H⁻¹ · ∂G/∂θ,      H := ∇²_UU J  (PD at a strict minimum).

The VJP therefore needs one linear solve ``H z = ḡ_U`` per backward pass.
H is (N·n_u)² but never materialized: conjugate gradients with
Hessian-vector products (forward-over-reverse through the rollout, O(N) per
product and scan-parallel over time) keep the whole backward pass matrix-free
and device-friendly.  The envelope theorem falls out for free: differentiating
only the converged *cost* gives ḡ_U = ∇_U J = 0, so z = 0 and the gradient
reduces to the direct ∂J/∂θ term.

Gradients are defined w.r.t. ``system.params``, ``x0`` and flow through the
``X``, ``U`` and ``cost`` fields of the returned solution ONLY.  Cotangents
on the auxiliary fields (``u_ff``, ``K``, traces) are ignored, and ``U_init``
receives zero gradient (a converged solution does not depend on its
initialization within a basin).  Restricted to the smooth unconstrained
solve: control limits (boxQP) and AL constraints introduce non-smooth
stationarity conditions this VJP does not model (the relaxed log-barrier
path in ``ilqr_tpu.barrier`` is smooth but solves a *sequence* of problems;
differentiate its final fixed-(μ, δ) subproblem instead).

No reference counterpart — the reference solver is a host-side Python loop
(`/root/reference/python/class_files/iLQR_class.py:250-313`) with no notion
of differentiating through a solve.  Enables gradient-based inverse optimal
control, cost-weight auto-tuning, and system identification on device (see
`examples/inverse_optimal_control.py`).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.rollout import rollout
from ilqr_tpu.solver import IlqrConfig, IlqrSolution, solve


@dataclasses.dataclass(frozen=True)
class IftConfig:
    """Settings for the implicit-function-theorem backward pass (hashable)."""

    cg_iters: int = 100
    cg_tol: float = 1e-8
    # Tikhonov damping added to the Hessian (H + reg·I) in the CG solve.
    # At a strict local minimum H ≻ 0 and reg=0 is exact; a small positive
    # value stabilizes loosely-converged or nearly-singular problems at the
    # price of a slightly biased gradient.
    reg: float = 0.0


def _rollout_cost(static: System, params, x0, U):
    return rollout(static.replace(params=params), x0, U)[1]


def _grad_u(static: System, params, x0, U):
    """G(U, θ, x0) = ∇_U J — the stationarity residual."""
    return jax.grad(_rollout_cost, argnums=3)(static, params, x0, U)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _solve_ift(static, config, ift, params, x0, U_init):
    return solve(static.replace(params=params), x0, U_init, config)


def _solve_ift_fwd(static, config, ift, params, x0, U_init):
    sol = _solve_ift(static, config, ift, params, x0, U_init)
    return sol, (params, x0, sol.U)


def _solve_ift_bwd(static, config, ift, res, cot):
    params, x0, U = res

    def _real(c, like):
        # Integer/trace cotangents arrive as float0 or zeros; keep only the
        # differentiable outputs.
        return None if (c is None or c.dtype == jax.dtypes.float0) else c

    w_X = _real(cot.X, None)
    w_c = _real(cot.cost, None)
    w_U = _real(cot.U, None)

    # Direct path: X* and cost* as functions of (θ, x0) with U held fixed,
    # plus their sensitivity to U (which feeds the implicit term).
    def outs(params, x0, U):
        X, cost = rollout(static.replace(params=params), x0, U)
        return X, cost

    zero_out = (jnp.zeros((U.shape[0] + 1, x0.shape[0]), x0.dtype),
                jnp.zeros((), x0.dtype))
    w_outs = (w_X if w_X is not None else zero_out[0],
              w_c if w_c is not None else zero_out[1])
    _, vjp_outs = jax.vjp(outs, params, x0, U)
    d_params, d_x0, g_U = vjp_outs(w_outs)
    if w_U is not None:
        g_U = g_U + w_U

    # Implicit path: H z = ḡ_U via matrix-free CG, then θ̄ += −(∂G/∂θ)ᵀ z.
    def hvp(v):
        h = jax.jvp(lambda u: _grad_u(static, params, x0, u), (U,), (v,))[1]
        return h + ift.reg * v if ift.reg else h

    z, _ = jax.scipy.sparse.linalg.cg(
        hvp, g_U, tol=ift.cg_tol, maxiter=ift.cg_iters
    )
    _, vjp_g = jax.vjp(lambda p, x: _grad_u(static, p, x, U), params, x0)
    dp_imp, dx0_imp = vjp_g(-z)

    params_bar = jax.tree.map(jnp.add, d_params, dp_imp)
    x0_bar = d_x0 + dx0_imp
    return params_bar, x0_bar, jnp.zeros_like(U)


_solve_ift.defvjp(_solve_ift_fwd, _solve_ift_bwd)


@f32_matmuls
def solve_implicit(
    system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    config: IlqrConfig = IlqrConfig(),
    ift: IftConfig = IftConfig(),
) -> IlqrSolution:
    """iLQR solve that is reverse-differentiable w.r.t. ``system.params``/``x0``.

    Forward pass is exactly ``solve(system, x0, U_init, config)``; the
    backward pass applies the implicit function theorem at the converged
    stationary point (see module docstring for scope and caveats).  Safe to
    ``jit``/``vmap``/``grad``; gradients flow through ``X``, ``U``, ``cost``.
    """
    if config.u_min is not None:
        raise ValueError(
            "solve_implicit requires the unconstrained solve; control limits "
            "change the stationarity condition (clamped arcs) in a way the "
            "IFT backward pass does not model"
        )
    static = system.replace(params=None)
    return _solve_ift(static, config, ift, system.params, x0, U_init)


@f32_matmuls
def run_mpc_implicit(
    solver_system: System,
    plant_system: System,
    x0: jnp.ndarray,
    U_init: jnp.ndarray,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    ift: IftConfig = IftConfig(),
):
    """Closed-loop MPC that is reverse-differentiable end to end.

    Same receding-horizon semantics as `ilqr_tpu.mpc.run_mpc` (shift-and-hold
    warm starts, solver/plant mismatch), but each per-step solve is
    ``solve_implicit`` — whose ``custom_vjp`` makes the whole simulation
    ``lax.scan`` reverse-differentiable.  Gradients of the CLOSED-LOOP cost
    (or any function of the closed-loop trajectory) w.r.t. the solver
    system's cost/physics parameters, the plant parameters, and ``x0`` are
    exact up to the per-solve IFT approximation — i.e. you can tune MPC
    weights against what actually matters: realized closed-loop performance
    under model mismatch.

    Note the warm-start chain: ``U_warm`` enters each solve with zero
    cotangent by the IFT (a converged solve does not depend on its
    initialization), so keep ``config.maxiter`` high enough that per-step
    solves actually converge — with very small iteration budgets the true
    solver output *does* depend on the warm start and the gradient becomes
    an approximation.

    Returns ``(X, U, cost)``: closed-loop states (n_sim+1, n_x), applied
    controls (n_sim, n_u), accumulated plant cost (+ terminal).
    """

    def mpc_step(carry, _):
        x, U_warm = carry
        sol = solve_implicit(solver_system, x, U_warm, config, ift)
        u0 = sol.U[0]
        x_next = step(plant_system, x, u0)
        U_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
        c = plant_system.stage_cost(plant_system.params, x, u0)
        return (x_next, U_next), (x, u0, c)

    (x_N, _), (X_head, U, cs) = jax.lax.scan(
        mpc_step, (x0, U_init), None, length=n_sim
    )
    cost = jnp.sum(cs) + plant_system.terminal_cost(plant_system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return X, U, cost
