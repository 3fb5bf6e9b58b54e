"""Trajectory-wide dynamics linearization and cost quadratization.

The reference evaluates the seven backward-pass derivative matrices *inside*
the sequential Riccati scan, one timestep at a time
(`/root/reference/python/class_files/iLQR_class.py:96-97,318-331`).  Here the
entire derivative surface is computed in a single vmapped evaluation over the
whole trajectory: the linearization stage becomes embarrassingly parallel over
time (and over problem batches), leaving only the Riccati algebra sequential.
This turns N tiny serial AD evaluations into one large batched program.

Layout convention (time-major):
    X: (N+1, n_x)    U: (N, n_u)
All stacked derivative arrays lead with the time axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.integrators import step


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrajectoryExpansion:
    """Stacked first/second-order expansion of dynamics and cost along (X, U).

    Shapes (N = horizon length):
        f_x:  (N, n_x, n_x)    f_u:  (N, n_x, n_u)
        l_x:  (N, n_x)         l_u:  (N, n_u)
        l_xx: (N, n_x, n_x)    l_ux: (N, n_u, n_x)   l_uu: (N, n_u, n_u)
        v_x:  (n_x,)           v_xx: (n_x, n_x)      (terminal cost expansion)
    """

    f_x: Any
    f_u: Any
    l_x: Any
    l_u: Any
    l_xx: Any
    l_ux: Any
    l_uu: Any
    v_x: Any
    v_xx: Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DynamicsHessians:
    """Second-order dynamics terms for full DDP (no reference counterpart —
    the reference solver is Gauss-Newton iLQR only, `iLQR_class.py:100-104`).

    Index convention: ``f_xx[k, i, a, b] = ∂²f_i/∂x_a∂x_b`` at step k, etc.

    Shapes: f_xx (N, n_x, n_x, n_x), f_ux (N, n_x, n_u, n_x),
    f_uu (N, n_x, n_u, n_u).
    """

    f_xx: Any
    f_ux: Any
    f_uu: Any


@f32_matmuls
def dynamics_hessians(system: System, X: jnp.ndarray, U: jnp.ndarray
                      ) -> DynamicsHessians:
    """Second derivatives of the discrete step along the trajectory, vmapped
    over time (forward-over-forward AD; n_x ≤ O(10) keeps this cheap)."""
    f = lambda xx, uu: step(system, xx, uu)

    def stage(x, u):
        f_xx = jax.jacfwd(jax.jacfwd(f, argnums=0), argnums=0)(x, u)
        f_ux = jax.jacfwd(jax.jacfwd(f, argnums=1), argnums=0)(x, u)
        f_uu = jax.jacfwd(jax.jacfwd(f, argnums=1), argnums=1)(x, u)
        # jacfwd(jacfwd(f, 1), 0) yields ∂²f/∂x∂u with axes (i, u, x) already.
        return f_xx, f_ux, f_uu

    f_xx, f_ux, f_uu = jax.vmap(stage)(X[:-1], U)
    return DynamicsHessians(f_xx=f_xx, f_ux=f_ux, f_uu=f_uu)


def _stage_expansion(system: System, x, u):
    """All seven per-step derivative blocks in one fused evaluation.

    Derivative definitions follow the reference AD factory
    (`system_base.py:203-216`): f_x/f_u by forward-mode on the discrete step,
    l_x/l_u by gradient, l_xx/l_uu by Hessian, l_ux = d/dx (dl/du).
    """
    f = lambda xx, uu: step(system, xx, uu)
    l = lambda xx, uu: system.stage_cost(system.params, xx, uu)

    f_x = jax.jacfwd(f, argnums=0)(x, u)
    f_u = jax.jacfwd(f, argnums=1)(x, u)
    l_x = jax.grad(l, argnums=0)(x, u)
    l_u = jax.grad(l, argnums=1)(x, u)
    l_xx = jax.hessian(l, argnums=0)(x, u)
    l_uu = jax.hessian(l, argnums=1)(x, u)
    l_ux = jax.jacfwd(jax.grad(l, argnums=1), argnums=0)(x, u)
    return f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu


@f32_matmuls
def linearize_trajectory(system: System, X: jnp.ndarray, U: jnp.ndarray) -> TrajectoryExpansion:
    """Expand dynamics/cost along a nominal trajectory, vmapped over time.

    X: (N+1, n_x), U: (N, n_u).
    """
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = jax.vmap(
        lambda x, u: _stage_expansion(system, x, u)
    )(X[:-1], U)

    lf = lambda xx: system.terminal_cost(system.params, xx)
    v_x = jax.grad(lf)(X[-1])
    v_xx = jax.hessian(lf)(X[-1])
    return TrajectoryExpansion(
        f_x=f_x, f_u=f_u, l_x=l_x, l_u=l_u,
        l_xx=l_xx, l_ux=l_ux, l_uu=l_uu, v_x=v_x, v_xx=v_xx,
    )


# ---------------------------------------------------------------------------
# Batched linearization: under vmap(solve) the per-instance jacobians would
# come out as rank-4 (B, N, n, n) arrays with the tiny (n, n) matrices on
# the minor dims.  Flattening (B, N) into ONE point axis gives the batched
# path the same rank-3 program as a single trajectory.
# ---------------------------------------------------------------------------

from jax.custom_batching import custom_vmap


@custom_vmap
def linearize_trajectory_smart(system: System, X: jnp.ndarray,
                               U: jnp.ndarray) -> TrajectoryExpansion:
    """`linearize_trajectory` whose vmap flattens (B, N) into one axis."""
    return linearize_trajectory(system, X, U)


@linearize_trajectory_smart.def_vmap
def _linearize_smart_vmap(axis_size, in_batched, system, X, U):
    sys_b, Xb, Ub = in_batched
    out_batched = TrajectoryExpansion(*([True] * 9))
    if any(jax.tree_util.tree_leaves(sys_b)) or not (Xb and Ub):
        axes = tuple(jax.tree_util.tree_map(lambda b: 0 if b else None, b_)
                     for b_ in in_batched)
        return (jax.vmap(linearize_trajectory, in_axes=axes)(system, X, U),
                out_batched)
    B, _, n_x = X.shape
    N = U.shape[1]
    xf = X[:, :-1].reshape(B * N, n_x)
    uf = U.reshape(B * N, U.shape[-1])
    leaves = jax.vmap(lambda x, u: _stage_expansion(system, x, u))(xf, uf)
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = (
        a.reshape((B, N) + a.shape[1:]) for a in leaves)
    lf = lambda xx: system.terminal_cost(system.params, xx)
    v_x = jax.vmap(jax.grad(lf))(X[:, -1])
    v_xx = jax.vmap(jax.hessian(lf))(X[:, -1])
    return TrajectoryExpansion(
        f_x=f_x, f_u=f_u, l_x=l_x, l_u=l_u, l_xx=l_xx, l_ux=l_ux,
        l_uu=l_uu, v_x=v_x, v_xx=v_xx), out_batched
