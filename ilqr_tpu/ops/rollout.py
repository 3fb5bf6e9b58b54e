"""Forward rollouts: nominal, closed-loop, and batched line-search.

Semantics match the reference forward pass
(`/root/reference/python/class_files/iLQR_class.py:164-247`):
    u_k = u_old_k + α·u_ff_k + K_k (x_k − x_old_k)
    x_{k+1} = f(x_k, u_k),   cost += l(x_k, u_k),  + l_f(x_N) at the end.

Device-side addition: `linesearch_rollouts` evaluates the *entire* α schedule
as one vmapped rollout batch instead of the reference's host-side backtracking
loop with a device sync per probe (`iLQR_class.py:281-301`).  Selecting the
first improving α from the batch reproduces the reference's
accept-first-improving semantics exactly (the schedule order is preserved)
while costing a single device program.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.custom_batching import custom_vmap

from ilqr_tpu.models.base import System, f32_matmuls, unrolled_smallmath
from ilqr_tpu.ops.integrators import step


@f32_matmuls
def rollout(system: System, x0: jnp.ndarray, U: jnp.ndarray):
    """Open-loop rollout of a control sequence. Returns X: (N+1, n_x), cost."""

    def body(carry, u):
        x, c = carry
        c = c + system.stage_cost(system.params, x, u)
        x1 = step(system, x, u)
        return (x1, c), x

    (x_N, cost), X_head = jax.lax.scan(body, (x0, 0.0), U)
    cost = cost + system.terminal_cost(system.params, x_N)
    X = jnp.concatenate([X_head, x_N[None]], axis=0)
    return X, cost


@f32_matmuls
def closed_loop_rollout(
    system: System,
    x0: jnp.ndarray,
    alpha: jnp.ndarray,
    X_old: jnp.ndarray,
    U_old: jnp.ndarray,
    u_ff: jnp.ndarray,
    K: jnp.ndarray,
    u_limits=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-loop line-search rollout. Time-major: X_old (N+1,n_x), U_old (N,n_u),
    u_ff (N,n_u), K (N,n_u,n_x). Returns (X_new, U_new, cost).

    ``u_limits`` = (lo, hi) clips each applied control to hard box limits
    (control-limited iLQR — see ops/boxqp.py; no reference counterpart)."""

    def body(carry, inp):
        x, c = carry
        x_old, u_old, uff_k, K_k = inp
        u = u_old + alpha * uff_k + K_k @ (x - x_old)
        if u_limits is not None:
            u = jnp.clip(u, u_limits[0], u_limits[1])
        c = c + system.stage_cost(system.params, x, u)
        x1 = step(system, x, u)
        return (x1, c), (x, u)

    (x_N, cost), (X_head, U_new) = jax.lax.scan(
        body, (x0, 0.0), (X_old[:-1], U_old, u_ff, K)
    )
    cost = cost + system.terminal_cost(system.params, x_N)
    X_new = jnp.concatenate([X_head, x_N[None]], axis=0)
    return X_new, U_new, cost


@f32_matmuls
def linesearch_rollouts(system, x0, alphas, X_old, U_old, u_ff, K,
                        u_limits=None):
    """Roll out every α in the schedule as one vmapped batch.

    Returns (X_cands, U_cands, costs) with a leading α axis.
    """
    return jax.vmap(
        lambda a: closed_loop_rollout(system, x0, a, X_old, U_old, u_ff, K,
                                      u_limits)
    )(alphas)


# ---------------------------------------------------------------------------
# custom_vmap wrappers: the single-instance primal is the plain sequential
# engine; the vmap rule traces the batched program under
# `unrolled_smallmath`, which keeps every model intermediate at the batch
# shape instead of materializing (B, n, n) broadcast products.  The solver
# calls these, so `vmap(solve)` (solve_batched, run_mpc_batched) picks the
# batched trace up without a flag.
# ---------------------------------------------------------------------------


def _batched_axes(in_batched):
    return tuple(jax.tree_util.tree_map(lambda b: 0 if b else None, b_)
                 for b_ in in_batched)


@custom_vmap
def linesearch_rollouts_smart(system: System, x0, alphas, X_old, U_old,
                              u_ff, K, u_limits=None):
    """`linesearch_rollouts` whose vmap traces under `unrolled_smallmath`."""
    return linesearch_rollouts(system, x0, alphas, X_old, U_old, u_ff, K,
                               u_limits=u_limits)


@linesearch_rollouts_smart.def_vmap
def _ls_rollouts_smart_vmap(axis_size, in_batched, system, x0, alphas,
                            X_old, U_old, u_ff, K, u_limits=None):
    with unrolled_smallmath():
        out = jax.vmap(
            lambda s, x, a, X, U, f, k, ul: linesearch_rollouts(
                s, x, a, X, U, f, k, u_limits=ul),
            in_axes=_batched_axes(in_batched))(
                system, x0, alphas, X_old, U_old, u_ff, K, u_limits)
    return out, (True, True, True)


@custom_vmap
def rollout_flagged(system: System, x0, U):
    """`rollout` whose vmap traces under `unrolled_smallmath`."""
    return rollout(system, x0, U)


@rollout_flagged.def_vmap
def _rollout_flagged_vmap(axis_size, in_batched, system, x0, U):
    with unrolled_smallmath():
        out = jax.vmap(rollout, in_axes=_batched_axes(in_batched))(
            system, x0, U)
    return out, (True, True)


@functools.lru_cache(maxsize=None)
def _open_loop_init_smart(iters: int, tol: float):
    @custom_vmap
    def init_rollout(system: System, x0, U):
        """Solver init rollout for init_rollout='defect'.

        Single instance: parallel-in-time Newton sweeps with the sequential
        rollout as the fallback when certification fails.  Under
        vmap(solve) the rule below uses the plain batched rollout instead:
        the cond would lower to a select and execute BOTH branches per
        instance.
        """
        from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout

        X_p, c_p, defect = open_loop_defect_rollout(
            system, x0, U, iters=iters, exit_tol=1e-3 * tol)
        return jax.lax.cond(
            defect < tol,
            lambda: (X_p, c_p),
            lambda: rollout(system, x0, U),
        )

    @init_rollout.def_vmap
    def _rule(axis_size, in_batched, system, x0, U):
        return _rollout_flagged_vmap(axis_size, in_batched, system, x0, U)

    return init_rollout


def open_loop_init_smart(system: System, x0, U, iters, tol):
    """Defect-engine initial rollout (X, cost); see `_open_loop_init_smart`."""
    return _open_loop_init_smart(int(iters), float(tol))(system, x0, U)
