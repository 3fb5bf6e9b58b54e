"""Time-varying reference tracking as a time-augmented ``System``.

The reference framework (and every model in it) supports only a FIXED target
state in the cost (`/root/reference/python/class_files/systems/pendulum_sys.py:77-98`).
Real MPC workloads track a time-varying reference trajectory (path following,
replanning around a nominal).  This module adds that capability without
touching the `stage_cost(params, x, u)` contract anywhere in the stack:

**the step index becomes part of the state.**  `make_tracking_system(base,
X_ref, U_ref, Q, R, Q_f)` returns a `System` with state `[x; k]` where the
clock `k` advances by exactly one per discrete step: for integrating schemes
dk/dt = 1/dt integrates to +1 exactly (all of them are exact on constant
derivatives); for `integrator='discrete'`, where f_cont IS the next-state
map, the clock is set to k+1 directly.  The quadratic tracking cost gathers
`X_ref[k]`, `U_ref[k]`
on-device.  Because the result IS a `System`, the whole stack composes
unchanged: solve / MPC / vmapped batches / constrained solves / parallel
backward passes.  In receding-horizon MPC the clock in the plant state
advances every sim step, so the solver's reference window shifts
automatically — no host-side bookkeeping.

Device notes: the gather `X_ref[k]` is a dynamic-slice of an (N+1, n_x) array —
vmappable and cheap; the clock is f32 (exact integers to 2^24, far beyond any
horizon here); index gradients are cut with `stop_gradient` + int cast so the
cost expansion sees the reference as locally constant (piecewise-constant in
k), keeping l_x/l_xx exactly the fixed-target expressions evaluated at the
current reference point.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.tree_util import Partial

from ilqr_tpu.models.base import System, matvec, quad_form


def _ref_index(params, x):
    k = jax.lax.stop_gradient(x[-1])
    n_ref = params["X_ref"].shape[0]
    return jnp.clip(jnp.round(k).astype(jnp.int32), 0, n_ref - 1)


def f_cont(params, x, u):
    xdot = params["base_f"](params["base"], x[:-1], u)
    clock = jnp.ones((1,), dtype=x.dtype) / params["dt"]
    return jnp.concatenate([xdot, clock])


def f_discrete(params, x, u):
    # Under integrator='discrete' the "continuous" function IS the next-state
    # map (ops/integrators.py::step), so the clock must be SET to k+1 here —
    # the dk/dt = 1/dt rate form would overwrite it with the constant 1/dt.
    x_next = params["base_f"](params["base"], x[:-1], u)
    return jnp.concatenate([x_next, x[-1:] + 1.0])


def stage_cost(params, x, u):
    i = _ref_index(params, x)
    i_u = jnp.minimum(i, params["U_ref"].shape[0] - 1)
    dx = x[:-1] - params["X_ref"][i]
    du = u - params["U_ref"][i_u]
    return 0.5 * (quad_form(dx, params["Q"]) + quad_form(du, params["R"])) * params["dt"]


def terminal_cost(params, x):
    dx = x[:-1] - params["X_ref"][-1]
    return 0.5 * quad_form(dx, params["Q_f"])


def make_tracking_system(base: System, X_ref, U_ref, Q, R, Q_f) -> System:
    """Wrap ``base`` with a quadratic time-varying tracking cost.

    X_ref: (N_ref+1, n_x) reference states; U_ref: (N_ref, n_u) reference
    controls (zeros for pure state tracking).  The returned system has
    ``n_x = base.n_x + 1`` (trailing clock dimension); use `augment_x0` /
    `strip_clock` at the boundary.
    """
    params = dict(
        base=base.params,
        base_f=Partial(base.f_cont),
        X_ref=jnp.asarray(X_ref),
        U_ref=jnp.asarray(U_ref),
        Q=jnp.asarray(Q),
        R=jnp.asarray(R),
        Q_f=jnp.asarray(Q_f),
        dt=base.dt,
    )
    return System(
        params=params,
        n_x=base.n_x + 1,
        n_u=base.n_u,
        dt=base.dt,
        f_cont=f_discrete if base.integrator == "discrete" else f_cont,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        integrator=base.integrator,
        newton_iters=base.newton_iters,
    )


def augment_x0(x0, k0=0.0):
    """[x0; k0] — initial state for a tracking system (clock starts at k0)."""
    x0 = jnp.asarray(x0)
    return jnp.concatenate([x0, jnp.asarray([k0], dtype=x0.dtype)])


def strip_clock(X):
    """Drop the trailing clock dimension from states (any leading axes)."""
    return X[..., :-1]
