"""Discrete-time step functions from continuous dynamics.

Capability parity with the reference integrator set
(`/root/reference/python/class_files/systems/system_base.py:50-198`):
explicit Euler (RK1), explicit midpoint (RK2, ZOH), RK4 (ZOH), and implicit
backward Euler.

Differences from the reference:

* The backward-Euler Newton solve uses a **fixed iteration count**
  (``system.newton_iters``) instead of a tolerance-gated ``lax.while_loop``
  (reference `system_base.py:105-139`).  Fixed trip counts keep the step
  identical across a vmapped batch (no divergent control flow), which is what
  lets the whole solver vmap over thousands of MPC instances and lower cleanly
  to an accelerator.  Like the reference, it is a quasi-Newton iteration: the Jacobian
  ``I - dt*J`` is evaluated once at the forward-Euler predictor and LU-factored
  once (`system_base.py:129-135`), then reused for every correction step.

* Jacobians of the implicit step come from a ``jax.custom_jvp`` rule that
  applies the implicit-function theorem, so ``jax.jacfwd(step)`` is exact and
  cheap — subsuming the reference's hand-written `_be_f_x_fcn`/`_be_f_u_fcn`
  (`system_base.py:146-195`) without special-casing the AD surface.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from ilqr_tpu.ops.smallmat import inv_small, solve_small

from ilqr_tpu.models.base import System


def _euler(f_cont, params, dt, x, u):
    return x + dt * f_cont(params, x, u)


def _midpoint(f_cont, params, dt, x, u):
    k1 = f_cont(params, x, u)
    k2 = f_cont(params, x + 0.5 * dt * k1, u)
    return x + dt * k2


def _rk4(f_cont, params, dt, x, u):
    k1 = f_cont(params, x, u)
    k2 = f_cont(params, x + 0.5 * dt * k1, u)
    k3 = f_cont(params, x + 0.5 * dt * k2, u)
    k4 = f_cont(params, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@partial(jax.custom_jvp, nondiff_argnums=(0, 1, 2))
def _backward_euler(f_cont, dt, newton_iters, params, x, u):
    """Solve x1 = x + dt*f_cont(x1, u) by quasi-Newton with a stale LU factor."""

    def residual(x1):
        return x1 - x - dt * f_cont(params, x1, u)

    # Forward-Euler predictor (reference `system_base.py:124`).
    x1 = x + dt * f_cont(params, x, u)
    # Stale Jacobian at the predictor, factored once.
    J = jnp.eye(x.shape[-1], dtype=x.dtype) - dt * jax.jacfwd(
        lambda z: f_cont(params, z, u)
    )(x1)
    # Closed-form inverse of the tiny stale Jacobian, computed once and
    # reused every correction (replaces the reference's LU factor+solve,
    # a pivoted-LU path that does not vectorize over the batch).
    Ji = inv_small(J)

    def body(_, x1):
        return x1 - (Ji @ residual(x1)[..., None])[..., 0]

    return jax.lax.fori_loop(0, newton_iters, body, x1)


@_backward_euler.defjvp
def _backward_euler_jvp(f_cont, dt, newton_iters, primals, tangents):
    """IFT tangent rule: (I - dt*J_x(x1)) dx1 = dx + dt*J_u(x1) du + dt*(df)(x1).

    Evaluated at the converged solution, so jacfwd through the step reproduces
    the reference's analytic `_be_f_x_fcn`/`_be_f_u_fcn` exactly
    (`system_base.py:146-188`) while also handling parameter tangents.
    """
    params, x, u = primals
    dparams, dx, du = tangents
    x1 = _backward_euler(f_cont, dt, newton_iters, params, x, u)

    g = lambda p, z, v: f_cont(p, z, v)
    J_x = jax.jacfwd(g, argnums=1)(params, x1, u)
    A = jnp.eye(x.shape[-1], dtype=x.dtype) - dt * J_x
    # Tangent of the residual wrt (params, u) at fixed x1.
    _, rhs_tan = jax.jvp(lambda p, v: g(p, x1, v), (params, u), (dparams, du))
    dx1 = solve_small(A, dx + dt * rhs_tan)
    return x1, dx1


@partial(jax.custom_jvp, nondiff_argnums=(0, 1, 2))
def _trapezoidal(f_cont, dt, newton_iters, params, x, u):
    """Solve x1 = x + dt/2*(f_cont(x,u) + f_cont(x1,u)) by quasi-Newton.

    Implicit trapezoidal rule (Crank-Nicolson): 2nd-order accurate and
    A-stable — same stiffness robustness as backward Euler
    (reference `system_base.py:88-140`) with one order higher accuracy.
    No reference counterpart; same fixed-iteration stale-inverse Newton
    machinery as `_backward_euler` so it vmaps/shards identically.
    """
    f0 = f_cont(params, x, u)

    def residual(x1):
        return x1 - x - 0.5 * dt * (f0 + f_cont(params, x1, u))

    # Explicit-Euler predictor, stale Jacobian factored once at the predictor.
    x1 = x + dt * f0
    J = jnp.eye(x.shape[-1], dtype=x.dtype) - 0.5 * dt * jax.jacfwd(
        lambda z: f_cont(params, z, u)
    )(x1)
    Ji = inv_small(J)

    def body(_, x1):
        return x1 - (Ji @ residual(x1)[..., None])[..., 0]

    return jax.lax.fori_loop(0, newton_iters, body, x1)


@_trapezoidal.defjvp
def _trapezoidal_jvp(f_cont, dt, newton_iters, primals, tangents):
    """IFT tangent rule at the converged solution:

    (I - dt/2*J_x(x1)) dx1 = dx + dt/2*(d f(x,u)) + dt/2*(d f(x1,u)|_{x1 fixed})
    """
    params, x, u = primals
    dparams, dx, du = tangents
    x1 = _trapezoidal(f_cont, dt, newton_iters, params, x, u)

    J_x1 = jax.jacfwd(lambda z: f_cont(params, z, u))(x1)
    A = jnp.eye(x.shape[-1], dtype=x.dtype) - 0.5 * dt * J_x1
    # Tangent of f at the left endpoint (depends on params, x, u)...
    _, d_f0 = jax.jvp(f_cont, (params, x, u), (dparams, dx, du))
    # ...and of f at the right endpoint with x1 held fixed (params, u only).
    _, d_f1 = jax.jvp(
        lambda p, v: f_cont(p, x1, v), (params, u), (dparams, du)
    )
    dx1 = solve_small(A, dx + 0.5 * dt * (d_f0 + d_f1))
    return x1, dx1


def step(system: System, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """One discrete dynamics step under the system's integrator."""
    f, p, dt = system.f_cont, system.params, system.dt
    name = system.integrator
    if name == "euler":
        return _euler(f, p, dt, x, u)
    if name == "midpoint":
        return _midpoint(f, p, dt, x, u)
    if name == "rk4":
        return _rk4(f, p, dt, x, u)
    if name == "backward_euler":
        return _backward_euler(f, dt, system.newton_iters, p, x, u)
    if name == "trapezoidal":
        return _trapezoidal(f, dt, system.newton_iters, p, x, u)
    if name == "discrete":
        # f_cont IS the discrete map x_{k+1} = F(x_k, u_k) — for exactly
        # discretized LTI systems (cont2disc output, mirroring the MATLAB
        # `Linear_iLQR_CLASS` driver `main_.m`), learned discrete models,
        # and discrete augmentations (control-rate wrapper, models/rate.py).
        return f(p, x, u)
    raise ValueError(f"Unknown integrator {name!r}")
