"""Nonlinear mass-spring-damper chain: a medium-dimension benchmark system.

``m`` masses on a line, nearest-neighbour linear springs (stiffness k,
fixed walls at both ends), per-mass damping c, a softening gravity-like
nonlinearity s·sin(qᵢ), and an actuator on every ``n_act``-th mass:

    q̈ᵢ = −k(2qᵢ − qᵢ₋₁ − qᵢ₊₁) − c·q̇ᵢ − s·sin(qᵢ) + (S u)ᵢ

State x = (q, q̇) ∈ R^{2m}, controls u ∈ R^{m/n_act}.  m=16 gives n_x=32 —
the dimension band (16, 64] where the recursive block-Schur inverse
(`ops/smallmat.py`) carries the associative scan's ('pscan') Riccati
algebra; m=32 gives n_x=64.  No reference counterpart (the
reference tops out at n_x=4, `double_pendulum_sys.py`).
"""
from __future__ import annotations

import jax.numpy as jnp

from ilqr_tpu.models.base import System, quadratic_cost_params


def _f_cont(params, x, u):
    m = params["q_target"].shape[0]
    q, qd = x[:m], x[m:]
    k, c, s = params["k"], params["c"], params["s"]
    # Fixed walls: q_0's left neighbour and q_{m-1}'s right neighbour are 0.
    left = jnp.concatenate([jnp.zeros((1,), x.dtype), q[:-1]])
    right = jnp.concatenate([q[1:], jnp.zeros((1,), x.dtype)])
    qdd = (-k * (2.0 * q - left - right) - c * qd - s * jnp.sin(q)
           + params["S"] @ u)
    return jnp.concatenate([qd, qdd])


def _stage_cost(params, x, u):
    m = params["q_target"].shape[0]
    dq = x[:m] - params["q_target"]
    return 0.5 * params["dt"] * (
        params["wq"] * jnp.sum(dq * dq)
        + params["wv"] * jnp.sum(x[m:] * x[m:])
        + params["wu"] * jnp.sum(u * u))


def _terminal_cost(params, x):
    m = params["q_target"].shape[0]
    dq = x[:m] - params["q_target"]
    return 0.5 * (params["wqf"] * jnp.sum(dq * dq)
                  + params["wvf"] * jnp.sum(x[m:] * x[m:]))


def make_spring_chain(dt: float, n_masses: int = 16, n_act: int = 1,
                      k: float = 10.0, c: float = 0.2, s: float = 3.0,
                      q_target=None, wq: float = 1.0, wv: float = 0.1,
                      wu: float = 0.01, wqf: float = 100.0,
                      wvf: float = 10.0, integrator: str = "rk4") -> System:
    """Build the chain; n_x = 2·n_masses, n_u = n_masses // n_act."""
    m = n_masses
    n_u = m // n_act
    S = jnp.zeros((m, n_u)).at[jnp.arange(n_u) * n_act,
                               jnp.arange(n_u)].set(1.0)
    if q_target is None:
        q_target = 0.5 * jnp.ones((m,))
    params = dict(
        dt=dt, k=jnp.asarray(k), c=jnp.asarray(c), s=jnp.asarray(s),
        S=S, q_target=jnp.asarray(q_target),
        wq=jnp.asarray(wq), wv=jnp.asarray(wv), wu=jnp.asarray(wu),
        wqf=jnp.asarray(wqf), wvf=jnp.asarray(wvf),
    )
    return System(params=params, n_x=2 * m, n_u=n_u, dt=dt,
                  f_cont=_f_cont, stage_cost=_stage_cost,
                  terminal_cost=_terminal_cost, integrator=integrator)
