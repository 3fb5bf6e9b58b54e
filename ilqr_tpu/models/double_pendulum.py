"""Double pendulum (fully-actuated and underactuated) in manipulator form.

Behavior parity with the reference pair
(`/root/reference/python/class_files/systems/double_pendulum_sys.py:84-205`,
`UA_double_pendulum_sys.py:84-208`): uniform rods (COM at l/2), joint inertias
θᵢ, joint damping dᵢ, angles measured from the hanging-down configuration,
M(q) q̈ = h(q, q̇, τ), q̈ by a dense 2×2 solve.  Instead of two near-duplicate
classes differing only in the actuation row, a single model takes an actuation
map S (n_q × n_u): S = I₂ is the fully-actuated system, S = [[1],[0]] the
underactuated one (only joint 1 driven, `UA_double_pendulum_sys.py:204`).

The equations of motion are the standard textbook planar 2R dynamics (the
reference derives the same ones symbolically in
`matlab/EoMs/double_pendulum_symbolic.m`).
"""
from __future__ import annotations

import jax.numpy as jnp

from ilqr_tpu.models.base import (
    System,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)


def f_cont(params, x, u):
    q1, q2, q1d, q2d = x[0], x[1], x[2], x[3]
    p = params
    m1, m2, l1, l2, g = p["m1"], p["m2"], p["l1"], p["l2"], p["g"]
    lc1, lc2 = 0.5 * l1, 0.5 * l2
    th1, th2 = p["theta1"], p["theta2"]

    c2, s2 = jnp.cos(q2), jnp.sin(q2)
    s1, s12 = jnp.sin(q1), jnp.sin(q1 + q2)

    # Mass matrix entries M(q) for uniform rods + joint inertias.
    m11 = th1 + th2 + m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2.0 * l1 * lc2 * c2)
    m12 = th2 + m2 * (lc2**2 + l1 * lc2 * c2)
    m22 = th2 + m2 * lc2**2

    # Generalized forces h = S τ − C(q,q̇)q̇ − G(q) − D q̇, componentwise
    # (scalar algebra only — no tiny batched dot_general ops under vmap).
    hc = m2 * l1 * lc2 * s2
    n_u = u.shape[-1] if u.ndim else 1
    tau1 = sum(p["S"][0, j] * u[..., j] for j in range(n_u))
    tau2 = sum(p["S"][1, j] * u[..., j] for j in range(n_u))
    h1 = (tau1 + hc * (2.0 * q1d * q2d + q2d**2)
          - g * ((m1 * lc1 + m2 * l1) * s1 + m2 * lc2 * s12) - p["d1"] * q1d)
    h2 = tau2 - hc * q1d**2 - g * m2 * lc2 * s12 - p["d2"] * q2d

    # q̈ = M⁻¹ h by the 2×2 adjugate.
    det = m11 * m22 - m12 * m12
    qdd1 = (m22 * h1 - m12 * h2) / det
    qdd2 = (m11 * h2 - m12 * h1) / det
    return jnp.stack([q1d, q2d, qdd1, qdd2])


def make_double_pendulum(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m1: float = 1.0,
    m2: float = 1.0,
    l1: float = 1.0,
    l2: float = 1.0,
    d1: float = 0.01,
    d2: float = 0.01,
    theta1: float = 0.0,
    theta2: float = 0.0,
    underactuated: bool = False,
    integrator: str = "rk4",
) -> System:
    """Build the double pendulum. ``underactuated=True`` drives joint 1 only
    (n_u=1), mirroring `UA_double_pendulum_sys.py`."""
    S = jnp.array([[1.0], [0.0]]) if underactuated else jnp.eye(2)
    params = quadratic_cost_params(x_target, Q, R, Q_f)
    params.update(
        g=jnp.asarray(g), m1=jnp.asarray(m1), m2=jnp.asarray(m2),
        l1=jnp.asarray(l1), l2=jnp.asarray(l2),
        d1=jnp.asarray(d1), d2=jnp.asarray(d2),
        theta1=jnp.asarray(theta1), theta2=jnp.asarray(theta2),
        S=S, dt=jnp.asarray(dt),
    )
    return System(
        params=params,
        n_x=4,
        n_u=S.shape[1],
        dt=dt,
        f_cont=f_cont,
        stage_cost=quadratic_stage_cost,
        terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
