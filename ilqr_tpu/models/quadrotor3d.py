"""3-D quadrotor: n_x = 12, n_u = 4 — the "real robot dimension" workload.

No reference counterpart (the reference tops out at the double pendulum,
n_x = 4 — `/root/reference/python/class_files/systems/double_pendulum_sys.py`);
this model exists to exercise the solver at the dimensions real platforms
have, where round-2's n_x ≤ 8 fast-path gates silently fell back to the
sequential scan (VERDICT r2 item 2).

State  x = [p (3), Θ (3), v (3), ω (3)]:
    p = world position (z up), Θ = ZYX Euler angles (roll φ, pitch θ, yaw ψ),
    v = world velocity, ω = body angular rates.
Controls u = [F1, F2, F3, F4]: rotor thrusts in a "+" configuration
    (rotors 1/3 on the body-x arm, 2/4 on body-y; 1 and 3 spin opposite
    2 and 4, so differential thrust yaws via rotor drag k_m).

Dynamics (rigid body, diagonal inertia, all scalar arithmetic — no tiny
dot_generals, see ops/smallmat.py):
    ṗ = v
    Θ̇ = W(φ, θ) ω                       (Euler-rate kinematics)
    v̇ = (T/m)·R(Θ)e₃ − g e₃            (thrust along body z)
    ω̇ = J⁻¹(τ − ω × Jω)
with T = ΣFᵢ, τ = [arm(F₂−F₄)·(−1)…] given by the mixer below.

Pitch must stay away from ±π/2 (Euler kinematic singularity) — the
swing-to-hover workloads here keep |θ| small by construction.
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
    p = params
    m, g, arm, km = p["m"], p["g"], p["arm"], p["km"]
    Jx, Jy, Jz = p["Jx"], p["Jy"], p["Jz"]

    phi, th, psi = x[3], x[4], x[5]
    vx, vy, vz = x[6], x[7], x[8]
    wx, wy, wz = x[9], x[10], x[11]
    F1, F2, F3, F4 = u[0], u[1], u[2], u[3]

    sph, cph = jnp.sin(phi), jnp.cos(phi)
    sth, cth = jnp.sin(th), jnp.cos(th)
    sps, cps = jnp.sin(psi), jnp.cos(psi)
    # Guard the Euler singularity: 1/cosθ and tanθ blow up at |θ| = π/2.
    # Clamping the denominator keeps rollouts finite if an aggressive line-
    # search candidate pitches through vertical (the candidate's cost is
    # then huge and rejected — same spirit as the solver's finite-cost gate).
    inv_cth = 1.0 / jnp.where(jnp.abs(cth) < 1e-3,
                              jnp.sign(cth) * 1e-3 + (cth == 0.0) * 1e-3, cth)
    tth = sth * inv_cth

    thrust = F1 + F2 + F3 + F4
    tau_x = arm * (F2 - F4)
    tau_y = arm * (F3 - F1)
    tau_z = km * (F1 - F2 + F3 - F4)

    # Body-z axis in world frame: third column of Rz(ψ)Ry(θ)Rx(φ).
    e3x = cps * sth * cph + sps * sph
    e3y = sps * sth * cph - cps * sph
    e3z = cth * cph

    ax = thrust * e3x / m
    ay = thrust * e3y / m
    az = thrust * e3z / m - g

    dphi = wx + sph * tth * wy + cph * tth * wz
    dth = cph * wy - sph * wz
    dpsi = (sph * wy + cph * wz) * inv_cth

    dwx = (tau_x - (Jz - Jy) * wy * wz) / Jx
    dwy = (tau_y - (Jx - Jz) * wz * wx) / Jy
    dwz = (tau_z - (Jy - Jx) * wx * wy) / Jz

    return jnp.stack([vx, vy, vz, dphi, dth, dpsi, ax, ay, az,
                      dwx, dwy, dwz])


def hover_controls(params) -> jnp.ndarray:
    """Per-rotor thrust that cancels gravity at level attitude (U_init)."""
    return 0.25 * params["m"] * params["g"] * jnp.ones(4)


def make_quadrotor3d(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m: float = 0.5,
    arm: float = 0.17,
    km: float = 0.016,
    Jx: float = 0.0023,
    Jy: float = 0.0023,
    Jz: float = 0.004,
    integrator: str = "rk4",
) -> System:
    """Crazyflie-scale parameters by default; quadratic costs as everywhere
    else in the framework (`models/base.py`)."""
    params = quadratic_cost_params(x_target, Q, R, Q_f)
    params.update(
        g=jnp.asarray(g), m=jnp.asarray(m), arm=jnp.asarray(arm),
        km=jnp.asarray(km), Jx=jnp.asarray(Jx), Jy=jnp.asarray(Jy),
        Jz=jnp.asarray(Jz), dt=jnp.asarray(dt),
    )
    return System(
        params=params, n_x=12, n_u=4, dt=dt, f_cont=f_cont,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )


def default_weights():
    """(Q, R, Q_f) for the hover-repositioning workloads (examples/tests)."""
    Q = jnp.diag(jnp.array([1.0, 1.0, 1.0, 0.5, 0.5, 0.5,
                            0.1, 0.1, 0.1, 0.05, 0.05, 0.05]))
    R = 0.1 * jnp.eye(4)
    Q_f = jnp.diag(jnp.array([200.0, 200.0, 200.0, 50.0, 50.0, 50.0,
                              20.0, 20.0, 20.0, 5.0, 5.0, 5.0]))
    return Q, R, Q_f


def f_cont_rotor(params, x, u):
    """Rotor-lag variant: x = [p, Θ, v, ω, f(4)] (n_x = 16), u = commanded
    thrusts; first-order actuator lag ḟ = (u − f)/τ drives the rigid body
    with the ACTUAL rotor thrusts f."""
    f = x[12:16]
    body = f_cont(params, x[:12], f)
    df = (u - f) / params["rotor_tau"]
    return jnp.concatenate([body, df])


def make_quadrotor3d_rotor(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    rotor_tau: float = 0.03,
    g: float = 9.81,
    m: float = 0.5,
    arm: float = 0.17,
    km: float = 0.016,
    Jx: float = 0.0023,
    Jy: float = 0.0023,
    Jz: float = 0.004,
    integrator: str = "rk4",
) -> System:
    """n_x = 16 manipulator-class workload: quadrotor3d + 4 rotor-lag
    states.  Exercises the n_x = 16 Riccati algebra (the largest closed-form
    QR inverse in ops/smallmat.py) at a physically meaningful dimension — x_target/Q/Q_f are 16-dimensional (target rotor thrusts =
    hover shares, typically)."""
    params = quadratic_cost_params(x_target, Q, R, Q_f)
    params.update(
        g=jnp.asarray(g), m=jnp.asarray(m), arm=jnp.asarray(arm),
        km=jnp.asarray(km), Jx=jnp.asarray(Jx), Jy=jnp.asarray(Jy),
        Jz=jnp.asarray(Jz), dt=jnp.asarray(dt),
        rotor_tau=jnp.asarray(rotor_tau),
    )
    return System(
        params=params, n_x=16, n_u=4, dt=dt, f_cont=f_cont_rotor,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
