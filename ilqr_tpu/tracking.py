"""Time-varying LQR tracking of solved trajectories.

Greenfield capability (no reference counterpart): the reference stabilizes
only via receding-horizon re-solving (`run_iLQR_MPC.py`).  TVLQR is the
cheap alternative for the regime between open-loop replay and full MPC —
linearize once along a (dynamically feasible) reference trajectory, solve a
Riccati recursion for time-varying feedback gains, and apply
``u = u_ref + K (x − x_ref)`` at execution time with zero per-step
optimization.

Structure: gain synthesis reuses the trajectory-wide vmapped
linearization and the sequential/associative Riccati backward pass on a
synthetic deviation-cost expansion, so it inherits every backend; execution
is one `lax.scan` (or `closed_loop_rollout`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System, f32_matmuls
from ilqr_tpu.ops.linearize import TrajectoryExpansion, linearize_trajectory
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.ops.rollout import closed_loop_rollout


@f32_matmuls
def tvlqr_gains(
    system: System,
    X_ref: jnp.ndarray,
    U_ref: jnp.ndarray,
    Q: jnp.ndarray,
    R: jnp.ndarray,
    Q_f: jnp.ndarray,
    backward=backward_pass,
) -> jnp.ndarray:
    """Feedback gains K (N, n_u, n_x) stabilizing (X_ref, U_ref).

    Deviation cost ½(δx'Qδx + δu'Rδu)·dt per step + ½ δx'Q_f δx terminal,
    expanded around the reference (zero gradients — the reference is the
    operating point), dynamics linearized along it.  ``backward`` may be any
    backward-pass backend with the `backward_pass(exp, reg)` contract (e.g.
    `parallel_riccati.backward_pass_associative` for O(log N) synthesis).
    """
    N = U_ref.shape[0]
    dtype = U_ref.dtype
    exp_dyn = linearize_trajectory(system, X_ref, U_ref)
    dt = jnp.asarray(system.dt, dtype)
    zeros_x = jnp.zeros((N, X_ref.shape[-1]), dtype)
    zeros_u = jnp.zeros((N, U_ref.shape[-1]), dtype)
    exp = TrajectoryExpansion(
        f_x=exp_dyn.f_x, f_u=exp_dyn.f_u,
        l_x=zeros_x, l_u=zeros_u,
        l_xx=jnp.broadcast_to(jnp.asarray(Q, dtype) * dt, exp_dyn.l_xx.shape),
        l_ux=jnp.zeros_like(exp_dyn.l_ux),
        l_uu=jnp.broadcast_to(jnp.asarray(R, dtype) * dt, exp_dyn.l_uu.shape),
        v_x=jnp.zeros((X_ref.shape[-1],), dtype),
        v_xx=jnp.asarray(Q_f, dtype),
    )
    _, K, _, _ = backward(exp, 0.0)
    return K


@f32_matmuls
def track(
    plant: System,
    x0: jnp.ndarray,
    X_ref: jnp.ndarray,
    U_ref: jnp.ndarray,
    K: jnp.ndarray,
    u_limits: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Execute ``u_k = u_ref_k + K_k (x_k − x_ref_k)`` on ``plant``.

    Returns (X, U, cost) of the closed-loop run — ``plant`` may differ from
    the system the reference was optimized on (model mismatch).
    """
    return closed_loop_rollout(
        plant, x0, jnp.asarray(0.0, U_ref.dtype), X_ref, U_ref,
        jnp.zeros_like(U_ref), K, u_limits=u_limits,
    )


def track_solution(plant: System, x0, solution, u_limits=None):
    """Track an `IlqrSolution` with its own (converged) iLQR gains.

    The final backward-pass K of a converged solve is already the TVLQR gain
    for the solution trajectory under the problem's cost — no extra synthesis
    needed.

    Caveat: with control limits (`IlqrConfig.u_min/u_max`) or near-zero
    regularization the converged gains can be ill-conditioned (Q_uu nearly
    singular along inactive directions → enormous free-row gains; measured
    ~1e8 on the thrust-limited quadrotor) — optimal for the local LQ model,
    useless as a feedback controller.  In that regime synthesize fresh gains
    with `tvlqr_gains(system, sol.X, sol.U, Q_track, R_track, Qf_track)`
    instead (see examples/quadrotor_dash.py).
    """
    return track(plant, x0, solution.X, solution.U, solution.K,
                 u_limits=u_limits)
