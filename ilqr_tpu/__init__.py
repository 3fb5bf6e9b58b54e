"""ilqr_tpu — a trajectory-optimization (iLQR/DDP) framework in JAX.

Functional, pytree-based redesign of
MohamedAbou-Taleb/Iterative-Linear-Quadratic-Regulator: pure-function systems,
a fully on-device solver loop, associative-scan parallel Riccati, batched MPC
over device meshes, and horizon sharding across devices.
"""
# NOTE: solver/ops entry points trace under full-f32 matmul precision via the
# `f32_matmuls` decorator (see models/base.py) — reduced-precision (TF32)
# matmuls cost the long-horizon Riccati recursions their accuracy.  No
# global JAX config is mutated on import.
from ilqr_tpu.models.base import System, INTEGRATORS
from ilqr_tpu.models.pendulum import make_pendulum
from ilqr_tpu.models.double_pendulum import make_double_pendulum
from ilqr_tpu.models.linear import make_lti, cont2disc
from ilqr_tpu.models.cartpole import make_cartpole
from ilqr_tpu.models.chain import make_spring_chain
from ilqr_tpu.models.quadrotor import make_quadrotor
from ilqr_tpu.models.quadrotor3d import make_quadrotor3d
from ilqr_tpu.models.car import make_car
from ilqr_tpu.models.neural import make_neural_residual, fit_dynamics
from ilqr_tpu.models.tracking import make_tracking_system, augment_x0, strip_clock
from ilqr_tpu.ops.integrators import step
from ilqr_tpu.ops.rollout import rollout, closed_loop_rollout
from ilqr_tpu.ops.linearize import linearize_trajectory, TrajectoryExpansion
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu.ops.lqr import lqr_solve, lqr_backward
from ilqr_tpu.solver import (
    solve,
    IlqrConfig,
    IlqrSolution,
    CONVERGED,
    LINESEARCH_FAILED,
    MAXITER,
)
from ilqr_tpu.tracking import tvlqr_gains, track, track_solution
from ilqr_tpu.constrained import (
    solve_constrained,
    solve_constrained_ms,
    ConstraintSet,
    ConstrainedSolution,
    AlConfig,
    box_control_constraints,
    goal_constraint,
    state_bound_constraints,
    merge_constraints,
    INFEASIBLE,
)
from ilqr_tpu.barrier import (
    solve_barrier,
    BarrierConfig,
    BarrierSolution,
    relaxed_log_barrier,
)
from ilqr_tpu.diff import solve_implicit, run_mpc_implicit, IftConfig
from ilqr_tpu.mppi import solve_mppi, mppi_update, run_mpc_mppi, MppiConfig
from ilqr_tpu.shooting import solve_ms, MsConfig, MsSolution, interpolate_states

__version__ = "0.1.0"

__all__ = [
    "System", "INTEGRATORS", "make_pendulum", "make_double_pendulum",
    "make_cartpole", "make_spring_chain", "make_quadrotor", "make_quadrotor3d", "make_car",
    "make_lti", "cont2disc", "step", "rollout", "closed_loop_rollout",
    "linearize_trajectory", "TrajectoryExpansion", "backward_pass",
    "backward_pass_associative", "lqr_solve", "lqr_backward",
    "solve", "IlqrConfig", "IlqrSolution",
    "CONVERGED", "LINESEARCH_FAILED", "MAXITER",
    "solve_constrained", "solve_constrained_ms",
    "ConstraintSet", "ConstrainedSolution", "AlConfig",
    "box_control_constraints", "goal_constraint", "state_bound_constraints",
    "merge_constraints",
    "INFEASIBLE",
    "solve_barrier", "BarrierConfig", "BarrierSolution", "relaxed_log_barrier",
    "tvlqr_gains", "track", "track_solution",
    "solve_implicit", "run_mpc_implicit", "IftConfig",
    "solve_mppi", "mppi_update", "run_mpc_mppi", "MppiConfig",
    "make_neural_residual", "fit_dynamics",
    "make_tracking_system", "augment_x0", "strip_clock",
    "solve_ms", "MsConfig", "MsSolution", "interpolate_states",
]
