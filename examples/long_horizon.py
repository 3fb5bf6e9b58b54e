"""Long-horizon stretch workload: 100k-step cartpole iLQR with the
associative-scan parallel Riccati (BASELINE.json config 5).

No reference counterpart — the reference's sequential scans make a 100k-step
backward pass latency-bound (O(N) dependent steps); here the backward pass is
the O(log N)-depth associative scan ('pscan') and the per-iteration cost is
dominated by the (embarrassingly parallel) linearization and the exact
rollouts.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.models.cartpole import make_cartpole
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.utils.timing import timed, warmup


def main(N: int = 100_000):
    dt = 0.0005  # 50 s horizon at 100k steps
    sys_ = make_cartpole(
        dt, [0.0, jnp.pi, 0.0, 0.0],
        Q=jnp.diag(jnp.array([1.0, 5.0, 0.1, 0.1])),
        R=0.1 * jnp.eye(1),
        Q_f=jnp.diag(jnp.array([100.0, 500.0, 50.0, 50.0])),
    )
    x0 = jnp.zeros(4)
    U0 = jnp.zeros((N, 1))

    # Per-stage timings at this horizon.
    roll = jax.jit(lambda U: it.rollout(sys_, x0, U))
    X, _ = warmup(roll, U0)
    t_roll, _ = timed(roll, U0, reps=3)

    lin = jax.jit(lambda X, U: linearize_trajectory(sys_, X, U))
    exp = warmup(lin, X, U0)
    t_lin, _ = timed(lin, X, U0, reps=3)

    from ilqr_tpu.ops.parallel_riccati import backward_pass_associative

    bp = jax.jit(lambda e: backward_pass_associative(e, 0.0))
    warmup(bp, exp)
    t_bp, _ = timed(bp, exp, reps=5)

    print(f"N={N}: rollout={t_roll * 1e3:.1f}ms linearize={t_lin * 1e3:.1f}ms "
          f"pscan-backward={t_bp * 1e3:.1f}ms "
          f"({N / t_bp / 1e6:.2f}M timesteps/s)")

    # Parallel-in-time initial rollout (Newton sweeps + affine prefix scan).
    from ilqr_tpu.ops.parallel_rollout import open_loop_defect_rollout

    roll_p = jax.jit(lambda U: open_loop_defect_rollout(sys_, x0, U, iters=8))
    _, _, defect = warmup(roll_p, U0)
    t_roll_p, _ = timed(roll_p, U0, reps=3)
    print(f"initial rollout: sequential={t_roll * 1e3:.1f}ms "
          f"defect-parallel={t_roll_p * 1e3:.1f}ms "
          f"(certified defect {float(defect):.1e})")

    # A few full iLQR iterations end-to-end.  Every stage parallel-in-time:
    # defect initial rollout, associative-scan backward, defect line search
    # (exact sequential fallback guards uncertified candidates).
    cfg = it.IlqrConfig(maxiter=sm(10, 2), tol=1e-6, backward="pscan",
                        adaptive_reg=True, init_rollout="defect",
                        rollout="defect")
    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    warmup(solve, x0, U0)
    t_solve, sol = timed(solve, x0, U0, reps=1)
    print(f"10-iteration solve (all stages parallel-in-time): {t_solve:.2f}s  "
          f"cost={float(sol.cost):.4f} iters={int(sol.iterations)}")

    cfg_seq = it.IlqrConfig(maxiter=sm(10, 2), tol=1e-6, backward="pscan",
                            adaptive_reg=True, init_rollout="defect")
    solve_seq = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg_seq))
    warmup(solve_seq, x0, U0)
    t_seq, sol_seq = timed(solve_seq, x0, U0, reps=1)
    print(f"10-iteration solve (sequential line search): {t_seq:.2f}s  "
          f"cost={float(sol_seq.cost):.4f} iters={int(sol_seq.iterations)}")

    # Multiple shooting: the line search needs NO nonlinear rollout at all
    # (affine update pass + vmapped defect evaluation), so every stage of
    # every iteration is O(log N) depth — at this horizon it is the fastest
    # way to a converged trajectory by a wide margin (ilqr_tpu.shooting).
    from ilqr_tpu.shooting import MsConfig, solve_ms

    cfg_ms = it.IlqrConfig(maxiter=sm(30, 2), tol=1e-6, backward="pscan",
                           init_rollout="defect")
    ms = jax.jit(lambda x, U: solve_ms(sys_, x, U, config=cfg_ms,
                                       ms=MsConfig(update_engine="xla")))
    warmup(ms, x0, U0)
    t_ms, sol_ms = timed(ms, x0, U0, reps=1)
    print(f"multiple-shooting solve (all stages O(log N)): {t_ms:.2f}s  "
          f"cost={float(sol_ms.cost):.4f} iters={int(sol_ms.iterations)} "
          f"defect={float(sol_ms.defect):.1e}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(int(os.environ.get("N_HORIZON", sm(100_000, 512))))
