"""3-D quadrotor flight (n_x=12, n_u=4): open-loop repositioning + MPC.

The "real robot dimension" workload (no reference counterpart — the
reference tops out at n_x=4): a waypoint flight with rotor-thrust limits,
then a receding-horizon loop with solver/plant integrator mismatch
(rk4 solver model, euler "plant", mirroring the reference MPC pattern of
`/root/reference/python/run_iLQR_MPC.py:58-75`).

Run: python examples/quadrotor3d_flight.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import time

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.models.quadrotor3d import (
    default_weights,
    hover_controls,
    make_quadrotor3d,
)
from ilqr_tpu.utils.timing import warmup


def main():
    dt, T = 0.02, sm(3.0, 0.3)
    N = int(T / dt)
    target = [2.0, 1.0, 1.5] + [0.0] * 9  # fly to (2, 1, 1.5), settle level
    Q, R, Q_f = default_weights()
    sys_ = make_quadrotor3d(dt, target, Q, R, Q_f, integrator="rk4")

    m, g = float(sys_.params["m"]), float(sys_.params["g"])
    f_max = 0.6 * m * g  # each rotor can lift ~2.4x hover share
    x0 = jnp.zeros(12)
    U0 = jnp.tile(hover_controls(sys_.params), (N, 1))

    # --- Open loop, thrust-limited. ---
    cfg = it.IlqrConfig(maxiter=sm(200, 5), tol=1e-6, u_min=0.0,
                        u_max=f_max,
                        adaptive_reg=True)
    solve = jax.jit(lambda x, U: it.solve(sys_, x, U, cfg))
    warmup(solve, x0, U0)
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(x0, U0))
    t_solve = time.perf_counter() - t0
    print(f"open-loop flight: {t_solve * 1e3:.1f} ms  "
          f"status={int(sol.status)}  iters={int(sol.iterations)}  "
          f"cost={float(sol.cost):.3f}")
    print(f"  final pos {jax.device_get(sol.X[-1, :3]).round(3)}  "
          f"max rotor thrust {float(jnp.max(sol.U)):.3f} "
          f"(limit {f_max:.3f})")

    # --- MPC with model mismatch. ---
    from ilqr_tpu.mpc import run_mpc

    plant = make_quadrotor3d(dt, target, Q, R, Q_f, integrator="euler")
    H, n_sim = sm(50, 10), sm(150, 5)
    cfg_mpc = it.IlqrConfig(maxiter=sm(5, 2), tol=1e-5)
    mpc = jax.jit(lambda x: run_mpc(
        sys_, plant, x, jnp.tile(hover_controls(sys_.params), (H, 1)),
        n_sim, cfg_mpc))
    warmup(mpc, x0)
    t0 = time.perf_counter()
    res = jax.block_until_ready(mpc(x0))
    t_mpc = (time.perf_counter() - t0) / n_sim
    print(f"MPC (horizon {H}, {n_sim} steps, rk4-solver/euler-plant): "
          f"{t_mpc * 1e3:.2f} ms/step  closed-loop cost "
          f"{float(res.cost):.3f}")
    print(f"  final pos {jax.device_get(res.X[-1, :3]).round(3)}")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
