"""Time-varying reference tracking MPC — follow a moving target.

Greenfield workload (the reference framework only regulates to a FIXED
target, `pendulum_sys.py:77-98`): the pendulum must follow a sinusoidal
angle reference.  The tracking cost is realized by `make_tracking_system`
(models/tracking.py): the step index rides along in the state, so the
receding-horizon solver's reference window shifts automatically as the
plant clock advances — the whole closed loop stays one jitted lax.scan.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from _smoke import sm  # noqa: E402
import os

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from ilqr_tpu.mpc import run_mpc
from ilqr_tpu.utils.timing import timed


def main():
    dt = 0.01
    N_sim, horizon = sm(600, 6), sm(50, 10)
    base = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")

    # Sinusoidal angle reference over sim + lookahead horizon.
    t = jnp.arange(N_sim + horizon + 1) * dt
    theta_ref = 0.8 * jnp.sin(2.0 * t)
    X_ref = jnp.stack([theta_ref, 1.6 * jnp.cos(2.0 * t)], axis=-1)
    trk = it.make_tracking_system(
        base, X_ref, jnp.zeros((N_sim + horizon, 1)),
        Q=jnp.diag(jnp.array([100.0, 1.0])), R=0.01 * jnp.eye(1),
        Q_f=jnp.zeros((2, 2)))

    mpc = jax.jit(lambda x: run_mpc(
        trk, trk, x, jnp.zeros((horizon, 1)), N_sim,
        it.IlqrConfig(maxiter=8, tol=1e-6)))
    t_mpc, res = timed(mpc, it.augment_x0(jnp.zeros(2)), reps=3, warmup_reps=1)
    theta = it.strip_clock(res.X)[:, 0]
    rms = float(jnp.sqrt(jnp.mean((theta - theta_ref[:N_sim + 1]) ** 2)))
    print(f"tracking MPC: {N_sim} steps in {t_mpc*1e3:.1f} ms "
          f"({t_mpc/N_sim*1e3:.2f} ms/step), RMS angle error {rms:.4f} rad")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    ts = jnp.arange(N_sim + 1) * dt
    axes[0].plot(ts, theta_ref[:N_sim + 1], "k--", label="reference")
    axes[0].plot(ts, theta, label="closed loop")
    axes[0].set_ylabel("θ [rad]"); axes[0].legend()
    axes[1].plot(ts[:-1], res.U[:, 0])
    axes[1].set_ylabel("u [Nm]"); axes[1].set_xlabel("t [s]")
    fig.savefig(os.path.join(out, "reference_tracking_mpc.png"), dpi=110)
    print(f"wrote {out}/reference_tracking_mpc.png")


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
