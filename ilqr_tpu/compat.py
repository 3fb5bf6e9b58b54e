"""Reference-compatible OO facade.

Users of the reference package (`iLQR` classes, (dim, time) array layout,
13-function derivative surface) can switch to ilqr_tpu with minimal edits:
this module exposes the same names, constructor signatures and layouts
(`/root/reference/python/class_files/iLQR_class.py:18-38`,
`system_base.py:25-251`) on top of the functional core.  New code should
use the functional API (`ilqr_tpu.solve` etc.) directly — the facade costs a
device sync per property access but solves with the same single fused device
program.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp

from ilqr_tpu.models.base import System as _System
from ilqr_tpu.ops.integrators import step as _step
from ilqr_tpu.ops.rollout import rollout as _rollout
from ilqr_tpu.solver import IlqrConfig, LINESEARCH_FAILED, MAXITER, solve as _solve


class SystemAdapter:
    """Wraps a functional `System` with the reference's 13-method surface
    (`system_base.py:223-251`): f_fcn, f_x_fcn, f_u_fcn, l_fcn, l_x_fcn,
    l_u_fcn, l_xx_fcn, l_ux_fcn, l_uu_fcn, l_f_fcn, l_f_x_fcn, l_f_xx_fcn."""

    def __init__(self, system: _System, use_jit: bool = True):
        self._sys = system
        self.n_x, self.n_u, self.dt = system.n_x, system.n_u, system.dt
        self.use_jit = bool(use_jit)

        f = lambda x, u: _step(system, x, u)
        l = lambda x, u: system.stage_cost(system.params, x, u)
        lf = lambda x: system.terminal_cost(system.params, x)

        # `use_jit=False` is the reference's eager-debug path
        # (`system_base.py:223-251`): the 13 public functions trace fresh on
        # every call, so Python breakpoints / prints inside user dynamics and
        # cost functions fire.  Solver entry points stay jitted either way
        # (the whole-loop-on-device design has no eager outer loop).
        wrap: Callable = jax.jit if self.use_jit else (lambda fn: fn)

        self.f_fcn: Callable = wrap(f)
        self.f_x_fcn: Callable = wrap(jax.jacfwd(f, argnums=0))
        self.f_u_fcn: Callable = wrap(jax.jacfwd(f, argnums=1))
        self.l_fcn: Callable = wrap(l)
        self.l_x_fcn: Callable = wrap(jax.grad(l, argnums=0))
        self.l_u_fcn: Callable = wrap(jax.grad(l, argnums=1))
        self.l_xx_fcn: Callable = wrap(jax.hessian(l, argnums=0))
        self.l_uu_fcn: Callable = wrap(jax.hessian(l, argnums=1))
        self.l_ux_fcn: Callable = wrap(
            jax.jacfwd(jax.grad(l, argnums=1), argnums=0)
        )
        self.l_f_fcn: Callable = wrap(lf)
        self.l_f_x_fcn: Callable = wrap(jax.grad(lf))
        self.l_f_xx_fcn: Callable = wrap(jax.hessian(lf))

    @property
    def system(self) -> _System:
        return self._sys


def MyPendulum(dt, x_target, Q, R, Q_f, g=9.81, l=1.0, d=0.01,
               use_jit=True, integrator="rk4") -> SystemAdapter:
    """Constructor-compatible with the reference `MyPendulum`
    (`pendulum_sys.py:22-55`).  ``use_jit=False`` gives the reference's
    eager-debug derivative surface (see `SystemAdapter`)."""
    from ilqr_tpu.models.pendulum import make_pendulum

    return SystemAdapter(
        make_pendulum(dt, x_target, Q, R, Q_f, g=g, l=l, d=d,
                      integrator=integrator),
        use_jit=use_jit,
    )


def MyDoublePendulum(dt, x_target, Q, R, Q_f, g=9.81, m1=1.0, m2=1.0,
                     l1=1.0, l2=1.0, d1=0.01, d2=0.01, theta1=0.0,
                     theta2=0.0, use_jit=True, integrator="rk4") -> SystemAdapter:
    """Constructor-compatible with the reference `MyDoublePendulum`
    (`double_pendulum_sys.py:20-38`)."""
    from ilqr_tpu.models.double_pendulum import make_double_pendulum

    return SystemAdapter(
        make_double_pendulum(dt, x_target, Q, R, Q_f, g=g, m1=m1, m2=m2,
                             l1=l1, l2=l2, d1=d1, d2=d2, theta1=theta1,
                             theta2=theta2, integrator=integrator),
        use_jit=use_jit,
    )


def MyUADoublePendulum(dt, x_target, Q, R, Q_f, g=9.81, m1=1.0, m2=1.0,
                       l1=1.0, l2=1.0, d1=0.01, d2=0.01, theta1=0.0,
                       theta2=0.0, use_jit=True, integrator="rk4") -> SystemAdapter:
    """Constructor-compatible with the reference `MyUADoublePendulum`
    (`UA_double_pendulum_sys.py:20-38`)."""
    from ilqr_tpu.models.double_pendulum import make_double_pendulum

    return SystemAdapter(
        make_double_pendulum(dt, x_target, Q, R, Q_f, g=g, m1=m1, m2=m2,
                             l1=l1, l2=l2, d1=d1, d2=d2, theta1=theta1,
                             theta2=theta2, underactuated=True,
                             integrator=integrator),
        use_jit=use_jit,
    )


class iLQR:
    """Reference-compatible solver class (`iLQR_class.py:18-38`): same
    constructor, same (dim, time) trajectory layout, same
    `optimize_trajectory() -> (X, U, cost)` contract, and `backward_pass` /
    `forward_pass` attributes for warm-up code written against the reference
    (`run_iLQR_open_loop.py:74-95`).  Internally one fused device program."""

    def __init__(self, system: Union[SystemAdapter, _System], T: float,
                 x_0, U_init, tol: float = 1e-5, maxiter: int = 100,
                 alpha_factor: float = 0.5, min_alpha: float = 1e-8,
                 verbose: bool = True):
        self._sys = system.system if isinstance(system, SystemAdapter) else system
        self.system = system
        self.T = T
        self.x_0 = jnp.asarray(x_0)
        self.tol, self.maxiter = tol, maxiter
        self.alpha_factor, self.min_alpha = alpha_factor, min_alpha
        self.verbose = verbose

        self.n_x, self.n_u, self.dt = self._sys.n_x, self._sys.n_u, self._sys.dt
        self.tspan = jnp.arange(0, T + self.dt, self.dt)
        self.N = len(self.tspan) - 1

        expected = (self.n_u, self.N)
        if tuple(U_init.shape) != expected:
            raise ValueError(
                f"U_init must have shape {expected}, but got {U_init.shape}"
            )
        # (dim, time) layout, like the reference (`iLQR_class.py:54-61`).
        self.X = jnp.zeros((self.n_x, self.N + 1))
        self.U = jnp.asarray(U_init)
        self.K = jnp.zeros((self.N, self.n_u, self.n_x))
        self.U_ff = jnp.zeros((self.n_u, self.N))

        self._config = IlqrConfig(
            maxiter=maxiter, tol=tol, alpha_factor=alpha_factor,
            min_alpha=min_alpha,
        )
        self._solve = jax.jit(
            lambda x0, U0: _solve(self._sys, x0, U0, self._config)
        )

        # Reference-shaped jitted pass handles (used by driver warm-up code).
        from ilqr_tpu.ops.linearize import linearize_trajectory
        from ilqr_tpu.ops.riccati import backward_pass as _bp
        from ilqr_tpu.ops.rollout import closed_loop_rollout as _fp

        def backward_pass(X_nom, U_nom):
            exp = linearize_trajectory(self._sys, X_nom.T, U_nom.T)
            u_ff, K, _, _ = _bp(exp)
            return u_ff.T, K

        def forward_pass(x0_arg, alpha, X_old, U_old, U_ff, K):
            X_new, U_new, cost = _fp(self._sys, x0_arg, alpha, X_old.T,
                                     U_old.T, U_ff.T, K)
            return X_new.T, U_new.T, cost

        self.backward_pass = jax.jit(backward_pass)
        self.forward_pass = jax.jit(forward_pass)
        self._initial_cost = jax.jit(
            lambda x0, U0: _rollout(self._sys, x0, U0)[1])

    def optimize_trajectory(self):
        """Run the solve; returns (X, U, cost) in (dim, time) layout.

        ``verbose`` reproduces the reference's per-iteration output
        (`iLQR_class.py:261-311`) from the solution's cost/α traces:
        initial cost, one line per accepted iteration with the accepted α,
        then the convergence / line-search-failure / max-iteration message.
        """
        U0 = jnp.asarray(self.U).T
        sol = self._solve(self.x_0, U0)
        if self.verbose:
            # Initial α=0 rollout cost (the reference's first print,
            # `iLQR_class.py:258-262`).
            print(f"Initial cost: "
                  f"{float(self._initial_cost(jnp.asarray(self.x_0), U0)):.4f}")
        self.X, self.U = sol.X.T, sol.U.T
        self.U_ff, self.K = sol.u_ff.T, sol.K
        if self.verbose:
            import numpy as _np

            k = int(sol.iterations)
            ct = _np.asarray(sol.cost_trace)
            at = _np.asarray(sol.alpha_trace)
            for i in range(k):
                print(f"  Iter {i + 1} (alpha={at[i]:.2e}): "
                      f"Cost improved to {ct[i]:.4f}")
            status = int(sol.status)
            if status == LINESEARCH_FAILED:
                print(f"Warning: Line search failed at iteration {k + 1}. "
                      "Cost did not improve.")
            elif status == MAXITER:
                print(f"Warning: Reached max iterations ({self.maxiter}) "
                      "without converging.")
            else:
                print(f"Converged at iteration {k}")
        return self.X, self.U, sol.cost
