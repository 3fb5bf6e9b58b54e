"""System abstraction: pure-function dynamics + costs as a pytree dataclass.

Functional redesign of the reference's stateful OO base class
(`/root/reference/python/class_files/systems/system_base.py:9-275`): instead of a
Python ABC that manufactures 13 jitted bound methods, a `System` here is a frozen
pytree holding a parameter pytree and three *pure* functions

    f_cont(params, x, u)        -> xdot          (continuous dynamics)
    stage_cost(params, x, u)    -> scalar        (running cost l)
    terminal_cost(params, x)    -> scalar        (terminal cost l_f)

Everything else — discrete dynamics under four integrators, the full derivative
surface (f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, l_f_x, l_f_xx) — is derived on
demand by JAX transforms in `ilqr_tpu.ops`, traced *once* inside the enclosing
jitted solver rather than jitted piecemeal.  Because `System` is a pytree, it
vmaps/shards/scans transparently: a batch of systems with different parameters
is just a stacked pytree.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp


def f32_matmuls(fn: Callable) -> Callable:
    """Trace ``fn`` under full-f32 ("highest") matmul precision.

    On an NVIDIA GPU, XLA's default precision may run f32 matrix products
    in TF32 (a 10-bit mantissa, about three decimal digits), under which
    long-horizon Riccati recursions and the f64-oracle parity gates lose
    accuracy.  Scoping the precision to this library's entry points (instead
    of mutating global JAX config at import) leaves unrelated user code
    untouched; control-sized matmuls are too small for the tensor cores to
    matter.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


# Integrator names accepted framework-wide.  Mirrors the reference's set
# (`system_base.py:77-198`) plus the implicit trapezoidal rule (2nd-order
# A-stable) and 'discrete' (f_cont is the discrete map itself); neither has
# a reference counterpart.
INTEGRATORS = ("euler", "midpoint", "rk4", "backward_euler", "trapezoidal",
               "discrete")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class System:
    """A controlled dynamical system with costs.

    ``params`` is the only pytree leaf; all other fields are static metadata
    (they participate in jit cache keys, so use module-level functions — not
    per-call lambdas — for the three callables).
    """

    params: Any
    n_x: int = dataclasses.field(metadata=dict(static=True))
    n_u: int = dataclasses.field(metadata=dict(static=True))
    dt: float = dataclasses.field(metadata=dict(static=True))
    f_cont: Callable = dataclasses.field(metadata=dict(static=True))
    stage_cost: Callable = dataclasses.field(metadata=dict(static=True))
    terminal_cost: Callable = dataclasses.field(metadata=dict(static=True))
    integrator: str = dataclasses.field(default="rk4", metadata=dict(static=True))
    # Newton settings for the implicit backward-Euler integrator.  A *fixed*
    # iteration count (vs the reference's tolerance-gated `lax.while_loop`,
    # `system_base.py:105-139`) keeps the step vmap/shard-friendly.
    newton_iters: int = dataclasses.field(default=10, metadata=dict(static=True))

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    def with_integrator(self, integrator: str) -> "System":
        if integrator not in INTEGRATORS:
            raise ValueError(
                f"Unknown integrator {integrator!r}; supported: {INTEGRATORS}"
            )
        return self.replace(integrator=integrator)


def quadratic_cost_params(x_target, Q, R, Q_f) -> dict:
    """Standard quadratic tracking-cost parameter block shared by all models.

    Model constructors add a ``dt`` entry (the stage cost is dt-scaled,
    matching `pendulum_sys.py:87-89`).
    """
    return dict(
        x_target=jnp.asarray(x_target),
        Q=jnp.asarray(Q),
        R=jnp.asarray(R),
        Q_f=jnp.asarray(Q_f),
    )


# Trace-time switch for the component-unrolled small-matrix forms below.
# The batched rollouts under vmap(solve) (the custom_vmap rules in
# ops/rollout.py) trace the model under it: every intermediate then keeps
# the batch shape instead of a (B, n, n) broadcast product.  Single-instance
# traces keep the vectorized reduce: the unrolled n² terms lower to n²
# separate ops per sequential scan step.  Neither choice has been timed on
# the GPU yet.
import contextlib as _contextlib

_UNROLLED_SMALLMATH = False


@_contextlib.contextmanager
def unrolled_smallmath():
    """Trace model costs/dynamics with component-unrolled quad_form/matvec.
    Used by the batched rollout rules; a pure trace-time switch, not a
    runtime flag."""
    global _UNROLLED_SMALLMATH
    prev = _UNROLLED_SMALLMATH
    _UNROLLED_SMALLMATH = True
    try:
        yield
    finally:
        _UNROLLED_SMALLMATH = prev


def quad_form(v, M):
    """v'Mv via broadcasting (no dot_general for the tiny contraction);
    component-unrolled under `unrolled_smallmath()` (see above)."""
    n = M.shape[-1]
    if _UNROLLED_SMALLMATH:
        return sum(v[..., i] * M[..., i, j] * v[..., j]
                   for i in range(n) for j in range(n))
    return jnp.sum(v[..., :, None] * M * v[..., None, :], axis=(-2, -1))


def matvec(M, v):
    """M @ v via broadcasting; unrolled under `unrolled_smallmath()`."""
    if _UNROLLED_SMALLMATH:
        n = M.shape[-1]
        cols = [sum(M[..., i, j] * v[..., j] for j in range(n))
                for i in range(M.shape[-2])]
        return jnp.stack(cols, axis=-1)
    return jnp.sum(M * v[..., None, :], axis=-1)


def quadratic_stage_cost(params, x, u):
    """l(x,u) = 0.5 (dx'Q dx + u'R u) * dt — dt-scaled, matching the reference
    convention (`pendulum_sys.py:77-90`)."""
    dx = x - params["x_target"]
    return 0.5 * (quad_form(dx, params["Q"]) + quad_form(u, params["R"])) * params["dt"]


def quadratic_terminal_cost(params, x):
    """l_f(x) = 0.5 dx'Q_f dx — un-scaled (`pendulum_sys.py:92-98`)."""
    dx = x - params["x_target"]
    return 0.5 * quad_form(dx, params["Q_f"])
