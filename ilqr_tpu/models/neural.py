"""Neural-augmented dynamics: an MLP residual on any System's f_cont.

Grey-box system identification for the control stack: take an analytic model
(pendulum, cartpole, …), add a small MLP residual to its continuous dynamics,

    ẋ = f_base(θ_base, x, u) + MLP(θ_mlp, [x, u]),

and fit θ_mlp to trajectory data by reverse-mode through the (differentiable)
rollout — then hand the learned ``System`` straight to ``ilqr_tpu.solve`` /
``mpc`` / ``solve_implicit``, because it IS a ``System``: the parameters
(base + MLP weights) live in the pytree leaf ``system.params``, so jit /
vmap / sharding / implicit differentiation all compose untouched.

Design notes (JAX idiom):
* ``System.f_cont`` must stay a module-level function (it is static metadata
  participating in jit cache keys, `models/base.py:57-60`), so the base
  system's callables are threaded through ``params`` as
  ``jax.tree_util.Partial`` leaves — pytree-compatible, equal by function
  identity, invisible to tracing.
* The MLP's output layer initializes to ZERO: a freshly wrapped system is
  bit-identical to its base, and learning starts from the physics prior
  rather than noise.
* ``fit_dynamics`` trains with optax.adam on multi-step (teacher-forced
  one-step by default) prediction error, entirely on-device — one jitted
  update; vmaps over trajectory batches.

No reference counterpart — the reference has only hand-written analytic
models (`/root/reference/python/class_files/systems/`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.tree_util import Partial

from ilqr_tpu.models.base import System
from ilqr_tpu.ops.integrators import step


def _mlp_init(key, sizes: Sequence[int], dtype=jnp.float32):
    """Glorot-initialized MLP; FINAL layer zero → zero residual at init."""
    layers = []
    keys = jax.random.split(key, len(sizes) - 1)
    for i, k in enumerate(keys):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        last = i == len(keys) - 1
        scale = 0.0 if last else jnp.sqrt(2.0 / (fan_in + fan_out))
        W = scale * jax.random.normal(k, (fan_in, fan_out), dtype=dtype)
        layers.append(dict(W=W, b=jnp.zeros((fan_out,), dtype=dtype)))
    return layers


def _mlp_apply(layers, z):
    for layer in layers[:-1]:
        z = jnp.tanh(z @ layer["W"] + layer["b"])
    return z @ layers[-1]["W"] + layers[-1]["b"]


def f_cont(params, x, u):
    base = params["base_f"](params["base"], x, u)
    return base + _mlp_apply(params["mlp"], jnp.concatenate([x, u]))


def stage_cost(params, x, u):
    return params["base_l"](params["base"], x, u)


def terminal_cost(params, x):
    return params["base_lf"](params["base"], x)


def make_neural_residual(
    base: System,
    hidden: Sequence[int] = (32, 32),
    key: jax.Array | None = None,
) -> System:
    """Wrap ``base`` with an MLP residual on its continuous dynamics.

    The returned system starts bit-identical to ``base`` (zero-initialized
    output layer); its MLP weights live at ``system.params['mlp']``.
    """
    if key is None:
        key = jax.random.key(0)
    sizes = [base.n_x + base.n_u, *hidden, base.n_x]
    params = dict(
        base=base.params,
        mlp=_mlp_init(key, sizes),
        base_f=Partial(base.f_cont),
        base_l=Partial(base.stage_cost),
        base_lf=Partial(base.terminal_cost),
    )
    return System(
        params=params,
        n_x=base.n_x,
        n_u=base.n_u,
        dt=base.dt,
        f_cont=f_cont,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        integrator=base.integrator,
        newton_iters=base.newton_iters,
    )


def prediction_loss(
    system: System, X: jnp.ndarray, U: jnp.ndarray, horizon: int = 1
) -> jnp.ndarray:
    """Mean squared ``horizon``-step prediction error over all windows.

    X: (..., N+1, n_x), U: (..., N, n_u) — leading batch axes allowed.
    ``horizon=1`` is teacher-forced one-step error; ``horizon=K`` rolls the
    model K steps from every window start and compares the whole segment —
    one-step fits can be excellent yet drift badly when composed, and it is
    the composed model the planner optimizes through, so K≈10 is usually
    what control-relevant fitting needs.
    """
    Xf = X.reshape((-1,) + X.shape[-2:])
    Uf = U.reshape((-1,) + U.shape[-2:])
    K = horizon
    starts = jnp.arange(Uf.shape[1] - K + 1)

    def per_traj(Xt, Ut):
        def per_window(s):
            Uw = jax.lax.dynamic_slice_in_dim(Ut, s, K, 0)
            Xw = jax.lax.dynamic_slice_in_dim(Xt, s, K + 1, 0)

            def f(x, u):
                x1 = step(system, x, u)
                return x1, x1

            _, Xp = jax.lax.scan(f, Xw[0], Uw)
            return jnp.mean((Xp - Xw[1:]) ** 2)

        return jnp.mean(jax.vmap(per_window)(starts))

    return jnp.mean(jax.vmap(per_traj)(Xf, Uf))


def fit_dynamics(
    system: System,
    X: jnp.ndarray,
    U: jnp.ndarray,
    steps: int = 500,
    learning_rate: float = 1e-2,
    trainable: str = "mlp",
    horizon: int = 1,
) -> Tuple[System, jnp.ndarray]:
    """Fit the system's parameters to trajectory data on-device.

    ``trainable='mlp'`` updates only the residual weights (physics prior
    frozen); ``'all'`` co-adapts the base parameters too.  ``horizon`` is
    the multi-step prediction window (see `prediction_loss`).  Returns the
    fitted system and the (steps,) loss trace.  The whole optimization is
    one jitted ``lax.scan`` of adam updates.
    """
    import optax

    if trainable not in ("mlp", "all"):
        raise ValueError(f"trainable must be 'mlp'|'all', got {trainable!r}")

    params0 = system.params

    def split(params):
        if trainable == "mlp":
            return params["mlp"], {k: v for k, v in params.items() if k != "mlp"}
        return params, None

    def join(train, frozen):
        if trainable == "mlp":
            return {**frozen, "mlp": train}
        return train

    train0, frozen = split(params0)
    opt = optax.adam(learning_rate)

    def loss_fn(train):
        sys_t = system.replace(params=join(train, frozen))
        return prediction_loss(sys_t, X, U, horizon=horizon)

    def update(carry, _):
        train, opt_state = carry
        loss, g = jax.value_and_grad(loss_fn)(train)
        upd, opt_state = opt.update(g, opt_state)
        train = optax.apply_updates(train, upd)
        return (train, opt_state), loss

    @jax.jit
    def run(train):
        (train, _), losses = jax.lax.scan(
            update, (train, opt.init(train)), None, length=steps
        )
        return train, losses

    train, losses = run(train0)
    return system.replace(params=join(train, frozen)), losses
