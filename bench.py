"""Benchmark of the solver's stages and entry points on an NVIDIA GPU.

Measures the backward-pass engines across state dimensions and horizons, the
line-search and initial-rollout engines at N=100k, the full double-pendulum
solve with an in-program per-stage profile, the long-horizon
multiple-shooting solve, batched solves and batched MPC, and the
single-instance MPC step (full, RTI and multiple-shooting RTI).

Every timing is the median of several calls ended with `block_until_ready`,
after an AOT compile reported separately.  Each measurement is one JSON line
on stderr; stdout gets one summary JSON line naming the device, its power
limit and every metric.  Without a GPU it exits non-zero.

Run:  python bench.py
"""
import json
import sys

import jax
import jax.numpy as jnp

import ilqr_tpu as it
from chip_smoke import (
    card_lines,
    compile_and_time,
    double_pendulum,
    mpc_pendulum_pair,
    require_gpu,
)
from ilqr_tpu.ops.linearize import linearize_trajectory
from ilqr_tpu.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu.ops.riccati import backward_pass
from ilqr_tpu.utils.compile_cache import enable_compile_cache

METRICS = {}


def log(name, seconds, **kw):
    """Record one timing (ms) and print it with its shape parameters."""
    key = name + "".join(f"@{k}{v}" for k, v in kw.items())
    METRICS[key] = seconds * 1e3
    print(json.dumps(dict(metric=name, ms=seconds * 1e3, **kw)),
          file=sys.stderr, flush=True)


def steady(fn, *args, reps=3):
    return compile_and_time(fn, *args, reps=reps)[3]


def expansion(sys_, n_x, U):
    X, _ = jax.jit(lambda u: it.rollout(sys_, jnp.zeros(n_x), u))(U)
    return jax.block_until_ready(
        jax.jit(lambda x, u: linearize_trajectory(sys_, x, u))(X, U))


def bench_backward(sys_dp):
    """Sequential vs associative backward pass across n_x and N."""
    from ilqr_tpu.models.chain import make_spring_chain
    from ilqr_tpu.models.quadrotor import hover_controls, make_quadrotor
    from ilqr_tpu.models.quadrotor3d import (
        default_weights,
        hover_controls as hover3d,
        make_quadrotor3d,
    )

    bp = {"scan": lambda e: backward_pass(e, 0.0),
          "pscan": lambda e: backward_pass_associative(e, 0.0)}
    for N in (4096, 131072):
        U = 0.1 * jnp.sin(jnp.linspace(0, 20.0, N))[:, None] * jnp.ones((1, 2))
        exp = expansion(sys_dp, 4, U)
        for name, f in bp.items():
            log(f"backward_{name}", steady(f, exp), n_x=4, N=N)

    sys_q = make_quadrotor(
        0.01, [1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.array([1.0, 1.0, 0.1, 0.1, 0.1, 0.1])),
        R=0.1 * jnp.eye(2),
        Q_f=jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0, 10.0, 10.0])))
    Q3, R3, Qf3 = default_weights()
    sys_q3 = make_quadrotor3d(0.02, [1.0, 1.0, 1.0] + [0.0] * 9, Q3, R3, Qf3)
    sys_ch = make_spring_chain(0.02, n_masses=16)
    N = 8192
    cases = [
        (sys_q, 6, jnp.broadcast_to(hover_controls(sys_q.params), (N, 2))),
        (sys_q3, 12, jnp.broadcast_to(hover3d(sys_q3.params), (N, 4))
         + 0.05 * jnp.sin(jnp.linspace(0, 40, N))[:, None]),
        (sys_ch, 32, 0.1 * jnp.sin(jnp.linspace(0, 10, 4096))[:, None]
         * jnp.ones((1, 16))),
    ]
    for sys_, n_x, U in cases:
        exp = expansion(sys_, n_x, U)
        for name, f in bp.items():
            log(f"backward_{name}", steady(f, exp, reps=3), n_x=n_x,
                N=U.shape[0])


def bench_stage_profile(sys_dp, N=500):
    """In-program per-stage cost of the DP solve: each stage repeated R
    times per iteration; (T(R) − T(1)) / ((R − 1)·iterations) is its
    in-context per-iteration time."""
    from ilqr_tpu.ops.rollout import linesearch_rollouts, rollout

    cfg = it.IlqrConfig(maxiter=200, tol=1e-6)
    x0, U0 = jnp.zeros(4), jnp.zeros((N, 2))
    n_it = int(jax.jit(lambda x, U: it.solve(sys_dp, x, U, cfg))(
        x0, U0).iterations)
    alphas = jnp.asarray(cfg.alpha_schedule())

    def rep(fn, R, *args):
        out = fn(*args)
        for _ in range(R - 1):
            # A real data dependency on the previous repetition keeps XLA
            # from hoisting the repeated stage out of the loop.
            eps = 1e-20 * sum(jnp.sum(l) for l in jax.tree_util.tree_leaves(
                out) if jnp.issubdtype(l.dtype, jnp.floating))
            first = jax.tree_util.tree_map(lambda a: a + eps, args[0])
            out = fn(first, *args[1:])
        return out

    def staged(reps):
        def run(x0_, U_init):
            X0, cost0 = rollout(sys_dp, x0_, U_init)

            def body(carry, _):
                X, U, cost = carry
                exp = rep(lambda XX, UU: linearize_trajectory(sys_dp, XX, UU),
                          reps.get("linearize", 1), X, U)
                u_ff, K, _, ok = rep(lambda e: backward_pass(e, 0.0),
                                     reps.get("backward", 1), exp)
                X_c, U_c, costs = rep(
                    lambda XX, UU, uf, KK: linesearch_rollouts(
                        sys_dp, x0_, alphas, XX, UU, uf, KK),
                    reps.get("linesearch", 1), X, U, u_ff, K)
                accept = (costs <= cost) & jnp.isfinite(costs) & ok
                i, any_a = jnp.argmax(accept), jnp.any(accept)
                return (jnp.where(any_a, X_c[i], X),
                        jnp.where(any_a, U_c[i], U),
                        jnp.where(any_a, costs[i], cost)), None

            (_, _, cost), _ = jax.lax.scan(body, (X0, U_init, cost0), None,
                                           length=n_it)
            return cost
        return run

    R = 4
    t_base = steady(staged({}), x0, U0)
    log("stage_total", t_base, N=N, iterations=n_it)
    for stage in ("linearize", "backward", "linesearch"):
        t_r = steady(staged({stage: R}), x0, U0)
        log(f"stage_{stage}_per_iter", max(t_r - t_base, 0.0) / (R - 1)
            / n_it, N=N)


def main():
    require_gpu(jax.default_backend())
    enable_compile_cache()
    dev = jax.devices()[0]
    card = card_lines()
    print(f"cards: {card}", file=sys.stderr, flush=True)

    from ilqr_tpu.mpc import run_mpc, run_mpc_batched, run_mpc_ms, run_mpc_rti
    from ilqr_tpu.ops.limited_parallel import backward_pass_limited_parallel
    from ilqr_tpu.ops.parallel_rollout import (
        linesearch_defect_rollouts,
        open_loop_defect_rollout,
    )
    from ilqr_tpu.ops.riccati import backward_pass_limited
    from ilqr_tpu.ops.rollout import linesearch_rollouts
    from ilqr_tpu.shooting import MsConfig, solve_ms

    sys_dp = double_pendulum()
    bench_backward(sys_dp)

    cfg = it.IlqrConfig(maxiter=200, tol=1e-6)
    log("solve_double_pendulum", steady(
        lambda x, U: it.solve(sys_dp, x, U, cfg).cost,
        jnp.zeros(4), jnp.zeros((500, 2))), N=500)
    bench_stage_profile(sys_dp)

    # Line search and initial rollout at N = 100k: sequential vs defect.
    N = 100_000
    U = jnp.zeros((N, 2))
    X, _ = jax.jit(lambda u: it.rollout(sys_dp, jnp.zeros(4), u))(U)
    exp = jax.jit(lambda x, u: linearize_trajectory(sys_dp, x, u))(X, U)
    uff, K, _, _ = jax.jit(lambda e: backward_pass(e, 0.0))(exp)
    alphas = jnp.asarray(cfg.alpha_schedule())
    log("linesearch_scan", steady(lambda X, U: linesearch_rollouts(
        sys_dp, jnp.zeros(4), alphas, X, U, uff, K)[2], X, U, reps=3), N=N)
    log("linesearch_defect", steady(lambda X, U: linesearch_defect_rollouts(
        sys_dp, jnp.zeros(4), alphas, X, U, uff, K, exp, iters=8)[2], X, U,
        reps=3), N=N)
    log("init_rollout_scan", steady(
        lambda u: it.rollout(sys_dp, jnp.zeros(4), u)[1], U, reps=3), N=N)
    log("init_rollout_defect", steady(lambda u: open_loop_defect_rollout(
        sys_dp, jnp.zeros(4), u, iters=8)[1], U, reps=3), N=N)

    # Control-limited backward: sequential boxQP vs frozen active set.
    N = 32768
    sys_pl = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2),
                              R=jnp.eye(1), Q_f=jnp.zeros((2, 2)), d=0.0,
                              integrator="rk4")
    U_lim = jnp.clip(2.5 * jnp.sin(jnp.linspace(0, 40, N))[:, None],
                     -2.0, 2.0)
    exp_lim = expansion(sys_pl, 2, U_lim)
    lo, hi = jnp.array([-2.0]), jnp.array([2.0])
    log("limited_backward_scan", steady(lambda e, u: backward_pass_limited(
        e, u, lo, hi, 0.0)[0], exp_lim, U_lim, reps=3), N=N)
    log("limited_backward_pscan", steady(
        lambda e, u: backward_pass_limited_parallel(e, u, lo, hi, 0.0)[0],
        exp_lim, U_lim, reps=3), N=N)

    # Long-horizon multiple shooting, every stage O(log N).
    N = 100_000
    cfg_ms = it.IlqrConfig(maxiter=60, tol=1e-5, backward="pscan",
                           init_rollout="defect")
    sys_p = it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                             Q_f=jnp.zeros((2, 2)), d=0.0, integrator="rk4")
    log("solve_ms", steady(lambda x: solve_ms(
        sys_p, x, jnp.zeros((N, 1)), config=cfg_ms,
        ms=MsConfig(update_engine="xla")).cost, jnp.array([1.0, 0.0]),
        reps=3), N=N)

    # Batched solves and batched closed-loop MPC.
    B, N = 1024, 128
    x0s = jnp.zeros((B, 4)).at[:, 0].add(jnp.linspace(0, 0.5, B))
    cfg_b = it.IlqrConfig(maxiter=10, tol=1e-5)
    log("batched_solve", steady(jax.vmap(lambda x0: it.solve(
        sys_dp, x0, jnp.zeros((N, 2)), cfg_b).cost), x0s), B=B, N=N)
    B, H, n_sim = 512, 64, 50
    x0m = jnp.zeros((B, 4)).at[:, 1].add(jnp.linspace(-0.3, 0.3, B))
    log("batched_mpc", steady(lambda xs: run_mpc_batched(
        sys_dp, sys_dp, xs, jnp.zeros((H, 2)), n_sim,
        it.IlqrConfig(maxiter=5, tol=1e-4)).cost, x0m, reps=3),
        B=B, H=H, n_sim=n_sim)

    # Single-instance MPC step (the reference's use case): per-step time.
    solver_sys, plant_sys = mpc_pendulum_pair()
    H, n_sim = 200, 400
    loops = {
        "full": (run_mpc, it.IlqrConfig(maxiter=10, tol=1e-5)),
        "rti": (run_mpc_rti, it.IlqrConfig(maxiter=1, tol=1e-5)),
        "ms_rti": (run_mpc_ms, it.IlqrConfig(maxiter=1, tol=1e-5)),
    }
    for mode, (loop, c) in loops.items():
        t = steady(lambda x, _l=loop, _c=c: _l(
            solver_sys, plant_sys, x, jnp.zeros((H, 1)), n_sim, _c).cost,
            jnp.zeros(2), reps=3)
        log(f"mpc_step_{mode}", t / n_sim, H=H, n_sim=n_sim)

    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "card": card, "metrics_ms": METRICS}))


if __name__ == "__main__":
    main()
