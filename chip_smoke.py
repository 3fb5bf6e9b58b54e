"""Smoke run of the iLQR main path on an NVIDIA GPU, checked against references.

One process, one card.  Every phase drives the entry points a user calls, at
the reference scripts' own sizes, and compares the result with a plain
reference computed in the same process:

  a. `ilqr_tpu.solve` — double-pendulum swing-up at the upstream settings
     (N=500, maxiter=200, tol=1e-6, 'auto' engines) — against the f64
     sequential solve on the host CPU (`utils.x64.enable_x64_oracle`);
  b. `run_mpc`, `run_mpc_rti` and `run_mpc_ms(maxiter=1)` — pendulum MPC,
     H=200, 400 steps, backward-Euler solver model, midpoint plant —
     against the same loops in f32 on the host CPU;
  c. `parallel.solve_batched` — B=1024 double pendulums, N=128 — against
     per-instance CPU solves of eight spread instances;
  d. the parallel-in-time engines (associative backward, chunked line
     search, defect initial rollout; `solve_ms` with the associative update
     at N=100k) against the sequential engines, both on the GPU.

``--devices 4`` runs only the multi-GPU path and what it is compared with:
batch-sharded `solve_batched` and `run_mpc_sharded`, and the horizon-sharded
`solve_ms_horizon_sharded`, each against the same call on one card.

Run:  python chip_smoke.py                # one GPU
      python chip_smoke.py --devices 4    # four GPUs of one host

Without a GPU it exits non-zero and prints no result.  Each phase prints one
JSON line (compile and steady seconds, each error beside its tolerance, the
matmul precision); the last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import ilqr_tpu as it
from ilqr_tpu.utils.compile_cache import enable_compile_cache
from ilqr_tpu.utils.x64 import enable_x64_oracle

# The solver traces every entry point under `models.base.f32_matmuls`.
MATMUL_PRECISION = "highest (f32_matmuls)"


def require_gpu(backend: str) -> None:
    """Refuse to run anywhere but an NVIDIA GPU: no CPU fallback."""
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs an NVIDIA GPU; JAX's default backend is "
            f"{backend!r}")


def max_abs_err(got, want) -> float:
    """max |got − want| in f64; +inf when either side is not finite."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    if g.shape != w.shape:
        raise ValueError(f"shape mismatch: {g.shape} vs {w.shape}")
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(w))):
        return float("inf")
    return float(np.max(np.abs(g - w))) if g.size else 0.0


def max_rel_err(got, want) -> float:
    """max |got − want| / |want| (elementwise, f64; +inf if not finite)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(w))):
        return float("inf")
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


class Phase:
    """Errors of one phase, each beside its tolerance."""

    def __init__(self, name: str):
        self.name = name
        self.record = {"phase": name}
        self.errors = {}

    def check(self, metric: str, err: float, tol: float) -> bool:
        self.errors[metric] = {"err": err, "tol": tol}
        return err <= tol

    def require(self, metric: str, ok: bool) -> None:
        """A boolean condition (e.g. solver status) recorded as err 0 / 1."""
        self.check(metric, 0.0 if ok else 1.0, 0.0)

    @property
    def ok(self) -> bool:
        return all(e["err"] <= e["tol"] for e in self.errors.values())

    def emit(self) -> None:
        out = dict(self.record, errors=self.errors, ok=self.ok,
                   matmul_precision=MATMUL_PRECISION)
        print(json.dumps(out), flush=True)


def compile_and_time(fn, *args, reps: int = 3):
    """AOT-compile ``jax.jit(fn)`` for ``args``, run once, then time ``reps``
    calls ended with `block_until_ready`.

    Returns (compiled, out, compile_s, steady_s) with steady_s the median.
    """
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return compiled, out, compile_s, float(np.median(ts))


def is_final(status) -> bool:
    """CONVERGED, or a line-search stop.  At an f32 optimum no candidate may
    lower the cost any more, so the line search can stop there before the
    |Δcost| test fires; the phases hold the optimum itself to the
    reference with their cost and trajectory tolerances."""
    return int(status) in (it.CONVERGED, it.LINESEARCH_FAILED)


def on_cpu(build, *arg_sets):
    """Reference run on the host CPU: ``build()`` makes the function (and the
    systems it closes over) inside the CPU context, and ``jax.jit`` of it
    runs once per argument tuple.  Returns the host outputs, in order."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fn = jax.jit(build())
        return [jax.device_get(fn(*jax.device_put(args, cpu)))
                for args in arg_sets]


# ---------------------------------------------------------------------------
# Systems (the reference scripts' configurations).
# ---------------------------------------------------------------------------

def double_pendulum(dtype=jnp.float32, dt=0.01):
    """Fully actuated double pendulum swing-up
    (`run_double_pendulum_open_loop.py:14-75` of the reference)."""
    a = lambda v: jnp.asarray(v, dtype)
    return it.make_double_pendulum(
        dt, a([jnp.pi, 0.0, 0.0, 0.0]),
        Q=jnp.diag(a([10.0, 10.0, 0.1, 0.1])), R=jnp.diag(a([0.1, 0.1])),
        Q_f=jnp.diag(a([1000.0, 1000.0, 100.0, 100.0])),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler")


def mpc_pendulum_pair():
    """Reference MPC configuration (`run_iLQR_MPC.py:16-75`): backward-Euler
    solver model, midpoint plant — a deliberate model mismatch."""
    mk = lambda integ: it.make_pendulum(
        0.01, [jnp.pi, 0.0], Q=jnp.diag(jnp.array([10.0, 1.0])),
        R=jnp.eye(1), Q_f=jnp.diag(jnp.array([10.0, 10.0])), d=0.0,
        integrator=integ)
    return mk("backward_euler"), mk("midpoint")


def long_pendulum():
    """The long-horizon multiple-shooting workload (rk4 pendulum swing-up)."""
    return it.make_pendulum(0.01, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.0, integrator="rk4")


def spread_x0s(B: int):
    return jnp.zeros((B, 4)).at[:, 0].add(jnp.linspace(0.0, 0.5, B))


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_a(N: int = 500, maxiter: int = 200):
    """Flagship open-loop solve against the f64 CPU oracle."""
    ph = Phase("a.solve_double_pendulum")
    sys_ = double_pendulum()
    cfg = it.IlqrConfig(maxiter=maxiter, tol=1e-6)
    solve = lambda x, U: it.solve(sys_, x, U, cfg)
    compiled, sol, t_c, t_s = compile_and_time(
        solve, jnp.zeros(4), jnp.zeros((N, 2)))
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    ph.record.update(
        N=N, maxiter=maxiter, compile_s=t_c, steady_s=t_s,
        iterations=int(sol.iterations), cost=float(sol.cost),
        memory_analysis=str(mem),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"))

    def build_f64():
        sys64 = double_pendulum(jnp.float64)
        return lambda x, U: it.solve(sys64, x, U, cfg)

    with enable_x64_oracle():
        ref, = on_cpu(build_f64, (np.zeros(4), np.zeros((N, 2))))
    ph.record.update(reference_cost_f64=float(ref.cost),
                     status=int(sol.status))
    # Tolerances of tests/test_x64_parity.py's f32-vs-f64 trajectory gate.
    ph.require("reference_converged", int(ref.status) == it.CONVERGED)
    ph.require("status_final", is_final(sol.status))
    ph.check("cost_rel", max_rel_err(sol.cost, ref.cost), 1e-5)
    ph.check("X_abs", max_abs_err(sol.X, ref.X), 2e-2)
    ph.check("U_abs", max_abs_err(sol.U, ref.U), 3e-2)
    ph.solution = sol  # phase d's sequential-engine baseline
    return ph


def phase_b(H: int = 200, n_sim: int = 400):
    """Reference MPC loops against the same loops on the CPU."""
    from ilqr_tpu.mpc import run_mpc, run_mpc_ms, run_mpc_rti

    cfg = it.IlqrConfig(maxiter=10, tol=1e-5)
    cfg_ms = it.IlqrConfig(maxiter=1, tol=1e-5)

    def loops():
        solver_sys, plant_sys = mpc_pendulum_pair()
        return {
            "run_mpc": lambda x, U: run_mpc(
                solver_sys, plant_sys, x, U, n_sim, cfg),
            "run_mpc_rti": lambda x, U: run_mpc_rti(
                solver_sys, plant_sys, x, U, n_sim, cfg),
            "run_mpc_ms": lambda x, U: run_mpc_ms(
                solver_sys, plant_sys, x, U, n_sim, cfg_ms),
        }

    goal = np.array([np.pi, 0.0])
    phases = []
    for name, loop in loops().items():
        ph = Phase(f"b.{name}")
        x0, U0 = jnp.zeros(2), jnp.zeros((H, 1))
        _, res, t_c, t_s = compile_and_time(loop, x0, U0, reps=1)
        ref, = on_cpu(lambda n=name: loops()[n], (np.zeros(2),
                                                  np.zeros((H, 1))))
        ph.record.update(H=H, n_sim=n_sim, compile_s=t_c, steady_s=t_s,
                         steady_ms_per_step=1e3 * t_s / n_sim,
                         cost=float(res.cost), reference_cost_cpu=float(
                             ref.cost))
        ph.check("final_state_abs", max_abs_err(res.X[-1], goal), 1e-2)
        ph.check("cost_rel_vs_cpu", max_rel_err(res.cost, ref.cost), 1e-3)
        phases.append(ph)
    return phases


def phase_c(B: int = 1024, N: int = 128, n_check: int = 8):
    """Batched solves against per-instance CPU solves."""
    from ilqr_tpu.parallel.batch import solve_batched

    ph = Phase("c.solve_batched")
    sys_ = double_pendulum()
    cfg = it.IlqrConfig(maxiter=10, tol=1e-5)
    x0s = spread_x0s(B)
    U0 = jnp.zeros((N, 2))
    _, sols, t_c, t_s = compile_and_time(
        lambda xs, U: solve_batched(sys_, xs, U, cfg), x0s, U0)
    idx = np.linspace(0, B - 1, n_check).astype(int)

    def build_single():
        sys_cpu = double_pendulum()
        return lambda x, U: it.solve(sys_cpu, x, U, cfg).cost

    ref = np.asarray(on_cpu(build_single, *[
        (np.asarray(x0s[i]), np.zeros((N, 2))) for i in idx]))
    ph.record.update(B=B, N=N, compile_s=t_c, steady_s=t_s,
                     solves_per_s=B / t_s, checked_instances=idx.tolist())
    ph.require("all_finite", bool(np.all(np.isfinite(np.asarray(sols.cost)))))
    ph.check("cost_rel_vs_cpu", max_rel_err(np.asarray(sols.cost)[idx], ref),
             1e-4)
    return ph


def phase_d(seq_sol, N: int = 500, N_ms: int = 100_000):
    """Parallel-in-time engines against the sequential ones, on the GPU."""
    from ilqr_tpu.shooting import MsConfig, solve_ms

    phases = []
    sys_ = double_pendulum()
    x0, U0 = jnp.zeros(4), jnp.zeros((N, 2))
    engines = {
        "pscan_chunked": it.IlqrConfig(maxiter=200, tol=1e-6,
                                       backward="pscan", rollout="chunked"),
        "pscan_defect_init": it.IlqrConfig(maxiter=200, tol=1e-6,
                                           backward="pscan",
                                           init_rollout="defect"),
    }
    for name, cfg in engines.items():
        ph = Phase(f"d.solve_{name}")
        _, sol, t_c, t_s = compile_and_time(
            lambda x, U, c=cfg: it.solve(sys_, x, U, c), x0, U0)
        ph.record.update(N=N, compile_s=t_c, steady_s=t_s,
                         iterations=int(sol.iterations), cost=float(sol.cost),
                         status=int(sol.status))
        ph.require("status_final", is_final(sol.status))
        ph.check("cost_rel_vs_seq", max_rel_err(sol.cost, seq_sol.cost),
                 1e-5)
        ph.check("X_abs_vs_seq", max_abs_err(sol.X, seq_sol.X), 2e-2)
        ph.check("U_abs_vs_seq", max_abs_err(sol.U, seq_sol.U), 3e-2)
        phases.append(ph)

    sys_p = long_pendulum()
    cfg_ms = it.IlqrConfig(maxiter=60, tol=1e-5, backward="pscan",
                           init_rollout="defect")
    xp, Up = jnp.array([1.0, 0.0]), jnp.zeros((N_ms, 1))
    out = {}
    for engine in ("seq", "xla"):
        ms = MsConfig(update_engine=engine)
        _, out[engine], t_c, t_s = compile_and_time(
            lambda x, U, m=ms: solve_ms(sys_p, x, U, config=cfg_ms, ms=m),
            xp, Up, reps=1)
        out[engine + "_times"] = (t_c, t_s)
    ph = Phase("d.solve_ms_xla_vs_seq")
    sol, ref = out["xla"], out["seq"]
    ph.record.update(
        N=N_ms, compile_s=out["xla_times"][0], steady_s=out["xla_times"][1],
        seq_compile_s=out["seq_times"][0], seq_steady_s=out["seq_times"][1],
        iterations=int(sol.iterations), seq_iterations=int(ref.iterations),
        cost=float(sol.cost), seq_cost=float(ref.cost),
        defect=float(sol.defect))
    ph.require("status_converged", int(sol.status) == it.CONVERGED
               and int(ref.status) == it.CONVERGED)
    ph.check("cost_rel_vs_seq", max_rel_err(sol.cost, ref.cost), 1e-4)
    ph.check("defect", float(sol.defect), 1e-4)
    phases.append(ph)
    return phases


def phase_e(devices, B: int = 1024, N: int = 128, B_mpc: int = 512,
            H_mpc: int = 64, n_sim: int = 50, N_h: int = 10_000):
    """Batch- and horizon-sharded paths over ``devices`` against the same
    calls on one device."""
    from ilqr_tpu.parallel.batch import run_mpc_sharded, solve_batched
    from ilqr_tpu.parallel.horizon_solve import solve_ms_horizon_sharded
    from ilqr_tpu.parallel.mesh import make_mesh

    D = len(devices)
    one = [devices[0]]
    phases = []
    sys_ = double_pendulum()

    ph = Phase(f"e.solve_batched_{D}dev")
    cfg = it.IlqrConfig(maxiter=10, tol=1e-5)
    x0s, U0 = spread_x0s(B), jnp.zeros((N, 2))
    mesh = make_mesh({"batch": D}, devices=devices)
    _, sh, t_c, t_s = compile_and_time(
        lambda xs, U: solve_batched(sys_, xs, U, cfg, mesh=mesh), x0s, U0)
    _, ref, r_c, r_s = compile_and_time(
        lambda xs, U: solve_batched(sys_, xs, U, cfg), x0s, U0)
    ph.record.update(B=B, N=N, compile_s=t_c, steady_s=t_s,
                     one_device_steady_s=r_s, speedup=r_s / t_s)
    ph.check("cost_rel_vs_1dev", max_rel_err(sh.cost, ref.cost), 1e-4)
    phases.append(ph)

    ph = Phase(f"e.run_mpc_sharded_{D}dev")
    cfg_m = it.IlqrConfig(maxiter=5, tol=1e-4)
    x0m = jnp.zeros((B_mpc, 4)).at[:, 1].add(jnp.linspace(-0.3, 0.3, B_mpc))
    Um = jnp.zeros((H_mpc, 2))
    _, sh, t_c, t_s = compile_and_time(
        lambda xs, U: run_mpc_sharded(sys_, sys_, xs, U, n_sim, cfg_m,
                                      mesh=mesh), x0m, Um, reps=2)
    _, ref, r_c, r_s = compile_and_time(
        lambda xs, U: run_mpc_sharded(sys_, sys_, xs, U, n_sim, cfg_m),
        x0m, Um, reps=2)
    ph.record.update(B=B_mpc, H=H_mpc, n_sim=n_sim, compile_s=t_c,
                     steady_s=t_s, one_device_steady_s=r_s,
                     speedup=r_s / t_s)
    ph.check("cost_rel_vs_1dev", max_rel_err(sh.cost, ref.cost), 1e-4)
    phases.append(ph)

    ph = Phase(f"e.solve_ms_horizon_sharded_{D}dev")
    sys_p = long_pendulum()
    cfg_h = it.IlqrConfig(maxiter=60, tol=1e-5)
    xp, Up = jnp.array([1.0, 0.0]), jnp.zeros((N_h, 1))
    mesh_t = make_mesh({"time": D}, devices=devices)
    mesh_1 = make_mesh({"time": 1}, devices=one)
    _, sh, t_c, t_s = compile_and_time(
        lambda x, U: solve_ms_horizon_sharded(sys_p, x, U, cfg_h, mesh_t),
        xp, Up, reps=1)
    _, ref, r_c, r_s = compile_and_time(
        lambda x, U: solve_ms_horizon_sharded(sys_p, x, U, cfg_h, mesh_1),
        xp, Up, reps=1)
    X, _, cost, iters, status = sh
    X1, _, cost1, iters1, status1 = ref
    ph.record.update(N=N_h, compile_s=t_c, steady_s=t_s,
                     one_device_steady_s=r_s, speedup=r_s / t_s,
                     iterations=int(iters), one_device_iterations=int(iters1),
                     cost=float(cost))
    ph.require("status_converged", int(status) == it.CONVERGED
               and int(status1) == it.CONVERGED)
    ph.check("cost_rel_vs_1dev", max_rel_err(cost, cost1), 1e-4)
    ph.check("X_abs_vs_1dev", max_abs_err(X, X1), 1e-3)
    phases.append(ph)
    return phases


# ---------------------------------------------------------------------------

def card_lines() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return proc.stdout.strip() or proc.stderr.strip()


def run_phase(fn, failures):
    """Run one phase; print its records.  A raised error is printed and
    counted as a failure — the script still exits non-zero."""
    try:
        out = fn()
    except Exception:  # report, then fail the whole run at the end
        traceback.print_exc()
        failures.append(getattr(fn, "__name__", str(fn)))
        return None
    for ph in (out if isinstance(out, list) else [out]):
        ph.emit()
        if not ph.ok:
            failures.append(ph.name)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: phases a-d on one GPU; 4: only the sharded "
                         "multi-GPU path (phase e)")
    args = ap.parse_args(argv)
    require_gpu(jax.default_backend())
    devices = jax.devices()
    if len(devices) < args.devices:
        raise SystemExit(f"--devices {args.devices} needs that many GPUs; "
                         f"JAX sees {len(devices)}")

    cache = enable_compile_cache()
    print(f"cards: {card_lines()}", flush=True)
    print(f"jax {jax.__version__}; "
          f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '')!r}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {cache}; devices {devices}", flush=True)

    failures = []
    t0 = time.perf_counter()
    if args.devices > 1:
        run_phase(lambda: phase_e(devices[:args.devices]), failures)
    else:
        a = run_phase(phase_a, failures)
        run_phase(phase_b, failures)
        run_phase(phase_c, failures)
        if a is not None:
            run_phase(lambda: phase_d(a.solution), failures)
        else:
            failures.append("d (needs phase a)")
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        print(f"FAILED: {failures}", file=sys.stderr, flush=True)
        return 1
    dev = devices[0]
    count = args.devices if args.devices > 1 else len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
