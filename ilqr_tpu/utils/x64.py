"""Opt-in float64 oracle mode for parity gates (VERDICT r1 item 10).

The framework runs f32 on the accelerator (the reference runs f64 on CPU by default —
JAX's x64 flag off means the reference package actually ran f32 too, but the
MATLAB side and the CasADi/IPOPT cross-checks are genuine f64).  Constrained-
solver violation floors and Riccati association-order effects are therefore
claimed "realistic in f32" without a sharp oracle.  This module provides one:

    with enable_x64_oracle():
        sol64 = it.solve(build_system(jnp.float64), ...)

re-runs the SAME algorithm at double precision (on the CPU), so f32
results can be gated against a trusted high-precision solution instead of
against themselves.  Used by tests/test_smallmat.py (quadrotor oracle) and
tests/test_x64_parity.py.

Implementation notes: `jax.enable_x64` is a context manager over the dynamic
x64 config state; jitted functions retrace under it (dtypes are part of the
trace signature), so mixing f32 and f64 calls of the same solver is safe.
Inputs must be constructed INSIDE the context (or explicitly as f64) — the
context changes promotion/construction defaults, not existing arrays.
"""
from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def enable_x64_oracle():
    """Context manager enabling float64 semantics for oracle computations."""
    with jax.enable_x64(True):
        yield


def is_x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)
