"""Checks that need an NVIDIA GPU; they skip elsewhere.

Run on a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -n 0 -m gpu tests/test_gpu.py``.
Each mirrors a `chip_smoke.py` phase at a reduced size (the full-size run is
`python chip_smoke.py`).
"""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")


def test_solve_matches_f64_oracle(gpu):
    ph = chip_smoke.phase_a(N=200, maxiter=200)
    assert ph.ok, ph.errors


def test_mpc_loops_match_cpu(gpu):
    # Reaching the goal needs the full 400 ticks (chip_smoke phase b); at
    # this size only the agreement with the CPU loop is checked.
    for ph in chip_smoke.phase_b(H=100, n_sim=100):
        err = ph.errors["cost_rel_vs_cpu"]
        assert err["err"] <= err["tol"], (ph.name, ph.errors)


def test_batched_solve_matches_cpu(gpu):
    ph = chip_smoke.phase_c(B=128, N=64)
    assert ph.ok, ph.errors
