"""Smoke-run every example driver headlessly (VERDICT r3 item 7).

Each driver in `examples/` executes end-to-end in a fresh subprocess with
``ILQR_TPU_SMOKE=1`` (tiny horizons/iteration budgets via `examples/_smoke.py`)
on the CPU backend.  This is exactly the reference's informal verification
style formalized (`pendulum_sys.py:101-313` self-runs, SURVEY.md §4): the
drivers ARE the workload layer, so bit-rot there is product breakage.

Subprocess isolation (not in-process import) keeps each driver's XLA compile
state out of the test worker — the same per-process program-count ceiling
that shaped the xdist config (NOTES.md) — and faithfully exercises the
`__main__` entry.
"""
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # heavy tier: excluded from -m 'not slow'

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")

DRIVERS = sorted(
    f for f in os.listdir(EXAMPLES_DIR)
    if f.endswith(".py") and not f.startswith("_")
)


def test_driver_inventory():
    # Every driver is exercised; a new example auto-joins the smoke matrix.
    assert len(DRIVERS) == 21, DRIVERS


@pytest.mark.parametrize("driver", DRIVERS)
def test_example_smoke(driver):
    env = dict(os.environ)
    env.update(
        ILQR_TPU_SMOKE="1",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8",
        MPLBACKEND="Agg",
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, driver)],
        env=env, cwd=EXAMPLES_DIR, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{driver} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}"
    )
