"""Test configuration: run everything on an 8-device virtual CPU mesh.

Tests run on the CPU backend with 8 virtual devices, so sharding and
collectives are exercised without accelerator hardware (SURVEY.md §4).  An
explicit ``JAX_PLATFORMS`` is honoured: the GPU-only tests (`-m gpu`,
tests/test_gpu.py) run on a card with ``JAX_PLATFORMS=cuda,cpu``.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# NOTE: do NOT enable the persistent compilation cache here.  On this jaxlib
# the XLA:CPU AOT (de)serialization is unreliable for some executables:
# reading entries compiled on a host with different CPU features aborts the
# process, and writing entries for mesh-sharded programs aborts too
# ("Fatal Python error: Aborted" in compilation_cache.put/get_executable_
# and_time).  The suite pays recompilation instead of risking hard aborts.

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap per-process accumulated XLA:CPU compile state.

    XLA:CPU codegen on this jaxlib segfaults DETERMINISTICALLY once enough
    compiled programs accumulate in one process (see NOTES.md); dropping
    live executables between test modules keeps each pytest-xdist worker
    far below the crash threshold at the cost of some recompilation.
    """
    yield
    jax.clear_caches()
