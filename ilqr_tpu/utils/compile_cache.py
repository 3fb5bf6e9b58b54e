"""Persistent XLA compilation cache for the repository's scripts.

MPC programs nest a while-loop solve inside a scan, and a cold compile of
one can take longer than the run it serves.  The launchers (`chip_smoke.py`,
`bench.py`, `examples/`) call `enable_compile_cache()` once at start-up so
a second run of the same program finds its executables on disk.  Importing
`ilqr_tpu` never enables the cache: library users keep their own settings.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# A fixed directory inside the checkout (listed in .gitignore).  The cache
# key includes the path, so the location never depends on the process, the
# time or a temporary name.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory `enable_compile_cache` uses: ``$JAX_COMPILATION_CACHE_DIR``
    when it is set, else `DEFAULT_DIR`."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is configured here.
    """
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
