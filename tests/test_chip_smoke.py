"""CPU-checkable parts of `chip_smoke.py` and the compile-cache helper."""
import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from ilqr_tpu.utils import compile_cache  # noqa: E402


@pytest.mark.parametrize("backend", ["cpu", "rocm", ""])
def test_device_check_refuses_non_gpu(backend):
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(backend)


def test_device_check_accepts_gpu():
    chip_smoke.require_gpu("gpu")


def test_main_on_cpu_exits_without_result(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("got,want,abs_err,rel_err", [
    ([1.0, 2.0], [1.0, 2.5], 0.5, 0.2),
    (3.0, 3.0, 0.0, 0.0),
    ([np.nan], [1.0], float("inf"), float("inf")),
    ([1.0], [np.inf], float("inf"), float("inf")),
])
def test_error_helpers(got, want, abs_err, rel_err):
    assert chip_smoke.max_abs_err(got, want) == pytest.approx(abs_err)
    assert chip_smoke.max_rel_err(got, want) == pytest.approx(rel_err)


def test_error_helper_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="shape"):
        chip_smoke.max_abs_err(np.zeros(3), np.zeros(4))


def test_phase_record_fails_on_any_error_above_tolerance(capsys):
    ph = chip_smoke.Phase("x")
    assert ph.check("cost_rel", 1e-6, 1e-5)
    ph.require("status", True)
    assert ph.ok
    assert not ph.check("X_abs", float("inf"), 2e-2)
    assert not ph.ok
    ph.emit()
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] is False
    assert line["errors"]["X_abs"]["tol"] == 2e-2


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else set


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    # Same path on every call: no pid, time or temporary name in it.
    assert compile_cache.enable_compile_cache() == path


def test_importing_the_package_leaves_the_cache_alone():
    # Only JAX's own reading of the environment variable may have set it.
    assert jax.config.jax_compilation_cache_dir in (
        None, "", os.environ.get(compile_cache.ENV_VAR))
