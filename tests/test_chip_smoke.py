"""chip_smoke.py on the CPU: every phase run small, the device check
(refuses anything but a GPU) and the compile-cache helper."""
import os
import shutil
import subprocess
import sys

import pytest

import jax

import chip_smoke as cs
from pyamg_tpu import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        cs.device_check()
    assert e.value.code not in (0, None)


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_exits_nonzero_without_gpu():
    p = _run_script(ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_script_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run_script(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_operators_small():
    out = cs.phase_operators(48)
    for name in ("float32", "float64"):
        assert set(out[name]) >= {"dia_matvec", "jacobi_sweep",
                                  "structured_P", "hostbuilt_R",
                                  "dense_coarse"}
    assert out["restriction"]["gather_bitwise_repeat"]


def test_phase_host_built_small():
    res = cs.phase_host_built(48)
    assert res["histories_identical"]
    assert abs(res["iterations"] - res["host_iterations"]) <= 1


def test_phase_device_built_small():
    res = cs.phase_device_built(48)
    assert res["true_relres"] <= 1e-8


def test_phase_backend_device_small():
    res = cs.phase_backend_device(48)
    assert res["true_relres"] <= 1e-8


def test_phase_batched_small():
    res = cs.phase_batched(48, K=3)
    assert res["max_iteration_diff"] <= 1
    assert len(res["iterations"]) == 3


def test_phase_other_setups_small():
    res = cs.phase_other_setups(n_elastic=24, n_recirc=48, n_mesh=40)
    assert set(res) == {"block_elasticity", "rs_recirc",
                        "unstructured_p1"}


def test_phase_multi_small():
    assert len(jax.devices()) >= 4          # conftest: 8 CPU devices
    res = cs.phase_multi(96, ndev=4)
    assert res["history_max_rel_diff"] <= 1e-9
    assert res["level_device_counts"] == [4] * len(
        res["level_device_counts"])


def test_compile_cache_honours_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert calls == []


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert path == compile_cache.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)] * 2
