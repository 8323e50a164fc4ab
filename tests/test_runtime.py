"""Process set-up for the GPU: the compile cache, the device check, the smoke
script's contract line, the published-peak table and one card per process."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from medical_image_segmentation_tpu.core import runtime
from medical_image_segmentation_tpu.parallel import mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    sys.modules[name] = m  # dataclasses resolve annotations through it
    spec.loader.exec_module(m)
    return m


_CACHE_PROBE = textwrap.dedent("""
    import json, os
    import jax, jax.numpy as jnp
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache
    d = enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
    print(json.dumps({"dir": d, "config": jax.config.jax_compilation_cache_dir,
                      "entries": os.listdir(d)}))
""")


def _run_cache_probe(env_cache_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="true",
               PYTHONPATH=_ROOT)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache_dir
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class TestCompileCache:
    def test_env_dir_is_used_and_nothing_else_set(self, tmp_path):
        d = str(tmp_path / "cache")
        got = _run_cache_probe(d)
        assert got["dir"] == d and got["config"] == d
        assert got["entries"], "no cache entry written to JAX_COMPILATION_CACHE_DIR"

    def test_default_is_fixed_path_in_checkout(self):
        got = _run_cache_probe(None)
        want = os.path.join(_ROOT, "build", "jax_cache")
        assert got["dir"] == want == runtime.DEFAULT_COMPILE_CACHE_DIR
        assert got["config"] == want
        assert got["entries"], "no cache entry written to <repo>/build/jax_cache"


class TestDeviceCheck:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(SystemExit, match="no GPU"):
            runtime.require_gpu()

    def test_contract_line_has_exact_keys(self):
        smoke = _load("chip_smoke")
        line = json.loads(smoke.contract_line(runtime.device_record()))
        assert list(line) == ["ok", "device"] and line["ok"] is True
        assert list(line["device"]) == ["platform", "kind", "count"]
        assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 8

    def test_smoke_exits_nonzero_without_gpu(self, capsys):
        smoke = _load("chip_smoke")
        with pytest.raises(SystemExit) as e:
            smoke.main([])
        assert e.value.code not in (0, None)
        assert '"ok"' not in capsys.readouterr().out


def test_parity_check_sees_the_parameter_change():
    """``check_parity`` passes a step whose change matches to rounding, and
    fails one whose change points elsewhere or that moved nothing."""
    import numpy as np

    smoke = _load("chip_smoke")
    change = np.random.default_rng(0).normal(size=1000)
    rows = [("same", 1.0, 1.0, change * (1 + 1e-6), change),
            ("other direction", 1.0, 1.0, np.roll(change, 1), change),
            ("no step", 1.0, 1.0, np.zeros(1000), np.zeros(1000)),
            ("loss", 1.1, 1.0, change, change)]
    assert smoke.check_parity(rows) == ["other direction", "no step", "loss"]


class TestPeaks:
    def test_h100_peak_by_device_kind(self):
        bench = _load("bench")
        assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
        assert bench.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12

    def test_unknown_kind_raises(self):
        bench = _load("bench")
        with pytest.raises(KeyError, match="Quantum Abacus"):
            bench.peak_flops("Quantum Abacus")
        with pytest.raises(KeyError):
            bench.peak_flops(jax.devices()[0].device_kind)  # the CPU test mesh has no peak


def test_local_device_ids_from_local_rank(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("SLURM_LOCALID", raising=False)
    assert mesh.local_device_ids() is None
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert mesh.local_device_ids() == [3]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.local_device_ids() == [1]

    calls = []
    monkeypatch.setattr(mesh.jax.distributed, "initialize", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(mesh, "_DISTRIBUTED_DONE", False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    mesh.initialize_distributed()
    assert calls == [(("localhost:12345", 4, 1), {"local_device_ids": [1]})]
