"""Projected-HBM guard (`core/hbm.py`): pin XLA's static memory plan on the
virtual 8-device mesh and the refuse/force semantics of the pre-run check.

On the GPU a program that does not fit fails to allocate when it runs, so
trainers/benches consult `compiled.memory_analysis()` against the device's
`memory_stats()["bytes_limit"]` before the first step. The reference
framework (torch) cannot express this check at all; these tests pin the
estimate the guard is built on.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from medical_image_segmentation_tpu.core import hbm
from medical_image_segmentation_tpu.parallel.mesh import data_sharding, make_mesh


class TestMemoryAnalysis:
    def test_pins_argument_and_output_bytes(self):
        """XLA's plan must account exactly for a known program's IO: two
        1024x1024 f32 args (8 MiB) in, one out (4 MiB)."""

        @jax.jit
        def f(x, y):
            return x @ y

        x = jnp.zeros((1024, 1024), jnp.float32)
        mem = hbm.memory_analysis_of(f.lower(x, x).compile())
        assert mem is not None
        assert mem["arguments"] == 2 * 1024 * 1024 * 4
        assert mem["outputs"] == 1024 * 1024 * 4
        assert mem["projected_peak"] >= mem["arguments"] + mem["outputs"] - mem["aliased"]

    def test_sharded_plan_is_per_device(self):
        """On the virtual 8-device mesh, a batch-sharded argument must appear
        in the plan at its PER-DEVICE shard size — the quantity that actually
        competes for one chip's HBM — not the global array size."""
        mesh = make_mesh()
        assert mesh.devices.size == 8

        @jax.jit
        def g(x):
            return (x * 2.0).sum()

        xs = jax.device_put(
            jnp.zeros((8, 256, 256), jnp.float32), NamedSharding(mesh, P("data"))
        )
        mem = hbm.memory_analysis_of(g.lower(xs).compile())
        assert mem is not None
        assert mem["arguments"] == 256 * 256 * 4  # one shard, not 8

    def test_donation_shows_as_alias_and_lowers_peak(self):
        """Donated inputs are reused for outputs; the projected peak must
        credit them (this is why the trainers' donated task steps fit)."""
        x = jnp.zeros((512, 512), jnp.float32)
        plain = hbm.memory_analysis_of(jax.jit(lambda x: x + 1).lower(x).compile())
        donated = hbm.memory_analysis_of(
            jax.jit(lambda x: x + 1, donate_argnums=0).lower(x).compile()
        )
        assert donated["aliased"] == 512 * 512 * 4
        assert plain["aliased"] == 0
        assert donated["projected_peak"] < plain["projected_peak"]

    def test_hbm_report_on_cpu_has_no_capacity(self):
        """The virtual CPU mesh exposes no capacity: the guard must report the
        plan but never refuse (trainers skip the check on CPU backends)."""

        @jax.jit
        def f(x):
            return x * 2

        mem = hbm.hbm_report(f, jnp.zeros((16, 16), jnp.float32))
        assert mem is not None
        assert mem["capacity"] is None
        assert mem["oversubscribed"] is False
        hbm.check_hbm(mem, force=False)  # must not raise


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestCapacityTable:
    def test_capacity_from_gpu_memory_stats(self):
        """The allocator limit the runtime reports is the capacity — no
        per-device-kind table; a device that reports none has no capacity."""
        stats = {"bytes_in_use": 0, "bytes_limit": 63_763_120_128}
        assert hbm.device_hbm_capacity(_FakeGpu(stats)) == 63_763_120_128
        assert hbm.device_hbm_capacity(_FakeGpu({})) is None
        assert hbm.device_hbm_capacity(_FakeGpu(None)) is None
        assert not hasattr(hbm, "_KNOWN_HBM_BYTES")

    def test_device_capacity_none_on_cpu(self):
        assert hbm.device_hbm_capacity() is None


class TestCheckSemantics:
    def _report(self, peak, cap):
        return {
            "temp": peak,
            "arguments": 0,
            "outputs": 0,
            "aliased": 0,
            "projected_peak": peak,
            "capacity": cap,
            "oversubscribed": cap is not None and peak > cap,
        }

    def test_refuses_when_oversubscribed(self):
        with pytest.raises(SystemExit, match="REFUSING"):
            hbm.check_hbm(self._report(20 << 30, 16 << 30), label="seg3d step")

    def test_force_downgrades_to_warning(self):
        hbm.check_hbm(self._report(20 << 30, 16 << 30), force=True)  # no raise

    def test_fitting_and_unknown_pass(self):
        hbm.check_hbm(self._report(8 << 30, 16 << 30))
        hbm.check_hbm(None)  # backend without the analysis: silently accepted

    def test_format_names_the_components(self):
        s = hbm.format_hbm_report(self._report(2 << 30, 16 << 30), label="x step")
        assert "x step" in s and "2.00 GiB" in s and "16.00 GiB" in s


class TestGuardStep:
    """`guard_step` — the one-call wrapper all four trainers now share
    (train_ssl, train_segmentation, train_ssl3d, train_segmentation3d)."""

    def _step(self):
        @jax.jit
        def f(x):
            return (x * 2.0).sum()

        return f, (jnp.zeros((64, 64), jnp.float32),)

    def test_skip_short_circuits_without_compiling(self, monkeypatch):
        f, args = self._step()

        def boom(*a, **k):
            raise AssertionError("guard compiled despite skip=True")

        monkeypatch.setattr(hbm, "hbm_report", boom)
        assert hbm.guard_step(f, args, skip=True) is None

    def test_noop_when_capacity_unknown(self):
        # CPU test mesh: capacity is None -> no compile, no refusal
        f, args = self._step()
        assert hbm.guard_step(f, args) is None

    def test_refuses_and_forces_under_fake_capacity(self, monkeypatch):
        f, args = self._step()
        monkeypatch.setattr(hbm, "device_hbm_capacity", lambda: 1024)
        with pytest.raises(SystemExit, match="REFUSING"):
            hbm.guard_step(f, args, label="tiny step")
        mem = hbm.guard_step(f, args, label="tiny step", force=True)
        assert mem is not None and mem["oversubscribed"] is True

    def test_accepts_shape_dtype_specs(self, monkeypatch):
        # trainers pass ShapeDtypeStructs, not concrete arrays
        monkeypatch.setattr(hbm, "device_hbm_capacity", lambda: 1 << 40)
        f, _ = self._step()
        spec = jax.ShapeDtypeStruct((64, 64), jnp.float32)
        mem = hbm.guard_step(f, (spec,), label="spec step")
        assert mem is not None and mem["oversubscribed"] is False


class TestTrainerGuardWiring:
    """Every trainer CLI must expose the guard's flags — the r4 gap was the
    guard protecting only one of four entry points."""

    @pytest.mark.parametrize("mod", [
        "medical_image_segmentation_tpu.train.train_ssl",
        "medical_image_segmentation_tpu.train.train_segmentation",
        "medical_image_segmentation_tpu.train.train_ssl3d",
        "medical_image_segmentation_tpu.train.train_segmentation3d",
    ])
    def test_flags_exposed(self, mod):
        import importlib

        m = importlib.import_module(mod)
        src = open(m.__file__).read()
        assert "--skip_hbm_check" in src and "--force_hbm" in src
        assert "guard_step" in src


class TestSeg3dGuardIntegration:
    def test_guard_predicts_oversubscription_on_virtual_mesh(self, monkeypatch):
        """End-to-end shape of the trainer guard: AOT-compile the real seg3d
        train step on the 8-device mesh, then impose a tiny fake capacity —
        the same report that passes at honest capacity must flip to
        oversubscribed and be refused. Pins that the guard sees real per-chip
        numbers (nonzero temps, sharded args) for the actual donated step."""
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        mesh = make_mesh()
        task = Segmentation3DTask(
            features=(4, 8), learning_rate=0.1, warmup_epochs=0, max_epochs=1,
            steps_per_epoch=1, dtype=jnp.float32,
        )
        crop = (8, 16, 16)
        state = task.init(jax.random.key(0), (1, *crop, 1))

        @jax.jit
        def train_step(state, x, y):
            return task.train_step(state, x, y)

        sh = data_sharding(mesh, ndim=5)
        x = jax.device_put(np.zeros((8, *crop, 1), np.float32), sh)
        y = jax.device_put(np.zeros((8, *crop, 1), np.float32), sh)
        mem = hbm.hbm_report(train_step, state, x, y)
        assert mem is not None
        assert mem["projected_peak"] > 0
        assert mem["arguments"] > 0

        # a fake 1 KiB device: the identical plan must now refuse
        monkeypatch.setattr(hbm, "device_hbm_capacity", lambda: 1024)
        mem2 = hbm.hbm_report(train_step, state, x, y)
        assert mem2["oversubscribed"] is True
        with pytest.raises(SystemExit, match="REFUSING"):
            hbm.check_hbm(mem2, label="seg3d train step")
        hbm.check_hbm(mem2, force=True)  # --force_hbm escape hatch
