"""Checks that need an NVIDIA GPU. They skip elsewhere (the fixture decides,
at run time); ``chip_smoke.py`` runs them on the card:

    MIS_TEST_ON_GPU=1 python -m pytest -m gpu tests/test_gpu.py
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


def _smoke():
    name = "chip_smoke"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def test_augment_default_precision_within_half_grey_level(gpu):
    """The view math at the card's default f32 matmul precision (TF32)
    against the CPU under "highest", on a small uint8 batch."""
    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu.ops.augment import two_view_augment

    dm = get_datamodule("RADIOLOGY_1M")()
    cfgs = dm.view_configs()
    raw = np.random.default_rng(3).integers(0, 256, size=(16, 256, 256, 1), dtype=np.uint8)
    key = jax.random.key(3)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        ref = two_view_augment(jax.device_put(key, cpu), jax.device_put(raw, cpu), *cfgs,
                               mean=dm.train_mean, std=dm.train_std, dtype=jnp.float32)
    got = two_view_augment(key, jax.device_put(raw, gpu), *cfgs,
                           mean=dm.train_mean, std=dm.train_std, dtype=jnp.float32)
    err = max(_smoke().view_error(np.asarray(g), np.asarray(r), c, dm.train_mean, dm.train_std)
              for g, r, c in zip(got, ref, cfgs))
    assert err < _smoke().TOL_GREY


def test_capacity_is_the_cards_allocator_limit(gpu):
    from medical_image_segmentation_tpu.core.hbm import device_hbm_capacity

    cap = device_hbm_capacity()
    assert cap == gpu.memory_stats()["bytes_limit"] and cap > 8 << 30


def test_bf16_byol_step_is_finite(gpu):
    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.train import BYOLTask

    task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=512, proj_dim=128, total_steps=10)
    state = task.init(jax.random.key(0), (2, 64, 64, 1))
    views = jax.random.normal(jax.random.key(1), (2, 8, 64, 64, 1))
    state, m = task.train_step(state, views[0], views[1])
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(state.params))
