"""The builders of `bench.py`'s timed paths (which `chip_smoke.py` also runs),
at small sizes on the CPU test mesh: each step runs and its outputs have the
expected shapes."""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

from medical_image_segmentation_tpu.parallel import make_mesh

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench", _BENCH)
    m = importlib.util.module_from_spec(spec)
    sys.modules["bench"] = m
    spec.loader.exec_module(m)
    return m


@pytest.mark.parametrize("precrop", [False, True])
def test_byol_case_steps_and_augments(bench, precrop):
    step, state, batch, augment = bench.byol_case(make_mesh(), batch_size=8, image_size=48,
                                                  crop_size=32, precrop=precrop)
    assert batch.shape == ((16, 32, 32, 1) if precrop else (8, 48, 48, 1))
    v1, v2 = augment(jax.random.key(0), batch)
    assert v1.shape == v2.shape == (8, 32, 32, 1)
    state, m = step(state, batch, jax.random.key(1))
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


@pytest.mark.parametrize("case", ["seg", "seg3d"])
def test_segmentation_cases_step(bench, case):
    mesh = make_mesh()
    if case == "seg":
        step, state, inputs = bench.seg_case(mesh, batch_size=8, image_size=32)
    else:
        step, state, inputs = bench.seg3d_case(mesh, batch_size=8, volume=(8, 16, 16),
                                               crop=(8, 8, 8), features=(4, 8))
    state, m = step(state, *inputs, jax.random.key(0))
    assert np.isfinite(float(m["train/loss"])) and int(state.step) == 1


def test_predict_cases_give_masks_and_logits(bench):
    predict, _, _, imgs = bench.predict_case(make_mesh(), batch_size=8, image_size=32)
    masks = np.asarray(predict(imgs))
    assert masks.shape == imgs.shape and set(np.unique(masks)) <= {0, 1}
    for sw_loop in (False, True):
        logits = np.asarray(bench.predict3d_case(batch_windows=2, volume=(8, 16, 16), window=(8, 8, 8),
                                                 features=(4, 8), sw_loop=sw_loop)())
        assert logits.shape[:3] == (8, 16, 16) and np.isfinite(logits).all()
