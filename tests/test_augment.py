"""Golden tests for the on-device augmentation engine against OpenCV
(the reference's host-side resize path, `pytorch_datasets.py:140-144`)."""

import cv2
import jax
import pytest
import jax.numpy as jnp
import numpy as np

from medical_image_segmentation_tpu.ops.augment import (
    BYOL_VIEW1,
    BYOL_VIEW2,
    ViewConfig,
    _flip_cols,
    _nearest_matrix,
    _resize_matrix,
    apply_resample,
    augment_view,
    sample_rrc_window,
    segmentation_augment,
    two_view_augment,
)


def _rand_img(rng, h=64, w=64, c=3):
    return rng.integers(0, 256, size=(1, h, w, c)).astype(np.uint8)


class TestResizeMatmul:
    def test_full_window_resize_matches_cv2(self):
        rng = np.random.default_rng(0)
        img = _rand_img(rng, 64, 48, 3)
        out_h, out_w = 32, 24
        zeros = jnp.zeros((1,))
        r_y = _resize_matrix(zeros, jnp.full((1,), 64.0), 64, out_h)
        r_x = _resize_matrix(zeros, jnp.full((1,), 48.0), 48, out_w)
        ours = np.asarray(apply_resample(jnp.asarray(img, jnp.float32), r_y, r_x))[0]
        ref = cv2.resize(img[0], (out_w, out_h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(ours, ref.astype(np.float32), atol=1.0)

    def test_crop_window_resize_matches_cv2(self):
        rng = np.random.default_rng(1)
        img = _rand_img(rng, 64, 64, 1)
        # integer crop window so cv2 can reproduce it exactly
        y0, x0, h, w = 8, 16, 32, 40
        r_y = _resize_matrix(jnp.asarray([float(y0)]), jnp.asarray([float(h)]), 64, 16)
        r_x = _resize_matrix(jnp.asarray([float(x0)]), jnp.asarray([float(w)]), 64, 16)
        ours = np.asarray(apply_resample(jnp.asarray(img, jnp.float32), r_y, r_x))[0, :, :, 0]
        ref = cv2.resize(img[0, y0:y0 + h, x0:x0 + w, 0], (16, 16), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(ours, ref.astype(np.float32), atol=1.0)

    def test_flip_fold_equals_post_flip(self):
        rng = np.random.default_rng(2)
        img = jnp.asarray(_rand_img(rng, 32, 32, 1), jnp.float32)
        zeros = jnp.zeros((1,))
        r_y = _resize_matrix(zeros, jnp.full((1,), 32.0), 32, 16)
        r_x = _resize_matrix(zeros, jnp.full((1,), 32.0), 32, 16)
        plain = np.asarray(apply_resample(img, r_y, r_x))
        flipped = np.asarray(apply_resample(img, r_y, _flip_cols(r_x, jnp.asarray([True]))))
        np.testing.assert_allclose(flipped, plain[:, :, ::-1, :], atol=1e-4)

    def test_nearest_matrix_is_one_hot(self):
        m = np.asarray(_nearest_matrix(jnp.zeros((1,)), jnp.full((1,), 33.0), 33, 16))
        assert np.all(m.sum(axis=2) == 1.0)
        assert set(np.unique(m)) <= {0.0, 1.0}


class TestRRCSampling:
    def test_windows_in_bounds(self):
        y0, x0, h, w = sample_rrc_window(jax.random.key(0), 512, 224, 224)
        y0, x0, h, w = map(np.asarray, (y0, x0, h, w))
        assert (y0 >= 0).all() and (x0 >= 0).all()
        assert (y0 + h <= 224 + 1e-3).all() and (x0 + w <= 224 + 1e-3).all()
        area_frac = (h * w) / (224 * 224)
        assert area_frac.min() >= 0.05 and area_frac.max() <= 1.0 + 1e-6

    def test_aspect_ratio_range(self):
        _, _, h, w = sample_rrc_window(jax.random.key(1), 2048, 256, 256)
        ar = np.asarray(w / h)
        # clamping can push outside slightly; bulk must be in [0.75, 1.333]
        frac_in = np.mean((ar > 0.74) & (ar < 1.34))
        assert frac_in > 0.95


class TestViews:
    def test_two_view_shapes_and_normalization(self):
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.integers(0, 256, size=(4, 64, 64, 1)), jnp.uint8)
        cfg = ViewConfig(out_size=(32, 32))
        v1, v2 = two_view_augment(jax.random.key(0), img, cfg, cfg, mean=(57.9764,), std=(60.4759,), dtype=jnp.float32)
        assert v1.shape == (4, 32, 32, 1) and v2.shape == (4, 32, 32, 1)
        assert not np.allclose(np.asarray(v1), np.asarray(v2))  # independent crops

    def test_constant_image_normalizes_exactly(self):
        img = jnp.full((2, 32, 32, 1), 200, jnp.uint8)
        cfg = ViewConfig(out_size=(16, 16), hflip_prob=0.0, solarize_prob=0.0)
        v = augment_view(jax.random.key(0), img, cfg, mean=(100.0,), std=(50.0,), dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(v), (200.0 - 100.0) / 50.0, atol=1e-3)

    def test_solarize_always_on(self):
        img = jnp.full((1, 32, 32, 1), 200, jnp.uint8)  # 200 >= 128 → 55
        cfg = ViewConfig(out_size=(16, 16), hflip_prob=0.0, solarize_prob=1.0)
        v = augment_view(jax.random.key(1), img, cfg, mean=(0.0,), std=(1.0,), dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(v), 55.0, atol=1e-2)

    def test_grayscale_mixes_channels(self):
        rng = np.random.default_rng(4)
        img = jnp.asarray(rng.integers(0, 256, size=(1, 32, 32, 3)), jnp.uint8)
        cfg = ViewConfig(out_size=(16, 16), hflip_prob=0.0, grayscale_prob=1.0)
        v = np.asarray(augment_view(jax.random.key(2), img, cfg, mean=(0.0,) * 3, std=(1.0,) * 3, dtype=jnp.float32))
        np.testing.assert_allclose(v[..., 0], v[..., 1], atol=1e-3)
        np.testing.assert_allclose(v[..., 1], v[..., 2], atol=1e-3)

    def test_blur_smooths(self):
        rng = np.random.default_rng(5)
        img = jnp.asarray(rng.integers(0, 256, size=(1, 64, 64, 1)), jnp.uint8)
        base = ViewConfig(out_size=(32, 32), hflip_prob=0.0, crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0))
        blurred_cfg = ViewConfig(out_size=(32, 32), hflip_prob=0.0, crop_scale=(1.0, 1.0),
                                 crop_ratio=(1.0, 1.0), blur_prob=1.0)
        sharp = np.asarray(augment_view(jax.random.key(3), img, base, (0.0,), (1.0,), jnp.float32))
        blur = np.asarray(augment_view(jax.random.key(3), img, blurred_cfg, (0.0,), (1.0,), jnp.float32))
        assert np.var(np.diff(blur[0, :, :, 0], axis=0)) < np.var(np.diff(sharp[0, :, :, 0], axis=0))

    def test_byol_view_configs(self):
        assert BYOL_VIEW1.solarize_prob == 0.0
        assert BYOL_VIEW2.solarize_prob == 0.2


class TestSegmentationAugment:
    def test_shapes_and_binary_masks(self):
        rng = np.random.default_rng(6)
        img = jnp.asarray(rng.integers(0, 256, size=(2, 48, 48, 1)), jnp.uint8)
        msk = jnp.asarray((rng.random((2, 48, 48, 1)) > 0.5).astype(np.float32))
        out_img, out_msk = segmentation_augment(
            jax.random.key(0), img, msk, out_size=(32, 32), mean=(0.2,), std=(0.2,), dtype=jnp.float32
        )
        assert out_img.shape == (2, 32, 32, 1) and out_msk.shape == (2, 32, 32, 1)
        assert set(np.unique(np.asarray(out_msk))) <= {0.0, 1.0}

    def test_eval_mode_deterministic_and_matches_cv2(self):
        rng = np.random.default_rng(7)
        img_np = rng.integers(0, 256, size=(1, 48, 48, 1)).astype(np.uint8)
        msk_np = (rng.random((1, 48, 48, 1)) > 0.5).astype(np.float32)
        out_img, _ = segmentation_augment(
            jax.random.key(0), jnp.asarray(img_np), jnp.asarray(msk_np),
            out_size=(24, 24), mean=(0.0,), std=(1.0,), train=False, dtype=jnp.float32,
        )
        ref = cv2.resize(img_np[0, :, :, 0], (24, 24), interpolation=cv2.INTER_LINEAR) / 255.0
        np.testing.assert_allclose(np.asarray(out_img)[0, :, :, 0], ref, atol=0.02)

    def test_paired_flips_keep_alignment(self):
        """A mask equal to a thresholded image must stay aligned after the
        shared flip (the reference pairs flips at pytorch_datasets.py:284-293)."""
        rng = np.random.default_rng(8)
        img_np = rng.integers(0, 256, size=(8, 32, 32, 1)).astype(np.uint8)
        msk_np = (img_np > 127).astype(np.float32)
        out_img, out_msk = segmentation_augment(
            jax.random.key(4), jnp.asarray(img_np), jnp.asarray(msk_np),
            out_size=(32, 32), mean=(0.0,), std=(1.0,), train=True, dtype=jnp.float32,
        )
        out_img, out_msk = np.asarray(out_img), np.asarray(out_msk)
        for i in range(8):
            variants = [
                msk_np[i], msk_np[i, :, ::-1], msk_np[i, ::-1, :], msk_np[i, ::-1, ::-1],
            ]
            # identity resize → mask must be exactly one of the 4 flip variants
            matches = [np.array_equal(out_msk[i], v) for v in variants]
            assert any(matches), f"sample {i} mask is not a pure flip of its input"
            # and the image must have taken the SAME flip: brightest-quadrant
            # check is jitter-invariant (jitter is monotonic per-image)
            which = matches.index(True)
            img_v = [img_np[i], img_np[i, :, ::-1], img_np[i, ::-1, :], img_np[i, ::-1, ::-1]][which]
            q_ref = np.argmax([img_v[:16, :16].sum(), img_v[:16, 16:].sum(),
                               img_v[16:, :16].sum(), img_v[16:, 16:].sum()])
            oi = out_img[i, :, :, 0]
            q_out = np.argmax([oi[:16, :16].sum(), oi[:16, 16:].sum(),
                               oi[16:, :16].sum(), oi[16:, 16:].sum()])
            assert q_ref == q_out, f"sample {i}: image flip disagrees with mask flip"


class TestCTWindowing:
    def test_windowing_changes_contrast_only_when_on(self):
        rng = np.random.default_rng(10)
        img = jnp.asarray(rng.integers(0, 256, size=(2, 32, 32, 1)), jnp.uint8)
        base = ViewConfig(out_size=(32, 32), crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0),
                          hflip_prob=0.0)
        win = ViewConfig(out_size=(32, 32), crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0),
                         hflip_prob=0.0, window_prob=1.0,
                         window_level_range=(128.0, 128.0), window_width_range=(128.0, 128.0))
        a = np.asarray(augment_view(jax.random.key(5), img, base, (0.0,), (1.0,), jnp.float32))
        b = np.asarray(augment_view(jax.random.key(5), img, win, (0.0,), (1.0,), jnp.float32))
        # fixed window level=128 width=128: x -> clip((x-64)/128*255)
        expected = np.clip((a - 64.0) / 128.0 * 255.0, 0.0, 255.0)
        np.testing.assert_allclose(b, expected, atol=1e-2)

    def test_window_off_by_default(self):
        assert ViewConfig().window_prob == 0.0


class TestBlurMatrix:
    def test_rows_sum_to_one_and_symmetric(self):
        from medical_image_segmentation_tpu.ops.augment import _blur_matrix

        m = np.asarray(_blur_matrix(jax.random.key(0), 2, 32, kernel=23, prob=1.0,
                                    dtype=jnp.float32))
        np.testing.assert_allclose(m.sum(axis=2), 1.0, atol=1e-5)
        # interior rows mirror each other around the diagonal
        np.testing.assert_allclose(m[0, 16, 10:23], m[0, 16, 22:9:-1], atol=1e-5)


class TestMultiWindowChannels:
    """Fixed multi-window channel stacking (PAPERS.md 'View it like a
    radiologist'): each configured display window becomes an input channel,
    deterministically at train, eval, and serving."""

    def test_apply_hu_windows_values(self):
        from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

        x = jnp.asarray(np.linspace(0.0, 1.0, 11, dtype=np.float32)[None, :, None, None])
        out = np.asarray(apply_hu_windows(x, ((0.5, 0.5), (0.25, 0.1))))
        assert out.shape == (1, 11, 1, 2)
        # window (0.5, 0.5): lo=0.25 -> clip((x-0.25)/0.5)
        np.testing.assert_allclose(
            out[0, :, 0, 0], np.clip((np.linspace(0, 1, 11) - 0.25) / 0.5, 0, 1),
            atol=1e-6)
        # window (0.25, 0.1): saturates above 0.3
        assert out[0, -1, 0, 1] == 1.0 and out[0, 0, 0, 1] == 0.0
        # no-op when empty
        np.testing.assert_array_equal(np.asarray(apply_hu_windows(x, ())), np.asarray(x))

    def test_parse_hu_windows(self):
        import pytest

        from medical_image_segmentation_tpu.ops.augment import parse_hu_windows

        assert parse_hu_windows("96:160,40:80") == ((96/255, 160/255), (40/255, 80/255))
        with pytest.raises(ValueError, match="LEVEL:WIDTH"):
            parse_hu_windows("96")
        with pytest.raises(ValueError, match="width"):
            parse_hu_windows("96:0")
        with pytest.raises(ValueError, match="no windows"):
            parse_hu_windows(",")

    def test_segmentation_augment_stacks_channels(self):
        from medical_image_segmentation_tpu.ops.augment import segmentation_augment

        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, size=(2, 40, 40, 1)).astype(np.uint8)
        msks = (rng.random((2, 40, 40, 1)) < 0.3).astype(np.uint8)
        wins = ((0.4, 0.6), (0.2, 0.2), (0.7, 0.3))
        x, y = segmentation_augment(
            jax.random.key(0), jnp.asarray(imgs), jnp.asarray(msks),
            out_size=(32, 32), mean=(0.5,), std=(0.25,), train=False,
            dtype=jnp.float32, hu_windows=wins)
        assert x.shape == (2, 32, 32, 3) and y.shape == (2, 32, 32, 1)
        # channel c equals windowing the single-channel pipeline output
        base, _ = segmentation_augment(
            jax.random.key(0), jnp.asarray(imgs), jnp.asarray(msks),
            out_size=(32, 32), mean=(0.0,), std=(1.0,), train=False,
            dtype=jnp.float32)
        for c, (lv, wd) in enumerate(wins):
            want = (np.clip((np.asarray(base)[..., 0] - (lv - wd / 2)) / wd, 0, 1)
                    - 0.5) / 0.25
            np.testing.assert_allclose(np.asarray(x)[..., c], want, atol=1e-5)

    @pytest.mark.slow
    def test_seg_task_trains_on_windowed_input(self):
        """A 3-window U-Net takes a jitted train step and the loss is finite
        (the in_channels plumbing end-to-end at task level)."""
        from medical_image_segmentation_tpu.ops.augment import segmentation_augment
        from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

        rng = np.random.default_rng(1)
        task = SegmentationTask(arch="resnet18", n_classes=1, in_channels=3,
                                learning_rate=0.1, warmup_epochs=0, max_epochs=1,
                                steps_per_epoch=2, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (2, 32, 32, 3))
        imgs = jnp.asarray(rng.integers(0, 256, size=(2, 40, 40, 1)), jnp.uint8)
        msks = jnp.asarray((rng.random((2, 40, 40, 1)) < 0.3), jnp.uint8)
        x, y = segmentation_augment(jax.random.key(1), imgs, msks, out_size=(32, 32),
                                    mean=(0.5,), std=(0.25,), train=True,
                                    dtype=jnp.float32,
                                    hu_windows=((0.4, 0.6), (0.2, 0.2), (0.7, 0.3)))
        state, m = task.train_step(state, x, y)
        assert np.isfinite(float(m["train/loss"]))


class TestViewConfigs:
    def test_u16_scale_equivalence_xla_path(self):
        """The full XLA pipeline on (x*257 as u16, stats*257, value_max=65535)
        equals the u8 pipeline on x — augmentation semantics are depth-
        invariant by construction (datamodules.py::view_configs scaling)."""
        import dataclasses

        rng = np.random.default_rng(12)
        img8 = rng.integers(0, 256, size=(4, 48, 48, 1))
        img16 = (img8 * 257).astype(np.uint16)
        cfg8 = dataclasses.replace(
            BYOL_VIEW2, out_size=(32, 32), window_prob=0.5)
        cfg16 = dataclasses.replace(
            cfg8, value_max=65535.0, solarize_threshold=cfg8.solarize_threshold * 257,
            window_level_range=tuple(x * 257 for x in cfg8.window_level_range),
            window_width_range=tuple(x * 257 for x in cfg8.window_width_range))
        key = jax.random.key(7)
        v8 = two_view_augment(key, jnp.asarray(img8, jnp.uint8), cfg8, cfg8,
                              mean=(60.0,), std=(50.0,), dtype=jnp.float32)
        v16 = two_view_augment(key, jnp.asarray(img16), cfg16, cfg16,
                               mean=(60.0 * 257,), std=(50.0 * 257,), dtype=jnp.float32)
        for a, b in zip(v8, v16):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)

    def test_datamodule_recipe_selection(self):
        """--aug_recipe / --window_prob must actually change view_configs
        (round-1 verdict: BYOL_TV_* and window_prob were unreachable)."""
        from medical_image_segmentation_tpu.data.datamodules import get_datamodule

        dm = get_datamodule("CIFAR10")()
        v1, v2 = dm.view_configs()
        assert v1.blur_prob == 0.0 and v1.jitter_prob == 0.0
        dm.aug_recipe = "torchvision"
        v1, v2 = dm.view_configs()
        assert v1.blur_prob == 1.0 and v2.blur_prob == 0.1
        assert v1.jitter_prob == 0.8 and v1.brightness == 0.4
        assert v2.solarize_prob == 0.2
        dm.window_prob = 0.3
        v1, _ = dm.view_configs()
        assert v1.window_prob == 0.3
        dm.aug_recipe = "nope"
        with pytest.raises(ValueError):
            dm.view_configs()
