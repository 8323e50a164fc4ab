"""Volumetric (3D) segmentation path: model, paired augmentation, task,
volume dataset, and spatial sharding.

The reference has no 3D path at all (volumes are sliced to PNGs,
`slice_medical_decathlon_scans.py:55-83`); these tests pin the
beyond-reference implementation."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from medical_image_segmentation_tpu.models.unet3d import UNet3D, nearest_upsample_3d
from medical_image_segmentation_tpu.ops.augment3d import segmentation_augment_3d


class TestUNet3D:
    def test_logit_shape_and_dtype(self):
        model = UNet3D(features=(4, 8), in_channels=1, n_classes=1)
        x = jnp.zeros((2, 8, 16, 16, 1), jnp.float32)
        variables = model.init(jax.random.key(0), x, train=False)
        logits = model.apply(variables, x, train=False)
        assert logits.shape == (2, 8, 16, 16, 1)
        assert logits.dtype == jnp.float32

    def test_divisibility_error(self):
        model = UNet3D(features=(4, 8, 16))  # 2 downsamples → div by 4
        with pytest.raises(ValueError, match="divisible"):
            model.init(jax.random.key(0), jnp.zeros((1, 6, 8, 8, 1)), train=False)

    def test_groupnorm_has_no_batch_stats(self):
        model = UNet3D(features=(4, 8), norm="group")
        variables = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 8, 1)), train=True)
        assert "batch_stats" not in variables

    def test_batchnorm_collects_stats(self):
        model = UNet3D(features=(4, 8), norm="batch")
        variables = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 8, 1)), train=True)
        assert "batch_stats" in variables

    def test_nearest_upsample(self):
        x = jnp.arange(8, dtype=jnp.float32).reshape(1, 2, 2, 2, 1)
        up = nearest_upsample_3d(x)
        assert up.shape == (1, 4, 4, 4, 1)
        np.testing.assert_array_equal(np.asarray(up[0, :2, :2, :2, 0]),
                                      np.full((2, 2, 2), float(x[0, 0, 0, 0, 0])))

    def test_remat_numerically_identical(self):
        x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 8, 8, 8, 1)), jnp.float32)
        base = UNet3D(features=(4, 8), remat=False, dtype=jnp.float32)
        variables = base.init(jax.random.key(0), x, train=False)
        rem = UNet3D(features=(4, 8), remat=True, dtype=jnp.float32)
        np.testing.assert_allclose(
            np.asarray(base.apply(variables, x, train=False)),
            np.asarray(rem.apply(variables, x, train=False)), rtol=1e-6)


class TestAugment3D:
    def test_eval_is_center_crop_normalize(self):
        rng = np.random.default_rng(1)
        vols = rng.random((2, 8, 12, 12, 1)).astype(np.float32)
        msks = (rng.random((2, 8, 12, 12, 1)) > 0.5).astype(np.float32)
        x, y = segmentation_augment_3d(
            jax.random.key(0), jnp.asarray(vols), jnp.asarray(msks),
            out_size=(4, 8, 8), mean=(0.25,), std=(0.5,), train=False, dtype=jnp.float32)
        ref = vols[:, 2:6, 2:6 + 4, 2:6 + 4, :]
        np.testing.assert_allclose(np.asarray(x), (ref - 0.25) / 0.5, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(y), msks[:, 2:6, 2:6 + 4, 2:6 + 4, :])

    def test_train_flips_are_paired(self):
        """Image and mask must receive the SAME flips: feed a binary volume
        as both and recover the flip from the (monotonic) jittered image."""
        rng = np.random.default_rng(2)
        pat = (rng.random((3, 8, 8, 8, 1)) > 0.7).astype(np.float32)
        x, y = segmentation_augment_3d(
            jax.random.key(3), jnp.asarray(pat), jnp.asarray(pat),
            out_size=(8, 8, 8), mean=(0.0,), std=(1.0,), train=True, dtype=jnp.float32)
        # brightness/contrast jitter is monotonic and the pattern is binary,
        # so thresholding the image recovers exactly the flipped pattern
        xb = (np.asarray(x) > 0.4).astype(np.float32)
        np.testing.assert_array_equal(xb, np.asarray(y))
        # and the mask is some flip combination of the input
        assert any(
            np.array_equal(np.asarray(y[0, ..., 0]),
                           pat[0, ..., 0][::sd, ::sh, ::sw])
            for sd in (1, -1) for sh in (1, -1) for sw in (1, -1)
        )

    def test_train_crop_within_bounds_and_deterministic(self):
        rng = np.random.default_rng(3)
        vols = rng.random((4, 10, 12, 14, 1)).astype(np.float32)
        msks = (vols > 0.5).astype(np.float32)
        a = segmentation_augment_3d(jax.random.key(5), jnp.asarray(vols), jnp.asarray(msks),
                                    out_size=(4, 6, 8), train=True, dtype=jnp.float32)
        b = segmentation_augment_3d(jax.random.key(5), jnp.asarray(vols), jnp.asarray(msks),
                                    out_size=(4, 6, 8), train=True, dtype=jnp.float32)
        assert a[0].shape == (4, 4, 6, 8, 1)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))

    def test_too_small_volume_raises(self):
        with pytest.raises(ValueError, match="smaller than crop"):
            segmentation_augment_3d(
                jax.random.key(0), jnp.zeros((1, 4, 8, 8, 1)), jnp.zeros((1, 4, 8, 8, 1)),
                out_size=(8, 8, 8), train=True)


class TestVolumeDataset:
    @pytest.fixture
    def task_dir(self, tmp_path):
        from medical_image_segmentation_tpu.data.nifti import write_nifti

        rng = np.random.default_rng(0)
        (tmp_path / "imagesTr").mkdir()
        (tmp_path / "labelsTr").mkdir()
        for v in range(3):
            vol = rng.normal(100, 40, size=(12, 10, 6)).astype(np.float32)
            seg = np.zeros((12, 10, 6), np.uint8)
            seg[4:8, 3:7, :] = 1
            write_nifti(str(tmp_path / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
            write_nifti(str(tmp_path / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
        return tmp_path

    def test_shapes_normalization_pairing(self, task_dir):
        from medical_image_segmentation_tpu.data.volumes import DecathlonVolumeDataset

        ds = DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                    target_shape=(8, 16, 16))
        assert len(ds) == 3
        img, msk = ds[0]
        assert img.shape == (8, 16, 16, 1) and msk.shape == (8, 16, 16, 1)
        assert img.dtype == np.float32
        assert 0.0 <= img.min() and img.max() <= 1.0
        assert set(np.unique(msk)) <= {0.0, 1.0}
        # depth axis is the NIfTI z (last) axis: 6 z-slices pad to 8
        assert msk[0].sum() == 0 and msk[1].sum() > 0  # zero-padded leading slice

    def test_split_filter(self, task_dir):
        import json

        from medical_image_segmentation_tpu.data.volumes import DecathlonVolumeDataset

        split = {"train": ["la_000", "la_002"], "val": ["la_001"], "test": []}
        sf = task_dir / "split.json"
        sf.write_text(json.dumps(split))
        ds = DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                    target_shape=(8, 16, 16), split_file=str(sf), split="train")
        assert len(ds) == 2
        with pytest.raises(ValueError, match="no volume pairs"):
            DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                   target_shape=(8, 16, 16), split_file=str(sf), split="test")

    def test_ram_cache_identical_and_hit(self, task_dir):
        from medical_image_segmentation_tpu.data.volumes import (
            DecathlonVolumeDataset,
            UnlabeledVolumeDataset,
        )

        plain = DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                       target_shape=(8, 16, 16))
        cached = DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                        target_shape=(8, 16, 16), cache=True)
        for i in range(len(plain)):
            for a, b in zip(plain[i], cached[i]):
                np.testing.assert_array_equal(a, b)
        # second read comes from the cache (same objects, no re-decode)
        assert cached[1][0] is cached[1][0]
        assert len(cached._cache) == len(plain)

        u_plain = UnlabeledVolumeDataset(str(task_dir / "imagesTr"), target_shape=(8, 16, 16))
        u_cached = UnlabeledVolumeDataset(str(task_dir / "imagesTr"), target_shape=(8, 16, 16),
                                          cache=True)
        np.testing.assert_array_equal(u_plain[2][0], u_cached[2][0])
        assert u_cached[2][0] is u_cached[2][0]

    def test_loader_host_sharding_lockstep(self, task_dir):
        from medical_image_segmentation_tpu.data.volumes import DecathlonVolumeDataset, VolumeLoader

        ds = DecathlonVolumeDataset(str(task_dir / "imagesTr"), str(task_dir / "labelsTr"),
                                    target_shape=(8, 16, 16))
        l0 = VolumeLoader(ds, 1, num_hosts=2, host_id=0, seed=7)
        l1 = VolumeLoader(ds, 1, num_hosts=2, host_id=1, seed=7)
        assert len(l0) == len(l1)  # equalized shards step in lockstep
        n0 = sum(1 for _ in l0)
        n1 = sum(1 for _ in l1)
        assert n0 == n1 == len(l1)


class TestSeg3DTask:
    def test_train_step_learns_blob(self):
        """A few steps on a fixed blob should drive dice up and loss down."""
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        rng = np.random.default_rng(4)
        msk = np.zeros((2, 8, 16, 16, 1), np.float32)
        msk[:, 2:6, 4:12, 4:12] = 1.0
        vol = msk * 0.6 + rng.random(msk.shape).astype(np.float32) * 0.2

        task = Segmentation3DTask(features=(4, 8), learning_rate=0.3, warmup_epochs=0,
                                  max_epochs=100, min_lr=0.0, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 16, 16, 1))
        x, y = jnp.asarray(vol), jnp.asarray(msk)
        first = None
        for _ in range(12):
            state, m = task.train_step(state, x, y)
            if first is None:
                first = float(m["train/loss"])
        last = float(m["train/loss"])
        assert last < first
        ev = task.eval_step(state, x, y)
        assert float(ev["dice"]) > 0.5

    def test_batchnorm_variant_steps(self):
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        task = Segmentation3DTask(features=(4, 8), norm="batch", dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 8, 8, 1))
        assert state.batch_stats
        x = jnp.zeros((2, 8, 8, 8, 1))
        y = jnp.zeros((2, 8, 8, 8, 1))
        # snapshot before the step: train_step donates the state buffers
        leaves0 = [np.asarray(l) for l in jax.tree.leaves(state.batch_stats)]
        state2, m = task.train_step(state, x, y)
        assert np.isfinite(float(m["train/loss"]))
        # batch_stats actually updated
        leaves2 = jax.tree.leaves(state2.batch_stats)
        assert any(not np.allclose(a, b) for a, b in zip(leaves0, leaves2))


@pytest.mark.slow
def test_seg3d_spatial_sharding_parity():
    """Depth-sharded (data×space mesh) train step must match the
    single-device step bitwise-closely: GroupNorm reductions and 3D conv
    halos cross the shard boundary (GSPMD inserts the collectives)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from medical_image_segmentation_tpu.parallel import make_mesh
    from medical_image_segmentation_tpu.parallel.mesh import spatial_sharding
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

    devices = jax.devices()[:4]
    mesh = make_mesh(devices, axis_names=("data", "space"), axis_sizes=(2, 2))
    mesh1 = make_mesh(devices[:1])

    rng = np.random.default_rng(0)
    vol = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
    msk = (vol > 0.6).astype(np.float32)

    task = Segmentation3DTask(features=(4, 8), dtype=jnp.float32)

    def step(m, sharded):
        state = task.init(jax.random.key(0), (1, 8, 16, 16, 1))
        state = jax.device_put(state, NamedSharding(m, P()))
        if sharded:
            x = jax.device_put(jnp.asarray(vol), spatial_sharding(m, ndim=5))
            y = jax.device_put(jnp.asarray(msk), spatial_sharding(m, ndim=5))
        else:
            x, y = jnp.asarray(vol), jnp.asarray(msk)
        state, metrics = task.train_step(state, x, y)
        sq = sum(jnp.sum(jnp.square(l.astype(jnp.float32))) for l in jax.tree.leaves(state.params))
        return float(metrics["train/loss"]), float(jnp.sqrt(sq))

    loss_n, norm_n = step(mesh, True)
    loss_1, norm_1 = step(mesh1, False)
    assert abs(loss_n - loss_1) / max(abs(loss_1), 1e-12) < 2e-4
    assert abs(norm_n - norm_1) / max(abs(norm_1), 1e-12) < 2e-4


@pytest.mark.parametrize("slices_per_shard", [2, 4])
def test_depth_sharded_conv_gradient_matches(slices_per_shard):
    """A 3³ convolution's input and kernel gradients with the depth split
    over two shards match the unsharded ones, down to the two slices per
    shard that ``train_segmentation3d --space_shards`` keeps at the
    bottleneck (with one slice per shard XLA's input gradient is wrong)."""
    from medical_image_segmentation_tpu.parallel import make_mesh, replicated
    from medical_image_segmentation_tpu.parallel.mesh import spatial_sharding

    mesh = make_mesh(jax.devices()[:4], axis_names=("data", "space"), axis_sizes=(2, 2))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 2 * slices_per_shard, 4, 4, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8, 8)) * 0.1).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def loss(w, x, c):
        y = jax.lax.conv_general_dilated(x, w, (1, 1, 1), [(1, 1)] * 3,
                                         dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                                         precision="highest")
        return jnp.sum(y * c)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    want = grad(w, x, c)
    sh = spatial_sharding(mesh, ndim=5)
    got = grad(jax.device_put(w, replicated(mesh)), jax.device_put(x, sh), jax.device_put(c, sh))
    for g, r in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-5, atol=1e-5)


class TestPredict3D:
    def test_cli_serves_masks_from_checkpoint(self, tmp_path):
        """Train briefly, checkpoint, then serve masks for NIfTI volumes via
        the volumetric serving CLI — masks come back in source (X, Y, Z)
        axis order at native resolution."""
        from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint
        from medical_image_segmentation_tpu.data.nifti import read_nifti, write_nifti
        from medical_image_segmentation_tpu.train import predict3d
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        rng = np.random.default_rng(0)
        msk = np.zeros((2, 8, 16, 16, 1), np.float32)
        msk[:, 2:6, 4:12, 4:12] = 1.0
        vol = msk * 0.8 + rng.random(msk.shape).astype(np.float32) * 0.1
        task = Segmentation3DTask(features=(4, 8), learning_rate=0.3, warmup_epochs=0,
                                  max_epochs=100, min_lr=0.0, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 16, 16, 1))
        for _ in range(10):
            state, _ = task.train_step(state, jnp.asarray(vol), jnp.asarray(msk))
        ckpt_dir = str(tmp_path / "ckpt")
        save_checkpoint(ckpt_dir, jax.device_get(state), int(np.asarray(state.step)))

        img_d = tmp_path / "vols"
        img_d.mkdir()
        # native volume larger than the window, source order (X=20, Y=18, Z=10)
        nat = rng.random((20, 18, 10)).astype(np.float32) * 0.1
        nat[6:14, 5:13, 2:7] += 0.8
        write_nifti(str(img_d / "case_0.nii.gz"), nat)

        out_d = str(tmp_path / "masks")
        rc = predict3d.main([
            "--checkpoint", ckpt_dir, "--features", "4", "8",
            "--images_dir", str(img_d), "--output_dir", out_d,
            "--window", "8", "16", "16", "--mean", "0.0", "--std", "1.0", "--fp32",
        ])
        assert rc == 0
        out = read_nifti(os.path.join(out_d, "case_0_mask.nii.gz")).get_fdata()
        assert out.shape == (20, 18, 10)  # source axis order, native resolution
        assert set(np.unique(out)) <= {0.0, 1.0}


class TestBYOL3D:
    def test_two_view_augment_shapes_and_divergence(self):
        from medical_image_segmentation_tpu.ops.augment3d import byol_two_view_augment_3d

        rng = np.random.default_rng(7)
        vols = rng.random((2, 12, 16, 16, 1)).astype(np.float32)
        v1, v2 = byol_two_view_augment_3d(jax.random.key(0), jnp.asarray(vols),
                                          out_size=(8, 8, 8), dtype=jnp.float32)
        assert v1.shape == v2.shape == (2, 8, 8, 8, 1)
        assert not np.allclose(np.asarray(v1), np.asarray(v2))  # independent views
        w1, w2 = byol_two_view_augment_3d(jax.random.key(0), jnp.asarray(vols),
                                          out_size=(8, 8, 8), dtype=jnp.float32)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(w1))
        np.testing.assert_array_equal(np.asarray(v2), np.asarray(w2))

    def test_volumetric_byol_learns(self):
        """BYOL loss (2-2cos ∈ [0,4]) falls over a few steps on two crops of
        the same structured volumes; tau follows the schedule."""
        from medical_image_segmentation_tpu.ops.augment3d import byol_two_view_augment_3d
        from medical_image_segmentation_tpu.train.byol_task import BYOLTask

        rng = np.random.default_rng(0)
        base = rng.random((4, 12, 16, 16, 1)).astype(np.float32)
        task = BYOLTask(volumetric=True, features3d=(4, 8), in_channels=1,
                        hidden_dim=16, proj_dim=8, num_classes=2,
                        learning_rate=0.5, warmup_epochs=0, max_epochs=10,
                        total_steps=10, probe_loss_weight=0.0, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 8, 8, 1))
        losses = []
        for i in range(8):
            v1, v2 = byol_two_view_augment_3d(jax.random.key(i), jnp.asarray(base),
                                              out_size=(8, 8, 8), dtype=jnp.float32)
            state, m = task.train_step(state, v1, v2)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses))
        assert 0.0 <= losses[-1] <= 4.0
        assert losses[-1] < losses[0]
        assert 0.99 <= float(m["momentum"]) <= 1.0

    def test_encoder_graft_into_unet3d(self):
        """BYOL3D backbone params graft bit-exactly into UNet3D's encoder
        blocks (same enc{i}/down{i} names)."""
        from medical_image_segmentation_tpu.core.checkpoint import load_byol3d_encoder_into_unet3d
        from medical_image_segmentation_tpu.train.byol_task import BYOLTask
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        btask = BYOLTask(volumetric=True, features3d=(4, 8), in_channels=1,
                         hidden_dim=16, proj_dim=8, num_classes=2,
                         total_steps=10, dtype=jnp.float32)
        bstate = btask.init(jax.random.key(1), (1, 8, 8, 8, 1))
        v = jnp.asarray(np.random.default_rng(2).random((2, 8, 8, 8, 1)), jnp.float32)
        bstate, _ = btask.train_step(bstate, v, v)

        stask = Segmentation3DTask(features=(4, 8), dtype=jnp.float32)
        sstate = stask.init(jax.random.key(3), (1, 8, 16, 16, 1))
        unet_vars = {"params": sstate.params, "batch_stats": sstate.batch_stats}
        byol_vars = {"params": jax.device_get(bstate.params),
                     "batch_stats": jax.device_get(bstate.batch_stats)}
        new_vars = load_byol3d_encoder_into_unet3d(unet_vars, byol_vars)

        src_enc = byol_vars["params"]["encoder"]["UNet3DEncoder_0"]
        for block in src_enc:
            np.testing.assert_array_equal(
                np.asarray(jax.tree.leaves(new_vars["params"][block])[0]),
                np.asarray(jax.tree.leaves(src_enc[block])[0]))
        # decoder/head untouched
        np.testing.assert_array_equal(
            np.asarray(jax.tree.leaves(new_vars["params"]["head"])[0]),
            np.asarray(jax.tree.leaves(sstate.params["head"])[0]))

    def test_ssl3d_cli_and_handoff(self, tmp_path):
        """train_ssl3d end-to-end on unlabeled volumes, then the seg3d
        trainer consumes the checkpoint via --ssl_checkpoint."""
        from medical_image_segmentation_tpu.data.nifti import write_nifti
        from medical_image_segmentation_tpu.train import train_segmentation3d, train_ssl3d

        rng = np.random.default_rng(0)
        img_d, msk_d = tmp_path / "imagesTr", tmp_path / "labelsTr"
        img_d.mkdir(); msk_d.mkdir()
        for v in range(8):
            seg = np.zeros((16, 16, 8), np.uint8)
            seg[4:12, 4:12, 2:6] = 1
            vol = (seg * 120.0 + rng.normal(40, 15, seg.shape)).astype(np.float32)
            write_nifti(str(img_d / f"la_{v:03d}.nii.gz"), vol)
            write_nifti(str(msk_d / f"la_{v:03d}.nii.gz"), seg)

        ssl_ckpt = str(tmp_path / "ssl_ckpt")
        rc = train_ssl3d.main([
            "--images_dir", str(img_d), "--volume_size", "8", "16", "16",
            "--crop_size", "8", "8", "8", "--batch_size", "8", "--max_epochs", "2",
            "--features", "4", "8", "--hidden_dim", "16", "--projection_dim", "8",
            "--warmup_epochs", "0", "--fp32",
            "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", ssl_ckpt,
        ])
        assert rc == 0
        steps = [d for d in os.listdir(ssl_ckpt) if d.isdigit()]
        assert steps and max(int(s) for s in steps) >= 2  # actually trained

        rc = train_segmentation3d.main([
            "--images_dir", str(img_d), "--masks_dir", str(msk_d),
            "--volume_size", "8", "16", "16", "--crop_size", "8", "16", "16",
            "--batch_size", "8", "--max_epochs", "1", "--features", "4", "8",
            "--warmup_epochs", "0", "--fp32",
            "--ssl_checkpoint", os.path.join(ssl_ckpt, max(steps, key=int)),
            "--log_dir", str(tmp_path / "logs2"),
            "--checkpoint_dir", str(tmp_path / "seg_ckpt"),
        ])
        assert rc == 0


class TestMultiWindow3D:
    def test_augment3d_stacks_window_channels(self):
        """hu_windows on the volumetric pipeline: channel c equals windowing
        the single-channel output, and a 2-channel UNet3D takes a train step."""
        from medical_image_segmentation_tpu.ops.augment3d import segmentation_augment_3d
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        rng = np.random.default_rng(7)
        vol = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
        msk = (rng.random((2, 8, 16, 16, 1)) < 0.3).astype(np.float32)
        wins = ((0.5, 0.5), (0.25, 0.2))
        x, y = segmentation_augment_3d(
            jax.random.key(0), jnp.asarray(vol), jnp.asarray(msk),
            out_size=(8, 16, 16), mean=(0.5,), std=(0.25,), train=False,
            dtype=jnp.float32, hu_windows=wins)
        assert x.shape == (2, 8, 16, 16, 2)
        base, _ = segmentation_augment_3d(
            jax.random.key(0), jnp.asarray(vol), jnp.asarray(msk),
            out_size=(8, 16, 16), mean=(0.0,), std=(1.0,), train=False,
            dtype=jnp.float32)
        for c, (lv, wd) in enumerate(wins):
            want = (np.clip((np.asarray(base)[..., 0] - (lv - wd / 2)) / wd, 0, 1)
                    - 0.5) / 0.25
            np.testing.assert_allclose(np.asarray(x)[..., c], want, atol=1e-5)

        task = Segmentation3DTask(in_channels=2, features=(4, 8), learning_rate=0.1,
                                  warmup_epochs=0, max_epochs=1, steps_per_epoch=2,
                                  dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 16, 16, 2))
        state, m = task.train_step(state, x, y)
        assert np.isfinite(float(m["train/loss"]))


class TestDeviceCache:
    """--device_cache gathers batches on-device from an HBM-resident corpus
    instead of shipping volumes every step. Same seed ⇒ the same index
    stream and f32 corpus values, so the training trajectory must match the
    host-fed path to FP-reassociation tolerance (the fused gather+augment
    program associates f32 arithmetic differently)."""

    def _volumes(self, tmp_path, n=8):
        from medical_image_segmentation_tpu.data.nifti import write_nifti

        rng = np.random.default_rng(0)
        img_d, msk_d = tmp_path / "imagesTr", tmp_path / "labelsTr"
        img_d.mkdir(exist_ok=True); msk_d.mkdir(exist_ok=True)
        for v in range(n):
            seg = np.zeros((16, 16, 8), np.uint8)
            seg[4:12, 4:12, 2:6] = 1
            vol = (seg * 120.0 + rng.normal(40, 15, seg.shape)).astype(np.float32)
            write_nifti(str(img_d / f"la_{v:03d}.nii.gz"), vol)
            write_nifti(str(msk_d / f"la_{v:03d}.nii.gz"), seg)
        return img_d, msk_d

    @staticmethod
    def _metric_rows(log_dir, name):
        import csv
        import glob

        csvs = sorted(glob.glob(os.path.join(log_dir, "lightning_logs",
                                             "version_*", "metrics.csv")))
        vals = []
        with open(csvs[-1]) as f:
            for row in csv.DictReader(f):
                if row.get(name) not in (None, ""):
                    vals.append(float(row[name]))
        return vals

    def test_iter_index_batches_matches_iter(self, tmp_path):
        from medical_image_segmentation_tpu.data.volumes import (
            DecathlonVolumeDataset,
            VolumeLoader,
        )

        img_d, msk_d = self._volumes(tmp_path)
        ds = DecathlonVolumeDataset(str(img_d), str(msk_d),
                                    target_shape=(8, 16, 16), cache=True)
        a = VolumeLoader(ds, 3, shuffle=True, seed=5)
        b = VolumeLoader(ds, 3, shuffle=True, seed=5)
        for _ in range(3):  # epoch bump must stay in lockstep
            mat = list(a)
            idx = list(b.iter_index_batches())
            assert len(mat) == len(idx)
            for (imgs, msks), chunk in zip(mat, idx):
                np.testing.assert_array_equal(
                    imgs, np.stack([ds[int(i)][0] for i in chunk]))
                np.testing.assert_array_equal(
                    msks, np.stack([ds[int(i)][1] for i in chunk]))

    def test_seg3d_device_cache_trajectory_parity(self, tmp_path):
        from medical_image_segmentation_tpu.train import train_segmentation3d

        img_d, msk_d = self._volumes(tmp_path)
        base = ["--images_dir", str(img_d), "--masks_dir", str(msk_d),
                "--volume_size", "8", "16", "16", "--crop_size", "8", "16", "16",
                "--batch_size", "8", "--max_epochs", "2", "--features", "4", "8",
                "--warmup_epochs", "0", "--fp32", "--checkpoint_every_epochs", "0"]
        rc = train_segmentation3d.main(
            base + ["--log_dir", str(tmp_path / "l_host"),
                    "--checkpoint_dir", str(tmp_path / "c_host")])
        assert rc == 0
        rc = train_segmentation3d.main(
            base + ["--device_cache",
                    "--log_dir", str(tmp_path / "l_dev"),
                    "--checkpoint_dir", str(tmp_path / "c_dev")])
        assert rc == 0
        host = self._metric_rows(str(tmp_path / "l_host"), "train/loss")
        dev = self._metric_rows(str(tmp_path / "l_dev"), "train/loss")
        assert host and len(host) == len(dev)
        np.testing.assert_allclose(host, dev, rtol=1e-4)

    def test_ssl3d_device_cache_trajectory_parity(self, tmp_path):
        from medical_image_segmentation_tpu.train import train_ssl3d

        img_d, _ = self._volumes(tmp_path)
        base = ["--images_dir", str(img_d),
                "--volume_size", "8", "16", "16", "--crop_size", "8", "8", "8",
                "--batch_size", "8", "--max_epochs", "2", "--features", "4", "8",
                "--hidden_dim", "16", "--projection_dim", "8",
                "--warmup_epochs", "0", "--fp32", "--checkpoint_every_epochs", "0"]
        rc = train_ssl3d.main(base + ["--log_dir", str(tmp_path / "l_host"),
                                      "--checkpoint_dir", str(tmp_path / "c_host")])
        assert rc == 0
        rc = train_ssl3d.main(base + ["--device_cache",
                                      "--log_dir", str(tmp_path / "l_dev"),
                                      "--checkpoint_dir", str(tmp_path / "c_dev")])
        assert rc == 0
        host = self._metric_rows(str(tmp_path / "l_host"), "loss")
        dev = self._metric_rows(str(tmp_path / "l_dev"), "loss")
        assert host and len(host) == len(dev)
        np.testing.assert_allclose(host, dev, rtol=1e-4)


class TestEvalCadence:
    def test_eval_every_epochs_skips_intermediate_vals(self, tmp_path):
        """--eval_every_epochs N: val rows appear only at multiples of N and
        at the final epoch; the end-of-training test row always runs."""
        from medical_image_segmentation_tpu.train import train_segmentation3d

        TestDeviceCache._volumes(TestDeviceCache(), tmp_path)
        rc = train_segmentation3d.main([
            "--images_dir", str(tmp_path / "imagesTr"),
            "--masks_dir", str(tmp_path / "labelsTr"),
            "--volume_size", "8", "16", "16", "--crop_size", "8", "16", "16",
            "--batch_size", "8", "--max_epochs", "3", "--features", "4", "8",
            "--warmup_epochs", "0", "--fp32", "--checkpoint_every_epochs", "0",
            "--eval_every_epochs", "2",
            "--log_dir", str(tmp_path / "logs"),
            "--checkpoint_dir", str(tmp_path / "ckpt")])
        assert rc == 0
        import csv
        import glob

        csvs = sorted(glob.glob(os.path.join(
            str(tmp_path / "logs"), "lightning_logs", "version_*", "metrics.csv")))
        val_epochs = []
        has_test = False
        with open(csvs[-1]) as f:
            for row in csv.DictReader(f):
                if row.get("val/dice") not in (None, ""):
                    val_epochs.append(int(float(row["epoch"])))
                if row.get("test/dice") not in (None, ""):
                    has_test = True
        # epochs are 0-indexed: eval after epoch 1 (2nd) and epoch 2 (final)
        assert val_epochs == [1, 2]
        assert has_test


class TestZeroStepRefusal:
    """Drop-last batching at batch > train-set size yields 0 steps/epoch;
    the trainers must refuse instead of silently training nothing (the
    failure mode: val metrics frozen at the init's scores for every epoch,
    final checkpoint at step 0)."""

    def _volumes(self, tmp_path, n):
        from medical_image_segmentation_tpu.data.nifti import write_nifti

        rng = np.random.default_rng(0)
        img_d, msk_d = tmp_path / "imagesTr", tmp_path / "labelsTr"
        img_d.mkdir(exist_ok=True); msk_d.mkdir(exist_ok=True)
        for v in range(n):
            seg = np.zeros((16, 16, 8), np.uint8)
            seg[4:12, 4:12, 2:6] = 1
            vol = (seg * 120.0 + rng.normal(40, 15, seg.shape)).astype(np.float32)
            write_nifti(str(img_d / f"la_{v:03d}.nii.gz"), vol)
            write_nifti(str(msk_d / f"la_{v:03d}.nii.gz"), seg)
        return img_d, msk_d

    def test_seg3d_refuses_batch_larger_than_train_set(self, tmp_path):
        from medical_image_segmentation_tpu.train import train_segmentation3d

        img_d, msk_d = self._volumes(tmp_path, 2)
        with pytest.raises(SystemExit, match="0[ \n]+steps"):
            train_segmentation3d.main([
                "--images_dir", str(img_d), "--masks_dir", str(msk_d),
                "--volume_size", "8", "16", "16", "--crop_size", "8", "16", "16",
                "--batch_size", "8", "--max_epochs", "1", "--features", "4", "8",
                "--fp32", "--log_dir", str(tmp_path / "logs"),
                "--checkpoint_dir", str(tmp_path / "ckpt"),
            ])

    def test_seg3d_refuses_one_bottleneck_slice_per_space_shard(self, tmp_path):
        from medical_image_segmentation_tpu.train import train_segmentation3d

        img_d, msk_d = self._volumes(tmp_path, 2)
        with pytest.raises(SystemExit, match="fewer than 2 slices per shard"):
            train_segmentation3d.main([
                "--images_dir", str(img_d), "--masks_dir", str(msk_d),
                "--volume_size", "8", "16", "16", "--crop_size", "8", "16", "16",
                "--batch_size", "2", "--max_epochs", "1", "--features", "4", "8", "16",
                "--space_shards", "2", "--fp32", "--log_dir", str(tmp_path / "logs"),
                "--checkpoint_dir", str(tmp_path / "ckpt"),
            ])

    def test_ssl3d_refuses_batch_larger_than_dataset(self, tmp_path):
        from medical_image_segmentation_tpu.train import train_ssl3d

        img_d, _ = self._volumes(tmp_path, 2)
        with pytest.raises(SystemExit, match="0[ \n]+steps"):
            train_ssl3d.main([
                "--images_dir", str(img_d),
                "--volume_size", "8", "16", "16", "--crop_size", "8", "8", "8",
                "--batch_size", "8", "--max_epochs", "1", "--features", "4", "8",
                "--hidden_dim", "16", "--projection_dim", "8", "--fp32",
                "--log_dir", str(tmp_path / "logs"),
                "--checkpoint_dir", str(tmp_path / "ckpt"),
            ])
