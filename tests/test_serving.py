"""AOT serving artifacts (serve.py + mis-export + mis-predict --exported).

The artifact must reproduce the checkpoint-backed predict path exactly: the
same function is exported (weights baked in as constants), so masks are
bit-identical. The reference has no deployment path at all (inference only
exists as trainer.predict grid dumps, reference train_segmentation.py:82-93).
"""

import os

import numpy as np
import pytest


def _tiny_task_state(image_size=64, seed=0):
    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

    task = SegmentationTask(
        arch="resnet18", n_classes=1, in_channels=1,
        learning_rate=1.0, warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
        dtype=jnp.float32,
    )
    state = task.init(jax.random.key(seed), (2, image_size, image_size, 1))
    return task, state


class TestServeRoundtrip:
    @pytest.mark.slow
    def test_export_load_matches_direct_predict(self, tmp_path):
        """Exported buckets reproduce the live jitted function exactly, for
        exact-bucket, padded-tail, and multi-chunk (N > max bucket) calls."""
        import jax.numpy as jnp

        from medical_image_segmentation_tpu.ops.dice import post_process_masks
        from medical_image_segmentation_tpu.serve import (
            export_predictor, load_predictor, save_predictor)

        task, state = _tiny_task_state()
        exported = export_predictor(
            task, state, image_size=64, mean=0.2, std=0.21,
            batch_sizes=(2, 4), fp32=True)
        p = str(tmp_path / "m.misx")
        save_predictor(p, exported, {"image_size": 64, "checkpoint_step": 0})
        pred = load_predictor(p)
        assert pred.batch_sizes == [2, 4]

        def direct(imgs):
            x = (imgs.astype(jnp.float32) / np.float32(255.0)
                 - np.float32(0.2)) / np.float32(0.21)
            logits = task.model.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                x, train=False)
            return np.asarray(
                post_process_masks(logits, threshold=0.5)).astype(np.uint8)

        rng = np.random.default_rng(0)
        for n in (4, 3, 1, 7):  # exact bucket, padded, small bucket, chunked
            imgs = rng.integers(0, 256, size=(n, 64, 64, 1)).astype(np.uint8)
            got = pred(imgs)
            assert got.shape == (n, 64, 64, 1) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, direct(jnp.asarray(imgs)))

    def test_container_rejects_garbage_and_truncation(self, tmp_path):
        from medical_image_segmentation_tpu.serve import (
            export_predictor, load_predictor, save_predictor)

        p = str(tmp_path / "bad.misx")
        with open(p, "wb") as f:
            f.write(b"not an artifact")
        with pytest.raises(ValueError, match="magic"):
            load_predictor(p)

        # a valid artifact cut short must fail at LOAD, not hand a short
        # blob to jax.export.deserialize at first serve
        task, state = _tiny_task_state()
        good = str(tmp_path / "good.misx")
        save_predictor(good, export_predictor(
            task, state, image_size=64, mean=0.2, std=0.21,
            batch_sizes=(1,), fp32=True), {"image_size": 64})
        data = open(good, "rb").read()
        cut = str(tmp_path / "cut.misx")
        with open(cut, "wb") as f:
            f.write(data[: len(data) // 2])
        with pytest.raises(ValueError, match="truncated"):
            load_predictor(cut)

    def test_input_validation(self, tmp_path):
        from medical_image_segmentation_tpu.serve import (
            export_predictor, load_predictor, save_predictor)

        task, state = _tiny_task_state()
        exported = export_predictor(task, state, image_size=64, mean=0.2,
                                    std=0.21, batch_sizes=(1,), fp32=True)
        p = str(tmp_path / "m.misx")
        save_predictor(p, exported, {"image_size": 64})
        pred = load_predictor(p)
        with pytest.raises(ValueError, match="64x64"):
            pred(np.zeros((1, 32, 32, 1), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            pred(np.zeros((1, 64, 64), np.uint8))


class TestExportCLI:
    @pytest.mark.slow
    def test_export_then_predict_cli(self, tmp_path, capfd):
        """mis-export on a real checkpoint, then mis-predict --exported
        serves the same masks as the checkpoint-backed path."""
        import cv2

        from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint
        from medical_image_segmentation_tpu.train.export import main as export_main
        from medical_image_segmentation_tpu.train.predict import main as predict_main

        task, state = _tiny_task_state()
        ckpt_dir = str(tmp_path / "ckpt")
        save_checkpoint(ckpt_dir, state, step=1)

        rng = np.random.default_rng(1)
        img_dir = tmp_path / "slices"
        img_dir.mkdir()
        for i in range(3):
            cv2.imwrite(str(img_dir / f"s{i}.png"),
                        rng.integers(0, 256, size=(48, 48)).astype(np.uint8))

        art = str(tmp_path / "model.misx")
        assert export_main([
            "--checkpoint", ckpt_dir, "--output", art, "--image_size", "64",
            "--mean", "0.2089", "--std", "0.2109", "--batch_sizes", "1,2",
            "--fp32"]) == 0
        assert os.path.getsize(art) > 0

        out_ckpt = str(tmp_path / "masks_ckpt")
        assert predict_main([
            "--checkpoint", ckpt_dir, "--image_size", "64",
            "--mean", "0.2089", "--std", "0.2109", "--fp32",
            "--images_dir", str(img_dir), "--output_dir", out_ckpt,
            "--batch_size", "2", "--num_workers", "1"]) == 0
        out_art = str(tmp_path / "masks_art")
        capfd.readouterr()
        assert predict_main([
            "--exported", art,
            "--images_dir", str(img_dir), "--output_dir", out_art,
            "--num_workers", "1"]) == 0
        import json

        summary = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
        assert summary["exported"] is True and summary["images"] == 3
        assert sorted(os.listdir(out_art)) == sorted(os.listdir(out_ckpt))
        for f in os.listdir(out_art):
            a = cv2.imread(os.path.join(out_art, f), cv2.IMREAD_GRAYSCALE)
            b = cv2.imread(os.path.join(out_ckpt, f), cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(a, b)

    def test_exported_excludes_sliding_window_and_checkpoint(self, tmp_path):
        from medical_image_segmentation_tpu.train.predict import main as predict_main

        with pytest.raises(SystemExit, match="exactly one of --checkpoint"):
            predict_main(["--images_dir", "x", "--output_dir", "y"])
        with pytest.raises(SystemExit, match="sliding_window"):
            predict_main(["--exported", "m.misx", "--sliding_window", "96",
                          "--images_dir", "x", "--output_dir", "y"])

    def test_exported_rejects_baked_flags(self):
        """--threshold/--hu_windows/--mean/--std/--dataset are baked into
        the artifact — accepting them with --exported would silently serve
        with different values than the user requested."""
        from medical_image_segmentation_tpu.train.predict import main as predict_main

        for flags in (["--threshold", "0.7"], ["--hu_windows", "96:160"],
                      ["--mean", "0.1"], ["--dataset", "DECATHLON_LIVER"]):
            with pytest.raises(SystemExit, match="baked into the artifact"):
                predict_main(["--exported", "m.misx", *flags,
                              "--images_dir", "x", "--output_dir", "y"])


class TestWindow3DExport:
    def test_export3d_then_predict3d_cli(self, tmp_path, capfd):
        """mis-export3d on a real seg3d checkpoint, then mis-predict3d
        --exported serves the same NIfTI masks as the checkpoint path."""
        import jax
        import jax.numpy as jnp

        from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint
        from medical_image_segmentation_tpu.data.nifti import read_nifti, write_nifti
        from medical_image_segmentation_tpu.train.export3d import main as export3d_main
        from medical_image_segmentation_tpu.train.predict3d import main as predict3d_main
        from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

        task = Segmentation3DTask(in_channels=1, features=(4, 8), norm="group",
                                  learning_rate=1.0, warmup_epochs=0, max_epochs=1,
                                  steps_per_epoch=1, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 16, 16, 1))
        ckpt = str(tmp_path / "ckpt")
        save_checkpoint(ckpt, state, step=1)

        rng = np.random.default_rng(2)
        vols = tmp_path / "vols"
        vols.mkdir()
        for v in range(2):
            write_nifti(str(vols / f"v{v}.nii.gz"),
                        rng.random((16, 16, 10)).astype(np.float32))

        art = str(tmp_path / "w3d.misx")
        assert export3d_main([
            "--checkpoint", ckpt, "--output", art, "--features", "4", "8",
            "--window", "8", "16", "16", "--batch_windows", "2", "--fp32"]) == 0

        out_ckpt = str(tmp_path / "m_ckpt")
        assert predict3d_main([
            "--checkpoint", ckpt, "--features", "4", "8",
            "--window", "8", "16", "16", "--batch_windows", "2", "--fp32",
            "--images_dir", str(vols), "--output_dir", out_ckpt]) == 0
        out_art = str(tmp_path / "m_art")
        assert predict3d_main([
            "--exported", art,
            "--images_dir", str(vols), "--output_dir", out_art]) == 0
        files = sorted(os.listdir(out_art))
        assert files == sorted(os.listdir(out_ckpt)) and len(files) == 2
        for f in files:
            a = np.asarray(read_nifti(os.path.join(out_art, f)).get_fdata())
            b = np.asarray(read_nifti(os.path.join(out_ckpt, f)).get_fdata())
            np.testing.assert_array_equal(a, b)

    def test_kind_mismatch_rejected(self, tmp_path):
        import jax.numpy as jnp
        import pytest

        from medical_image_segmentation_tpu.serve import (
            export_predictor, load_window_predictor, save_predictor)

        task, state = _tiny_task_state()
        exported = export_predictor(task, state, image_size=64, mean=0.2,
                                    std=0.21, batch_sizes=(1,), fp32=True)
        p = str(tmp_path / "m.misx")
        save_predictor(p, exported, {"kind": "batched2d", "image_size": 64})
        with pytest.raises(ValueError, match="window"):
            load_window_predictor(p)


class TestArtifactPlatforms:
    def test_records_reported_platforms_and_refuses_foreign(self, tmp_path):
        """The meta lists the platforms the artifact reports (jax's 'cuda' for
        NVIDIA GPUs, not the backend name 'gpu'); an artifact lowered for cuda
        and cpu loads here, a cuda-only one is refused with the fix."""
        from medical_image_segmentation_tpu.serve import (
            artifact_platforms, export_predictor, load_predictor, save_predictor)

        task, state = _tiny_task_state()
        exported = export_predictor(task, state, image_size=64, mean=0.2, std=0.21,
                                    batch_sizes=(1,), fp32=True, platforms=("cuda", "cpu"))
        assert artifact_platforms(exported) == ["cpu", "cuda"]
        both = str(tmp_path / "both.misx")
        save_predictor(both, exported, {"image_size": 64, "platforms": artifact_platforms(exported)})
        pred = load_predictor(both)
        out = pred(np.zeros((1, 64, 64, 1), np.uint8))
        assert out.shape == (1, 64, 64, 1)
        cuda = str(tmp_path / "cuda.misx")
        save_predictor(cuda, exported, {"image_size": 64, "platforms": ["cuda"]})
        with pytest.raises(ValueError, match="lowered for \\['cuda'\\].*--platforms cpu,cuda"):
            load_predictor(cuda)
