"""Full-workflow CLI test: synthetic DICOMs → subset → store → BYOL pretrain
→ SSL→U-Net handoff → segmentation fit/test/predict. This is the whole
reference pipeline (SURVEY §3) driven through our entry points on a tiny
scale."""

import json
import os

import numpy as np
import pytest

from medical_image_segmentation_tpu.data.dicom import write_dicom
from medical_image_segmentation_tpu.data.nifti import write_nifti


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("e2e")
    # --- synthetic TCIA-like DICOM tree ---
    dcm_dir = ws / "med_datasets" / "pancreasct"
    dcm_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(10):
        arr = rng.integers(0, 4096, size=(260, 260)).astype(np.uint16)
        write_dicom(str(dcm_dir / f"img{i}.dcm"), arr)
    # --- synthetic Decathlon task ---
    (ws / "Task99" / "imagesTr").mkdir(parents=True)
    (ws / "Task99" / "labelsTr").mkdir(parents=True)
    for v in range(3):
        vol = rng.normal(100, 40, size=(64, 64, 4)).astype(np.float32)
        seg = np.zeros((64, 64, 4), np.uint8)
        seg[20:40, 20:40, :] = 1
        write_nifti(str(ws / "Task99" / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(ws / "Task99" / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    return ws


@pytest.mark.slow
def test_full_pipeline(workspace, monkeypatch):
    ws = workspace
    from medical_image_segmentation_tpu.data.ingest import create_subset, create_store, slice_decathlon, create_splits

    # 1. scans
    dims_json = str(ws / "dims.json")
    hashes_json = str(ws / "hashes.json")
    assert create_subset.main(["dicom_sizes", str(ws / "med_datasets"), "--output", dims_json,
                               "--num_processes", "1"]) == 0
    assert create_subset.main(["dicom_hashes", str(ws / "med_datasets"), "--output", hashes_json,
                               "--num_processes", "1"]) == 0
    assert len(json.load(open(dims_json))) == 10

    # 2. curated subset
    subset_dir = str(ws / "subset")
    map_json = str(ws / "map.json")
    assert create_subset.main([
        "write_subset", "--dimensions_map", dims_json, "--hashes_map", hashes_json,
        "--output_dir", subset_dir, "--size", "8", "--num_subfolders", "4",
        "--num_processes", "1", "--mapping_output", map_json,
    ]) == 0
    mapping = json.load(open(map_json))
    assert len(mapping) == 8

    # 3. store build (from the curated PNGs, 224 max-res, JPEG)
    store_path = str(ws / "radiology_train.mis")
    assert create_store.main(["--png_dir", subset_dir, "--output", store_path,
                              "--max_resolution", "224"]) == 0
    assert os.path.getsize(store_path) > 0

    # 4. SSL pretrain (tiny: 1 epoch, 2 steps, batch 4)
    from medical_image_segmentation_tpu.train import train_ssl

    monkeypatch.setenv("RADIOLOGY_1M_TRAIN_STORE", store_path)
    monkeypatch.setenv("RADIOLOGY_1M_VAL_STORE", str(ws / "missing.mis"))
    ckpt_dir = str(ws / "ckpt_ssl")
    assert train_ssl.main([
        "--dataset", "RADIOLOGY_1M", "--batch_size", "8", "--max_epochs", "1",
        "--hidden_dim", "64", "--projection_dim", "16",
        "--limit_steps_per_epoch", "2", "--num_workers", "1",
        "--checkpoint_dir", ckpt_dir, "--log_dir", str(ws / "logs"), "--fp32",
    ]) == 0
    steps = [d for d in os.listdir(ckpt_dir) if d.isdigit()]
    assert steps, "SSL checkpoint missing"
    ssl_ckpt = os.path.join(ckpt_dir, max(steps, key=int))

    # 4b. resume: a second run with --resume continues from the checkpoint
    assert train_ssl.main([
        "--dataset", "RADIOLOGY_1M", "--batch_size", "8", "--max_epochs", "2",
        "--hidden_dim", "64", "--projection_dim", "16",
        "--limit_steps_per_epoch", "2", "--num_workers", "1",
        "--checkpoint_dir", ckpt_dir, "--log_dir", str(ws / "logs"), "--fp32",
        "--resume",
    ]) == 0
    steps2 = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    assert steps2[-1] > int(max(steps, key=int)), "resume did not advance the step counter"

    # 4c. single-validation mode errors cleanly when the val store is absent
    import pytest as _pytest

    with _pytest.raises(FileNotFoundError):
        train_ssl.main([
            "--dataset", "RADIOLOGY_1M", "--batch_size", "8", "--num_workers", "1",
            "--hidden_dim", "64", "--projection_dim", "16",
            "--checkpoint_dir", ckpt_dir, "--run_single_validation", "--fp32",
        ])

    # 5. slice Decathlon + splits
    img_out = str(ws / "slices" / "images")
    msk_out = str(ws / "slices" / "masks")
    assert slice_decathlon.main([
        "--images_dir", str(ws / "Task99" / "imagesTr"),
        "--labels_dir", str(ws / "Task99" / "labelsTr"),
        "--images_out", img_out, "--masks_out", msk_out, "--num_processes", "1",
    ]) == 0
    assert create_splits.main(["--images_dir", img_out, "--output_dir", str(ws / "splits")]) == 0
    split_file = str(ws / "splits" / "split_100_percent_train.json")

    # 6. segmentation fit/test/predict with SSL handoff
    from medical_image_segmentation_tpu.train import train_segmentation

    grid = str(ws / "grid.png")
    assert train_segmentation.main([
        "--dataset", "DECATHLON_HEART", "--images_dir", img_out, "--masks_dir", msk_out,
        "--split_file", split_file, "--batch_size", "8", "--max_epochs", "1",
        "--warmup_epochs", "0", "--image_size", "64", "--num_workers", "1",
        "--limit_steps_per_epoch", "1", "--checkpoint_dir", str(ws / "ckpt_seg"),
        "--log_dir", str(ws / "logs_seg"), "--ssl_checkpoint", ssl_ckpt,
        "--predict_grid", grid, "--fp32",
    ]) == 0
    assert os.path.exists(grid)

    # 7. metrics CSV exists and has the reference's metric names
    import glob

    csvs = glob.glob(str(ws / "logs_seg" / "lightning_logs" / "version_*" / "metrics.csv"))
    assert csvs
    header = open(csvs[0]).readline()
    assert "train/loss" in header


@pytest.mark.slow
def test_train_ssl_torchvision_recipe_smoke(tmp_path, monkeypatch):
    """--aug_recipe torchvision end-to-end: the ColorJitter+GaussianBlur
    pipeline (reference lightning_module.py:39-64) must run through the
    augmentation path end to end and train."""
    import numpy as np

    from medical_image_segmentation_tpu.data.store import StoreWriter
    from medical_image_segmentation_tpu.train.train_ssl import main

    rng = np.random.default_rng(0)
    for name, n in (("train.mis", 32), ("val.mis", 16)):
        with StoreWriter(str(tmp_path / name), channels=3, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8), label=i % 4)
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(tmp_path / "train.mis"))
    monkeypatch.setenv("CIFAR10_VAL_STORE", str(tmp_path / "val.mis"))
    rc = main([
        "--dataset", "CIFAR10", "--batch_size", "16", "--max_epochs", "1",
        "--hidden_dim", "16", "--projection_dim", "8", "--num_workers", "1",
        "--fp32", "--limit_steps_per_epoch", "1", "--warmup_epochs", "1",
        "--aug_recipe", "torchvision", "--window_prob", "0.5",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
    ])
    assert rc == 0


@pytest.mark.slow
def test_train_ssl_host_precrop_smoke(tmp_path, monkeypatch):
    """--host_precrop end-to-end on the 8-device CPU mesh: the C++ loader
    ships pre-cropped sample-major views, the device runs only the
    elementwise tail, and the step trains. Also pins the gate: the
    torchvision recipe (GaussianBlur needs the device resampler) must be
    rejected with a clear error."""
    import numpy as np

    from medical_image_segmentation_tpu.data.store import StoreWriter
    from medical_image_segmentation_tpu.train.train_ssl import main

    rng = np.random.default_rng(0)
    with StoreWriter(str(tmp_path / "train.mis"), channels=3, with_labels=True) as w:
        for i in range(32):
            w.add(rng.integers(0, 256, size=(40, 40, 3)).astype(np.uint8), label=i % 4)
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(tmp_path / "train.mis"))
    common = [
        "--dataset", "CIFAR10", "--batch_size", "16", "--max_epochs", "1",
        "--hidden_dim", "16", "--projection_dim", "8", "--num_workers", "1",
        "--fp32", "--limit_steps_per_epoch", "1", "--warmup_epochs", "1",
        "--host_precrop", "--val_every_epochs", "0",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
    ]
    assert main(common) == 0
    with pytest.raises(SystemExit, match="host_precrop"):
        main(common + ["--aug_recipe", "torchvision"])


@pytest.mark.slow
def test_train_ssl_model_parallel_smoke(tmp_path, monkeypatch):
    """--model_parallel 2 on the 8-device CPU mesh: (4 data, 2 model) mesh,
    Megatron-sharded MLP heads through the real entry point."""
    import numpy as np

    from medical_image_segmentation_tpu.data.store import StoreWriter
    from medical_image_segmentation_tpu.train.train_ssl import main

    rng = np.random.default_rng(0)
    with StoreWriter(str(tmp_path / "train.mis"), channels=3, with_labels=True) as w:
        for i in range(32):
            w.add(rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8), label=i % 4)
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(tmp_path / "train.mis"))
    rc = main([
        "--dataset", "CIFAR10", "--batch_size", "16", "--max_epochs", "1",
        "--hidden_dim", "16", "--projection_dim", "8", "--num_workers", "1",
        "--fp32", "--limit_steps_per_epoch", "1", "--warmup_epochs", "1",
        "--model_parallel", "2", "--val_every_epochs", "0",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
    ])
    assert rc == 0
    import os

    assert any(d.isdigit() for d in os.listdir(tmp_path / "ckpt"))


@pytest.mark.slow
def test_train_segmentation_resume_mid_epoch_skips_trained_batches(tmp_path, capfd):
    """A preemption checkpoint can land mid-epoch; --resume must skip the
    batches state.step already counts instead of retraining them — or the
    run overshoots max_epochs*steps_per_epoch and exhausts the LR schedule
    early. The mid-epoch checkpoint here is produced by a run whose
    --limit_steps_per_epoch stops at a step that is mid-epoch for the full
    loader (same data order as an interrupted full run: epoch 0, batch 0)."""
    rng = np.random.default_rng(7)
    (tmp_path / "imagesTr").mkdir()
    (tmp_path / "labelsTr").mkdir()
    for v in range(6):
        vol = rng.normal(100, 40, size=(48, 48, 4)).astype(np.float32)
        seg = np.zeros((48, 48, 4), np.uint8)
        seg[15:30, 15:30, :] = 1
        write_nifti(str(tmp_path / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(tmp_path / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    from medical_image_segmentation_tpu.data.ingest import create_splits, slice_decathlon
    from medical_image_segmentation_tpu.train.train_segmentation import main as seg_main

    img_out, msk_out = str(tmp_path / "img"), str(tmp_path / "msk")
    assert slice_decathlon.main([
        "--images_dir", str(tmp_path / "imagesTr"), "--labels_dir", str(tmp_path / "labelsTr"),
        "--images_out", img_out, "--masks_out", msk_out, "--num_processes", "1"]) == 0
    assert create_splits.main(["--images_dir", img_out, "--output_dir", str(tmp_path / "splits")]) == 0

    ckpt = str(tmp_path / "ckpt")
    base = [
        "--dataset", "DECATHLON_HEART", "--images_dir", img_out, "--masks_dir", msk_out,
        "--split_file", str(tmp_path / "splits" / "split_100_percent_train.json"),
        "--batch_size", "8", "--warmup_epochs", "0", "--image_size", "64",
        "--num_workers", "1", "--fp32", "--log_dir", str(tmp_path / "logs"),
        "--checkpoint_dir", ckpt,
    ]
    # "interrupted" run: checkpoint lands at step 1 — mid-epoch for the full
    # loader (its epochs are ≥2 steps with this data)
    assert seg_main(base + ["--max_epochs", "1", "--limit_steps_per_epoch", "1"]) == 0
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [1]

    capfd.readouterr()
    assert seg_main(base + ["--max_epochs", "2", "--resume"]) == 0
    err = capfd.readouterr().err
    assert "resumed from step 1 (epoch 0, skipping 1 trained batches)" in err
    final = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())[-1]
    # exact step budget: no replayed batches, no overshoot
    from medical_image_segmentation_tpu.data.datamodules import get_datamodule

    dm = get_datamodule("DECATHLON_HEART")(
        images_dir=img_out, masks_dir=msk_out,
        split_file=str(tmp_path / "splits" / "split_100_percent_train.json"),
        image_size=64)
    with __import__("contextlib").closing(dm.loader("train", 8, seed=0)) as tl:
        steps_per_epoch = len(tl)
    assert steps_per_epoch >= 2, "fixture must make epochs longer than 1 step"
    assert final == 2 * steps_per_epoch, f"expected {2*steps_per_epoch}, got {final}"


@pytest.mark.slow
def test_predict_cli_serves_masks(tmp_path, capfd):
    """mis-predict (train/predict.py): load a trained checkpoint and serve
    masks for a directory of slices — the deployable inference entry the
    reference lacks (its only predict path is trainer.predict grid dumps,
    reference train_segmentation.py:82-93). Checks batched mode (masks at
    source resolution, overlays), DICOM input, and sliding-window mode."""
    rng = np.random.default_rng(9)
    (tmp_path / "imagesTr").mkdir()
    (tmp_path / "labelsTr").mkdir()
    for v in range(4):
        vol = rng.normal(100, 40, size=(48, 48, 4)).astype(np.float32)
        seg = np.zeros((48, 48, 4), np.uint8)
        seg[15:30, 15:30, :] = 1
        write_nifti(str(tmp_path / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(tmp_path / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    from medical_image_segmentation_tpu.data.ingest import create_splits, slice_decathlon
    from medical_image_segmentation_tpu.train.predict import main as predict_main
    from medical_image_segmentation_tpu.train.train_segmentation import main as seg_main

    img_out, msk_out = str(tmp_path / "img"), str(tmp_path / "msk")
    assert slice_decathlon.main([
        "--images_dir", str(tmp_path / "imagesTr"), "--labels_dir", str(tmp_path / "labelsTr"),
        "--images_out", img_out, "--masks_out", msk_out, "--num_processes", "1"]) == 0
    assert create_splits.main(["--images_dir", img_out, "--output_dir", str(tmp_path / "splits")]) == 0
    ckpt = str(tmp_path / "ckpt")
    assert seg_main([
        "--dataset", "DECATHLON_HEART", "--images_dir", img_out, "--masks_dir", msk_out,
        "--split_file", str(tmp_path / "splits" / "split_100_percent_train.json"),
        "--batch_size", "8", "--max_epochs", "1", "--limit_steps_per_epoch", "1",
        "--warmup_epochs", "0", "--image_size", "64", "--num_workers", "1", "--fp32",
        "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", ckpt]) == 0

    # batched mode over the PNG slices (source res 48² ≠ network res 64²)
    out_dir, ov_dir = str(tmp_path / "masks"), str(tmp_path / "overlays")
    capfd.readouterr()
    assert predict_main([
        "--checkpoint", ckpt, "--dataset", "DECATHLON_HEART", "--image_size", "64",
        "--images_dir", img_out, "--output_dir", out_dir, "--overlay_dir", ov_dir,
        "--batch_size", "8", "--num_workers", "1", "--fp32"]) == 0
    summary = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    n_slices = len(os.listdir(img_out))
    assert summary["images"] == n_slices and summary["mode"] == "batched"
    masks = sorted(os.listdir(out_dir))
    assert len(masks) == n_slices and len(os.listdir(ov_dir)) == n_slices
    import cv2

    m = cv2.imread(os.path.join(out_dir, masks[0]), cv2.IMREAD_GRAYSCALE)
    assert m.shape == (48, 48), "mask must come back at source resolution"
    assert set(np.unique(m)) <= {0, 255}

    # DICOM input path
    dcm_dir = tmp_path / "dcm"
    dcm_dir.mkdir()
    write_dicom(str(dcm_dir / "a.dcm"), rng.integers(0, 4096, size=(48, 48)).astype(np.uint16))
    out2 = str(tmp_path / "masks_dcm")
    assert predict_main([
        "--checkpoint", ckpt, "--dataset", "DECATHLON_HEART", "--image_size", "64",
        "--images_dir", str(dcm_dir), "--output_dir", out2,
        "--batch_size", "8", "--num_workers", "1", "--fp32"]) == 0
    assert os.listdir(out2) == ["a_mask.png"]

    # sliding-window mode (full-res blended inference)
    out3 = str(tmp_path / "masks_sw")
    assert predict_main([
        "--checkpoint", ckpt, "--dataset", "DECATHLON_HEART", "--image_size", "64",
        "--images_dir", str(dcm_dir), "--output_dir", out3,
        "--sliding_window", "32", "--num_workers", "1", "--fp32"]) == 0
    m3 = cv2.imread(os.path.join(out3, "a_mask.png"), cv2.IMREAD_GRAYSCALE)
    assert m3.shape == (48, 48)


@pytest.mark.slow
def test_train_segmentation_resume_deterministic(tmp_path, capfd):
    """--resume on the segmentation trainer (VERDICT r2 missing #2): the
    continued run must restore the step count, continue the per-epoch data
    order and augmentation RNG stream (deterministic: two resumes from the
    same checkpoint produce bit-identical parameters), and land on the exact
    final step count. Reference bar: PL per-epoch ModelCheckpoint +
    ``ckpt_path`` (reference train_segmentation.py:51-61)."""
    import shutil

    import jax

    from medical_image_segmentation_tpu.core.checkpoint import restore_checkpoint
    from medical_image_segmentation_tpu.data.ingest import create_splits, slice_decathlon
    from medical_image_segmentation_tpu.train.train_segmentation import main as seg_main

    rng = np.random.default_rng(3)
    (tmp_path / "imagesTr").mkdir()
    (tmp_path / "labelsTr").mkdir()
    for v in range(6):
        vol = rng.normal(100, 40, size=(48, 48, 4)).astype(np.float32)
        seg = np.zeros((48, 48, 4), np.uint8)
        seg[15:30, 15:30, :] = 1
        write_nifti(str(tmp_path / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(tmp_path / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    img_out, msk_out = str(tmp_path / "img"), str(tmp_path / "msk")
    assert slice_decathlon.main([
        "--images_dir", str(tmp_path / "imagesTr"), "--labels_dir", str(tmp_path / "labelsTr"),
        "--images_out", img_out, "--masks_out", msk_out, "--num_processes", "1"]) == 0
    assert create_splits.main(["--images_dir", img_out, "--output_dir", str(tmp_path / "splits")]) == 0

    ckpt_a = str(tmp_path / "ckpt_a")
    base = [
        "--dataset", "DECATHLON_HEART", "--images_dir", img_out, "--masks_dir", msk_out,
        "--split_file", str(tmp_path / "splits" / "split_100_percent_train.json"),
        "--batch_size", "8", "--warmup_epochs", "0", "--image_size", "64",
        "--num_workers", "1", "--fp32", "--log_dir", str(tmp_path / "logs"),
    ]
    assert seg_main(base + ["--max_epochs", "1", "--checkpoint_dir", ckpt_a]) == 0
    steps1 = sorted(int(d) for d in os.listdir(ckpt_a) if d.isdigit())
    assert steps1, "no epoch-1 checkpoint"
    steps_per_epoch = steps1[-1]

    # two independent resumes from the SAME checkpoint → must be bit-identical
    ckpt_b = str(tmp_path / "ckpt_b")
    shutil.copytree(ckpt_a, ckpt_b)
    capfd.readouterr()
    assert seg_main(base + ["--max_epochs", "2", "--checkpoint_dir", ckpt_a, "--resume"]) == 0
    err = capfd.readouterr().err
    assert f"resumed from step {steps_per_epoch} (epoch 1)" in err
    assert seg_main(base + ["--max_epochs", "2", "--checkpoint_dir", ckpt_b, "--resume"]) == 0

    for d in (ckpt_a, ckpt_b):
        final = sorted(int(x) for x in os.listdir(d) if x.isdigit())[-1]
        assert final == 2 * steps_per_epoch, f"wrong final step in {d}: {final}"
    tree_a = restore_checkpoint(os.path.join(ckpt_a, str(2 * steps_per_epoch)))
    tree_b = restore_checkpoint(os.path.join(ckpt_b, str(2 * steps_per_epoch)))
    leaves_a, leaves_b = jax.tree.leaves(tree_a), jax.tree.leaves(tree_b)
    assert len(leaves_a) == len(leaves_b)
    for la, lb in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
