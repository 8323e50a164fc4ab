"""Standalone batched segmentation inference CLI (model serving).

The reference's only inference path is ``trainer.predict`` wired inside the
training entry (`medical_image_segmentation/train/train_segmentation.py:82-93`,
grid dumps only) — a deployable predict entry point does not exist there.
This CLI loads a segmentation checkpoint and serves binary masks for a
directory of PNG/DICOM slices or an MIS store, batched on the device:

  mis-predict --checkpoint ckpt/seg --arch resnet18 --dataset DECATHLON_LIVER \\
      --images_dir slices/ --output_dir masks/ [--overlay_dir overlays/] \\
      [--sliding_window 224] [--threshold 0.5] [--batch_size 64]

Two modes:

- **batched** (default): host-resize every slice to ``--image_size`` (one
  static shape → one XLA program), normalize + forward on device in batches,
  nearest-resize each mask back to its source resolution;
- **--sliding_window N**: full-resolution inference via overlapping blended
  windows (`eval/sliding_window.py`), which scored higher dice than
  resized eval.

Masks are written as 0/255 PNGs named after their inputs; ``--overlay_dir``
additionally writes red-overlay visualizations. A one-line JSON throughput
summary is printed at the end (images/sec through the full load→predict→
write pipeline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Batched U-Net mask inference")
    ap.add_argument("--checkpoint", default=None,
                    help="segmentation checkpoint directory (latest step) or a specific step path")
    ap.add_argument("--exported", default=None,
                    help="serve from an AOT .misx artifact (mis-export) instead of a "
                         "checkpoint: no model code or restore, batched mode only")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224,
                    help="network input size in batched mode (matches training)")
    ap.add_argument("--dataset", default=None,
                    help="datamodule name to pull normalization stats from (e.g. DECATHLON_LIVER)")
    ap.add_argument("--mean", type=float, default=None, help="override normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=None, help="override normalization std (0-1 scale)")
    ap.add_argument("--images_dir", default=None, help="directory of PNG or DICOM slices")
    ap.add_argument("--image_store", default=None, help="MIS store of slices (C++ decode path)")
    ap.add_argument("--output_dir", required=True, help="masks are written here as 0/255 PNGs")
    ap.add_argument("--overlay_dir", default=None, help="also write red-overlay PNGs here")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut for the binary mask")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows stacked as input channels — must match "
                         "the --hu_windows the checkpoint trained with")
    ap.add_argument("--sliding_window", type=int, default=0,
                    help=">0: full-resolution inference with blended windows of this size")
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def _load_slice(path: str) -> np.ndarray:
    """Read one grayscale slice as uint8 (H, W): PNG via OpenCV, DICOM via
    the native reader with min-max scaling (the ingest convention,
    reference `create_subset.py:174-241`)."""
    if path.lower().endswith(".dcm"):
        from medical_image_segmentation_tpu.data.dicom import read_dicom

        arr = read_dicom(path).pixel_array
        if arr.ndim == 3:  # multi-frame: serve the first frame
            arr = arr[0]
        arr = arr.astype(np.float64)
        lo, hi = arr.min(), arr.max()
        return (((arr - lo) / (hi - lo) if hi > lo else arr * 0) * 255).astype(np.uint8)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"unreadable image {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if img.dtype == np.uint16:  # 16-bit radiology PNGs (datasets.py convention)
        img = (img / 256).astype(np.uint8)
    return img.astype(np.uint8)


def _resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    ys = (np.arange(hw[0]) * img.shape[0] // hw[0])
    xs = (np.arange(hw[1]) * img.shape[1] // hw[1])
    return img[ys][:, xs]


def _write_mask(path: str, mask01: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, (mask01 * 255).astype(np.uint8))


def _write_overlay(path: str, gray: np.ndarray, mask01: np.ndarray) -> None:
    import cv2

    bgr = np.stack([gray, gray, gray], axis=-1)
    red = bgr.copy()
    red[..., 2] = np.maximum(red[..., 2], (mask01 * 255).astype(np.uint8))
    cv2.imwrite(path, np.where(mask01[..., None] > 0, (0.5 * bgr + 0.5 * red), bgr).astype(np.uint8))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    enable_compile_cache()
    if (args.images_dir is None) == (args.image_store is None):
        raise SystemExit("exactly one of --images_dir / --image_store is required")
    if (args.checkpoint is None) == (args.exported is None):
        raise SystemExit("exactly one of --checkpoint / --exported is required")
    if args.exported is not None and args.sliding_window:
        raise SystemExit("--exported serves the batched AOT function; "
                         "--sliding_window needs --checkpoint")
    if args.exported is not None:
        # these are baked into the artifact at export time — accepting them
        # here would silently serve with different values than requested
        baked = {"threshold": 0.5, "hu_windows": None, "mean": None,
                 "std": None, "dataset": None}
        bad = [f"--{k}" for k, dv in baked.items() if getattr(args, k) != dv]
        if bad:
            raise SystemExit(
                f"{', '.join(bad)}: baked into the artifact at export time — "
                f"re-run mis-export with the desired values instead")

    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.core.checkpoint import resolve_checkpoint_path, restore_checkpoint
    from medical_image_segmentation_tpu.ops.dice import post_process_masks
    from medical_image_segmentation_tpu.parallel import make_mesh, replicated, shard_batch
    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

    predictor = None
    if args.exported is not None:
        # AOT artifact: weights, normalize stats and threshold are baked in;
        # the serving host needs no model code and no checkpoint restore.
        from medical_image_segmentation_tpu.serve import load_predictor

        predictor = load_predictor(args.exported)
        args.image_size = predictor.image_size
        args.batch_size = max(predictor.batch_sizes)
        print(f"loaded {args.exported} (step {predictor.meta.get('checkpoint_step')}, "
              f"buckets {predictor.batch_sizes})", file=sys.stderr)
        os.makedirs(args.output_dir, exist_ok=True)
        if args.overlay_dir:
            os.makedirs(args.overlay_dir, exist_ok=True)
        size = args.image_size
        mesh = state = predict = None
    else:
        # normalization stats: explicit flags win, else the datamodule registry
        mean, std = args.mean, args.std
        if mean is None or std is None:
            if args.dataset is None:
                raise SystemExit("pass --dataset (registry stats) or --mean/--std")
            from medical_image_segmentation_tpu.data.datamodules import get_datamodule

            dm = get_datamodule(args.dataset)()
            mean = mean if mean is not None else float(dm.mean[0])
            std = std if std is not None else float(dm.std[0])

        from medical_image_segmentation_tpu.ops.augment import parse_hu_windows

        hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
        in_ch = len(hu_windows) if hu_windows else 1
        task = SegmentationTask(
            arch=args.arch, n_classes=1, in_channels=in_ch,
            learning_rate=1.0, warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
            dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
        )
        state = task.init(jax.random.key(0), (2, args.image_size, args.image_size, in_ch))
        ckpt = resolve_checkpoint_path(args.checkpoint)
        state = restore_checkpoint(ckpt, state)
        print(f"restored {ckpt} (step {int(np.asarray(state.step))})", file=sys.stderr)

        mesh = make_mesh()
        state = jax.device_put(state, replicated(mesh))
        os.makedirs(args.output_dir, exist_ok=True)
        if args.overlay_dir:
            os.makedirs(args.overlay_dir, exist_ok=True)

        size = args.image_size

        # one source of truth for the serving math (shared with mis-export
        # and bench --task predict): serve.make_predict_fn, jitted over the
        # mesh-replicated variables so batches shard across all local chips
        from medical_image_segmentation_tpu.serve import make_predict_fn

        _fn = make_predict_fn(
            task, {"params": state.params, "batch_stats": state.batch_stats},
            mean, std, threshold=args.threshold, fp32=not args.bf16,
            hu_windows=hu_windows)

        @jax.jit
        def predict(state, imgs_u8):
            del state  # variables are closed over (mesh-replicated)
            return _fn(imgs_u8)

    # ---- input enumeration -------------------------------------------------
    t0 = time.time()
    n_done = 0

    def batched_sources():
        """Yield (name, uint8 slice) pairs."""
        if args.images_dir is not None:
            names = sorted(
                f for f in os.listdir(args.images_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".dcm"))
            )
            if not names:
                raise SystemExit(f"no PNG/JPEG/DICOM slices in {args.images_dir}")
            for f in names:
                yield f, _load_slice(os.path.join(args.images_dir, f))
        else:
            import contextlib

            from medical_image_segmentation_tpu.data.loader import SEQUENTIAL, Loader

            with contextlib.closing(Loader(
                args.image_store, args.batch_size, order=SEQUENTIAL,
                num_threads=args.num_workers, drop_last=False, prefetch=2,
            )) as loader:
                i = 0
                for imgs, _ in loader:
                    for img in imgs:
                        yield f"{i:08d}.png", img[..., 0]
                        i += 1

    if args.sliding_window:
        from medical_image_segmentation_tpu.eval.sliding_window import (
            make_fused_predictor_2d, make_unet_window_fn, sliding_window_predict)

        from medical_image_segmentation_tpu.eval.sliding_window import _window_starts

        window_fn = make_unet_window_fn(task, jax.device_get(state))
        multi_chip = len(jax.devices()) > 1
        fused_cache: dict = {}
        for name, img in batched_sources():
            x = img.astype(np.float32)[..., None] / 255.0  # (H, W, 1)
            if hu_windows:
                x = np.asarray(apply_hu_windows(jnp.asarray(x), hu_windows))
            x = (x - mean) / std
            w = args.sliding_window
            n_win = 1
            for full in x.shape[:2]:
                n_win *= len(_window_starts(max(full, w), w, max(1, w // 2)))
            if multi_chip or n_win > 64:
                # sharded over all devices, or too many windows for the fused
                # program's compile time (see predict3d.py) — loop variant
                logits = sliding_window_predict(
                    window_fn, jnp.asarray(x), window=args.sliding_window,
                    mesh=mesh)
            else:  # ONE fused dispatch per image, cached per shape class
                pred = fused_cache.get(x.shape)
                if pred is None:
                    pred = fused_cache[x.shape] = make_fused_predictor_2d(
                        window_fn, x.shape, window=args.sliding_window)
                logits = pred(jnp.asarray(x))
            mask = np.asarray(post_process_masks(logits, threshold=args.threshold))[..., 0]
            base = os.path.splitext(name)[0] + "_mask.png"
            _write_mask(os.path.join(args.output_dir, base), mask)
            if args.overlay_dir:
                _write_overlay(os.path.join(args.overlay_dir, base), img, mask)
            n_done += 1
    else:
        names: list = []
        shapes: list = []
        buf = np.zeros((args.batch_size, size, size, 1), np.uint8)
        raws: list = []

        def flush():
            nonlocal n_done
            if not names:
                return
            if predictor is not None:  # AOT artifact: buckets + pads itself
                masks = predictor(buf[: len(names)])[..., 0]
            else:
                b = shard_batch(mesh, buf)  # padded tail reuses the last slice
                masks = np.asarray(predict(state, b))[..., 0]
            for j, (name, shape) in enumerate(zip(names, shapes)):
                mask = masks[j]
                if shape != mask.shape:
                    mask = _resize_nearest(mask, shape)
                base = os.path.splitext(name)[0] + "_mask.png"
                _write_mask(os.path.join(args.output_dir, base), mask)
                if args.overlay_dir:
                    _write_overlay(os.path.join(args.overlay_dir, base), raws[j], mask)
                n_done += 1
            names.clear(); shapes.clear(); raws.clear()

        for name, img in batched_sources():
            j = len(names)
            buf[j, ..., 0] = img if img.shape == (size, size) else _resize_nearest(img, (size, size))
            names.append(name); shapes.append(img.shape); raws.append(img)
            if len(names) == args.batch_size:
                flush()
        flush()

    dt = time.time() - t0
    print(json.dumps({
        "metric": "predict_images_per_sec",
        "value": round(n_done / dt, 2),
        "unit": "images/sec",
        "images": n_done,
        "mode": "sliding_window" if args.sliding_window else "batched",
        "exported": args.exported is not None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
