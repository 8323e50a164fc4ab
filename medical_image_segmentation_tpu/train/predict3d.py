"""Volumetric mask inference CLI (3D model serving).

Companion to `mis-predict` for the 3D path (`train/predict.py` serves 2D
slices): loads a `Segmentation3DTask` checkpoint and serves binary masks
for a directory of NIfTI volumes at native resolution via overlapped
sliding-window blending (`eval/sliding_window.py::sliding_window_predict_3d`).
The reference has no volumetric path and no serving path at all
(`train_segmentation.py:82-93` only dumps grids during training).

  mis-predict3d --checkpoint ckpt/seg3d --features 32 64 128 256 \\
      --images_dir volumes/ --output_dir masks/ --window 32 64 64

Masks are written as uint8 0/1 NIfTI volumes named after their inputs in
the source (X, Y, Z) axis order, so they overlay the input volume in any
viewer. A one-line JSON throughput summary is printed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Volumetric 3D U-Net mask inference")
    ap.add_argument("--checkpoint", default=None,
                    help="seg3d checkpoint directory (latest step) or a specific step path")
    ap.add_argument("--exported", default=None,
                    help="serve from an AOT window .misx artifact (mis-export3d) instead of "
                         "a checkpoint: window shape, normalization and hu_windows come from "
                         "the artifact; no model code or restore")
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--window", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="sliding-window shape (matches the training crop)")
    ap.add_argument("--mean", type=float, default=0.2089, help="normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--images_dir", required=True, help="directory of .nii/.nii.gz volumes")
    ap.add_argument("--output_dir", required=True, help="masks written here as 0/1 uint8 NIfTI")
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut for the binary mask")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (0-1 scale) stacked as input channels — "
                         "must match the --hu_windows the checkpoint trained with")
    ap.add_argument("--batch_windows", type=int, default=4)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.core.checkpoint import resolve_checkpoint_path, restore_checkpoint
    from medical_image_segmentation_tpu.data.nifti import read_nifti, write_nifti
    from medical_image_segmentation_tpu.eval.sliding_window import (
        make_fused_predictor_3d,
        sliding_window_predict_3d,
    )
    from medical_image_segmentation_tpu.parallel import make_mesh, replicated
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

    from medical_image_segmentation_tpu.ops.augment import parse_hu_windows

    if (args.checkpoint is None) == (args.exported is None):
        raise SystemExit("exactly one of --checkpoint / --exported is required")

    mesh = None
    if args.exported is not None:
        # AOT window artifact: weights, hu_windows and normalize are baked in
        # — the loop below feeds RAW 0..1 windows and blends logits.
        from medical_image_segmentation_tpu.serve import load_window_predictor

        meta, window_fn = load_window_predictor(args.exported)
        args.window = tuple(meta["window"])
        args.batch_windows = int(meta["batch_windows"])
        hu_windows = ()  # applied inside the artifact
        normalize_host = False
        print(f"loaded {args.exported} (step {meta.get('checkpoint_step')}, "
              f"window {args.window} x{args.batch_windows})", file=sys.stderr)
    else:
        normalize_host = True
        hu_windows = (parse_hu_windows(args.hu_windows, value_max=1.0)
                      if args.hu_windows else ())
        in_ch = len(hu_windows) if hu_windows else 1
        task = Segmentation3DTask(
            in_channels=in_ch, features=tuple(args.features), norm=args.norm,
            learning_rate=1.0, warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
            dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
        )
        state = task.init(jax.random.key(0), (1, *args.window, in_ch))
        ckpt = resolve_checkpoint_path(args.checkpoint)
        state = restore_checkpoint(ckpt, state)
        print(f"restored {ckpt} (step {int(np.asarray(state.step))})", file=sys.stderr)

        mesh = make_mesh()
        state = jax.device_put(state, replicated(mesh))
        host_state = jax.device_get(state)

        @jax.jit
        def window_fn(windows):
            variables = {"params": host_state.params}
            if host_state.batch_stats:
                variables["batch_stats"] = host_state.batch_stats
            return task.model.apply(variables, windows, train=False)

    os.makedirs(args.output_dir, exist_ok=True)

    names = sorted(
        f for f in os.listdir(args.images_dir)
        if (f.endswith(".nii") or f.endswith(".nii.gz")) and not f.startswith(".")
    )
    if not names:
        raise SystemExit(f"no NIfTI volumes under {args.images_dir}")

    t0 = time.time()
    n_vox = 0
    fused_cache = {}
    for name in names:
        vol = read_nifti(os.path.join(args.images_dir, name)).get_fdata()
        if vol.ndim == 4:
            vol = vol[..., 0]
        lo, hi = float(vol.min()), float(vol.max())
        x = (vol - lo) / (hi - lo) if hi > lo else vol * 0.0
        # (X, Y, Z) → (D=Z, H=X, W=Y), the volumes.py convention
        x = np.moveaxis(x.astype(np.float32), -1, 0)[..., None]
        if hu_windows:
            from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

            x = np.asarray(apply_hu_windows(jnp.asarray(x), hu_windows))
        if normalize_host:  # exported artifacts normalize (+window) inside
            x = (x - args.mean) / args.std
        from medical_image_segmentation_tpu.eval.sliding_window import _window_starts

        n_win = 1
        for full, w in zip(x.shape[:3], args.window):
            n_win *= len(_window_starts(max(full, w), w, max(1, w // 2)))
        multi_chip = mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1
        if multi_chip or n_win > 64:
            # several devices: shard window batches over the data axis.
            # Large tilings (>64 windows, e.g. whole-CT 125-window volumes)
            # also keep the loop variant: the fused scan program's compile
            # time grows with the tiling, and at that many windows the
            # per-batch dispatch overhead is amortized anyway
            logits = sliding_window_predict_3d(
                window_fn, jnp.asarray(x), window=tuple(args.window),
                batch_windows=args.batch_windows, mesh=mesh,
            )
        else:
            # one device, moderate tiling: ONE fused dispatch per volume,
            # specialized (and cached) per volume-shape class — no
            # per-batch program launches or coordinate uploads
            pred = fused_cache.get(x.shape)
            if pred is None:
                pred = fused_cache[x.shape] = make_fused_predictor_3d(
                    window_fn, x.shape, window=tuple(args.window),
                    batch_windows=args.batch_windows)
            logits = pred(jnp.asarray(x))
        mask = (jax.nn.sigmoid(logits.astype(jnp.float32)) > args.threshold)
        mask = np.moveaxis(np.asarray(mask[..., 0], np.uint8), 0, -1)  # back to (X, Y, Z)
        stem = name.split(".nii")[0]
        out = os.path.join(args.output_dir, f"{stem}_mask.nii.gz")
        write_nifti(out, mask)
        n_vox += mask.size
        print(f"{name}: {mask.shape} mask → {out} ({float(mask.mean()):.4f} foreground)",
              file=sys.stderr)
    dt = time.time() - t0
    print(json.dumps({
        "metric": "predict3d_megavoxels_per_sec",
        "value": round(n_vox / dt / 1e6, 3),
        "unit": "Mvox/s",
        "volumes": len(names),
        "window": list(args.window),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
