"""mis-export: package a trained segmentation checkpoint as a deployable
AOT serving artifact (``.misx``, see ``medical_image_segmentation_tpu.serve``).

The artifact embeds the EXACT jitted function ``mis-predict`` runs — uint8
batch → normalize → U-Net eval forward → sigmoid-threshold mask — with the
trained weights as constants, lowered ahead-of-time for one or more
platforms. Serving hosts load it with ``mis-predict --exported model.misx``
(or ``serve.load_predictor``) — no model code, no checkpoint restore.

The reference has no deployment path at all (inference only exists as
``trainer.predict`` grid dumps inside the training script, reference
``train_segmentation.py:82-93``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Export a segmentation checkpoint as an AOT .misx serving artifact")
    ap.add_argument("--checkpoint", required=True,
                    help="segmentation checkpoint directory (latest step) or a specific step path")
    ap.add_argument("--output", required=True, help="output .misx path")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--dataset", default=None,
                    help="datamodule name to pull normalization stats from (e.g. DECATHLON_LIVER)")
    ap.add_argument("--mean", type=float, default=None, help="override normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=None, help="override normalization std (0-1 scale)")
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut baked into the artifact")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows stacked as input channels — must match "
                         "the --hu_windows the checkpoint trained with; baked into the artifact")
    ap.add_argument("--batch_sizes", default="1,8,64",
                    help="comma-separated static batch buckets to export (requests "
                         "greedily decompose over the largest buckets that fit; only a "
                         "remainder smaller than every bucket pads)")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated lowering platforms, e.g. 'cuda,cpu' — one "
                         "artifact serves on every listed platform (default: current)")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from medical_image_segmentation_tpu.core.checkpoint import resolve_checkpoint_path, restore_checkpoint
    from medical_image_segmentation_tpu.serve import artifact_platforms, export_predictor, save_predictor
    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

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

    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
    platforms = [p.strip() for p in args.platforms.split(",")] if args.platforms else None
    exported = export_predictor(
        task, state, image_size=args.image_size, mean=mean, std=std,
        threshold=args.threshold, batch_sizes=batch_sizes, platforms=platforms,
        fp32=not args.bf16, hu_windows=hu_windows,
    )
    meta = {
        "kind": "batched2d",
        "arch": args.arch,
        "image_size": args.image_size,
        "mean": mean,
        "std": std,
        "threshold": args.threshold,
        "hu_windows": [list(w) for w in hu_windows],
        "batch_sizes": sorted(exported),
        "platforms": artifact_platforms(exported),
        "checkpoint_step": int(np.asarray(state.step)),
        "jax_version": jax.__version__,
        "dtype": "float32" if not args.bf16 else "bfloat16",
    }
    save_predictor(args.output, exported, meta)
    print(json.dumps({
        "artifact": args.output,
        "bytes": os.path.getsize(args.output),
        **{k: meta[k] for k in ("batch_sizes", "platforms", "checkpoint_step")},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
