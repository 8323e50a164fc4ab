"""mis-export3d: package a trained volumetric (3D U-Net) checkpoint as an
AOT window-function artifact (``.misx``, kind ``window3d``).

The artifact is the sliding-window ``apply_fn``: raw 0..1 windows
(batch_windows, d, h, w, 1) float32 → logits, with multi-window channel
stacking, normalization, and the trained weights baked into serialized
StableHLO. ``mis-predict3d --exported model.misx`` serves whole NIfTI
volumes from it — window extraction and the Hann blend stay on the host,
every FLOP goes through the artifact, and the serving host needs no model
code or checkpoint restore.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Export a seg3d checkpoint as an AOT .misx window artifact")
    ap.add_argument("--checkpoint", required=True,
                    help="seg3d checkpoint directory (latest step) or a specific step path")
    ap.add_argument("--output", required=True, help="output .misx path")
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--window", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="window shape (matches the training crop)")
    ap.add_argument("--mean", type=float, default=0.2089, help="normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (0-1 scale) the checkpoint trained with; baked in")
    ap.add_argument("--batch_windows", type=int, default=4,
                    help="static window batch baked into the artifact")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated lowering platforms, e.g. 'cuda,cpu'")
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
    from medical_image_segmentation_tpu.ops.augment import parse_hu_windows
    from medical_image_segmentation_tpu.serve import artifact_platforms, export_window_predictor, save_predictor
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

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

    platforms = [p.strip() for p in args.platforms.split(",")] if args.platforms else None
    exported = export_window_predictor(
        task, state, window=args.window, mean=args.mean, std=args.std,
        batch_windows=args.batch_windows, platforms=platforms,
        fp32=not args.bf16, hu_windows=hu_windows,
    )
    meta = {
        "kind": "window3d",
        "window": [int(v) for v in args.window],
        "batch_windows": args.batch_windows,
        "features": list(args.features),
        "norm": args.norm,
        "mean": args.mean,
        "std": args.std,
        "hu_windows": [list(w) for w in hu_windows],
        "platforms": artifact_platforms(exported),
        "checkpoint_step": int(np.asarray(state.step)),
        "jax_version": jax.__version__,
        "dtype": "float32" if not args.bf16 else "bfloat16",
    }
    save_predictor(args.output, exported, meta)
    print(json.dumps({
        "artifact": args.output,
        "bytes": os.path.getsize(args.output),
        **{k: meta[k] for k in ("window", "batch_windows", "platforms", "checkpoint_step")},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
