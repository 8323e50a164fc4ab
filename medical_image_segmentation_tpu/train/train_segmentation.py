"""U-Net segmentation training entry point (fit → test → predict).

Parity with the reference `train/train_segmentation.py` (argparse :13-38,
main :41-93): Decathlon datamodule by name, LARS + warmup-cosine with
min_lr, Dice loss, val dice/iou per epoch, final test pass, optional
prediction grid dumps. Fixes vs the reference (SURVEY §"known bugs"):

- the reference silently used the **Heart** stats module on **Liver** paths
  (`train_segmentation.py:64-69`); here the datamodule name is explicit;
- the **SSL→segmentation handoff actually exists**: ``--ssl_checkpoint``
  restores a BYOL backbone into the U-Net encoder before training
  (the point of the whole pipeline, never wired in the reference).

Resilience matches the SSL trainer (the reference got per-epoch
checkpointing + ``ckpt_path`` resume from the PL Trainer defaults,
`train_segmentation.py:51-61`): ``--checkpoint_every_epochs`` periodic
saves, ``--resume`` continues step count + data order, and SIGTERM/SIGINT
triggers a lockstep-agreed checkpoint-and-exit across hosts
(train/resilience.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="U-Net medical segmentation")
    ap.add_argument("--dataset", default="DECATHLON_LIVER")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--split_file", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_epochs", type=int, default=50)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--min_lr", type=float, default=1e-2)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/seg")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint_dir "
                         "(restores step count and the per-epoch data order)")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1,
                    help="periodic checkpoint cadence (0 = final checkpoint only)")
    ap.add_argument("--ssl_checkpoint", default=None,
                    help="orbax BYOL checkpoint to initialize the U-Net encoder from")
    ap.add_argument("--predict_grid", default=None, help="path for a pred/truth overlay grid PNG")
    ap.add_argument("--loss", default="dice", choices=["dice", "dice_ce"])
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (level:width, stored-value units) stacked "
                         "as input channels — the 'view it like a radiologist' multi-window "
                         "representation (PAPERS.md); applied at train, eval AND serving. "
                         "e.g. '96:160,40:80,170:170' on a uint8 store")
    ap.add_argument("--seg_store_prefix", default="",
                    help="paired MIS store prefix from create_seg_store.py (C++ loader fast path)")
    ap.add_argument("--full_res_window", type=int, default=0,
                    help=">0: also evaluate test slices at native resolution via sliding-window blending")
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each residual block (less activation memory)")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight projected-HBM guard (core/hbm.py)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the step's projected HBM exceeds device "
                         "capacity (it would fail to allocate on the GPU)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the first N steps with jax.profiler into <log_dir>/trace "
                         "and print per-stage loader timers each epoch")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.checkpoint import (
        latest_step,
        load_byol_encoder_into_unet,
        restore_checkpoint,
        save_checkpoint,
    )
    from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
    from medical_image_segmentation_tpu.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu.parallel import initialize_distributed, make_mesh, replicated, shard_batch
    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask
    from medical_image_segmentation_tpu.utils.viz import save_combined_image_grid
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    initialize_distributed()
    enable_compile_cache()
    mesh = make_mesh()
    if args.batch_size % len(jax.devices()) != 0:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by the device count {len(jax.devices())}"
        )
    proc, nproc = jax.process_index(), jax.process_count()
    is_main = proc == 0

    dm = get_datamodule(args.dataset)(
        images_dir=args.images_dir, masks_dir=args.masks_dir,
        split_file=args.split_file, image_size=args.image_size,
        store_prefix=args.seg_store_prefix,
    )
    per_host = args.batch_size // nproc
    train_loader = dm.loader("train", per_host, seed=args.seed, shard=(proc, nproc),
                             num_threads=args.num_workers)
    if len(train_loader) == 0:
        # drop_last batching: batch > dataset yields 0 steps/epoch — the run
        # would silently train nothing (see train_segmentation3d.py).
        raise SystemExit(
            f"--batch_size {args.batch_size} (per host {per_host}) exceeds "
            "the train split: every epoch would run 0 steps. Lower "
            "--batch_size to at most the train-set size.")
    steps_per_epoch = max(len(train_loader), 1)
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)

    from medical_image_segmentation_tpu.ops.augment import parse_hu_windows

    hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
    in_ch = len(hu_windows) if hu_windows else 1
    task = SegmentationTask(
        arch=args.arch, n_classes=1, in_channels=in_ch,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        min_lr=args.min_lr, steps_per_epoch=steps_per_epoch, loss=args.loss,
        dtype=jnp.bfloat16 if args.bf16 else jnp.float32, remat=args.remat,
    )
    state = task.init(jax.random.key(args.seed), (2, args.image_size, args.image_size, in_ch))

    if args.ssl_checkpoint:
        byol_vars = restore_checkpoint(args.ssl_checkpoint)
        unet_vars = {"params": state.params, "batch_stats": state.batch_stats}
        # BYOLState checkpoints store params/batch_stats at the top level
        src = {"params": byol_vars["params"], "batch_stats": byol_vars["batch_stats"]}
        new_vars = load_byol_encoder_into_unet(unet_vars, src)
        state = state.replace(params=new_vars["params"], batch_stats=new_vars["batch_stats"])
        print(f"initialized encoder from {args.ssl_checkpoint}", file=sys.stderr)

    start_epoch = 0
    skip_batches = 0
    if args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            state = restore_checkpoint(os.path.join(args.checkpoint_dir, str(step)), state)
            start_epoch = int(np.asarray(state.step)) // steps_per_epoch
            # a preemption checkpoint can land mid-epoch: skip the batches
            # state.step already counts, or the resumed run would retrain
            # them and overshoot max_epochs*steps_per_epoch (exhausting the
            # LR schedule early). Data order is deterministic per
            # (seed, epoch), so the skipped prefix is what was trained.
            skip_batches = int(np.asarray(state.step)) % steps_per_epoch
            # continue the data order instead of replaying epoch 0's permutation
            train_loader.epoch = start_epoch
            print(f"resumed from step {int(np.asarray(state.step))} (epoch {start_epoch}"
                  + (f", skipping {skip_batches} trained batches" if skip_batches else "")
                  + ")", file=sys.stderr)

    state = jax.device_put(state, replicated(mesh))
    mean, std = tuple(dm.mean), tuple(dm.std)
    size = (args.image_size, args.image_size)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    @partial(jax.jit, donate_argnums=0)
    def train_step(state, imgs, msks, key):
        x, y = segmentation_augment(key, imgs, msks, out_size=size, mean=mean, std=std,
                                    train=True, dtype=dtype, hu_windows=hu_windows)
        return task.train_step(state, x, y)

    # Pre-flight projected-memory guard: refuse a config
    # whose compiled step oversubscribes the device BEFORE training, with the
    # fix levers named (--remat / smaller batch). No-op on CPU test meshes.
    from medical_image_segmentation_tpu.core.hbm import guard_step
    from medical_image_segmentation_tpu.parallel.mesh import data_sharding

    img_spec = jax.ShapeDtypeStruct(
        (args.batch_size, args.image_size, args.image_size, 1), jnp.uint8,
        sharding=data_sharding(mesh, ndim=4))
    guard_step(train_step, (state, img_spec, img_spec, jax.random.key(0)),
               label=f"seg train step (arch {args.arch}, batch {args.batch_size})",
               skip=args.skip_hbm_check, force=args.force_hbm)

    @jax.jit
    def eval_step(state, imgs, msks):
        x, y = segmentation_augment(jax.random.key(0), imgs, msks, out_size=size,
                                    mean=mean, std=std, train=False, dtype=dtype,
                                    hu_windows=hu_windows)
        return task.eval_step(state, x, y)

    def run_eval(split: str):
        import contextlib

        # closing(): store-backed loaders hold an mmap + fd and are rebuilt
        # every epoch — leak-free on every exit path
        with contextlib.closing(
            dm.loader(split, per_host, shard=(proc, nproc), num_threads=args.num_workers)
        ) as loader:
            if len(loader) == 0:
                return None
            aggr = {"loss": 0.0, "dice": 0.0, "iou": 0.0}
            n = 0
            for imgs, msks in loader:
                b = shard_batch(mesh, {"i": imgs, "m": msks})
                m = eval_step(state, b["i"], b["m"])
                for k in aggr:
                    aggr[k] += float(m[k])
                n += 1
        return {f"{split}/{k}": v / n for k, v in aggr.items()}

    logger = CSVMetricsLogger(args.log_dir) if is_main else None
    # fold the restored step count in so a resumed run continues the
    # augmentation RNG stream instead of replaying step 0's randomness
    key = jax.random.fold_in(jax.random.key(args.seed + 1), int(np.asarray(state.step)))

    # preemption: SIGTERM/SIGINT → lockstep-agreed checkpoint + clean exit
    # (same machinery as the SSL trainer, train/resilience.py)
    from medical_image_segmentation_tpu.train.resilience import PreemptionGuard

    guard = PreemptionGuard(nproc)

    def _checkpoint():
        # COLLECTIVE: orbax saves run cross-process barriers, so every host
        # must call this — all call sites are lockstep points (agreed stop,
        # epoch boundaries). See train_ssl._checkpoint.
        payload = jax.device_get(state) if nproc == 1 else state
        path = save_checkpoint(args.checkpoint_dir, payload, int(np.asarray(state.step)))
        if is_main:
            print(f"checkpoint → {path}", file=sys.stderr)

    from medical_image_segmentation_tpu.core.profiling import StepProfiler

    prof = StepProfiler(args.profile if is_main else 0, args.log_dir)

    try:
        for epoch in range(start_epoch, args.max_epochs):
            t0 = time.time()
            metrics = {}
            n_imgs = 0
            for i, (imgs, msks) in enumerate(train_loader):
                if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                    break
                if epoch == start_epoch and i < skip_batches:
                    continue  # already trained before the preemption
                key = jax.random.fold_in(key, 1)
                b = shard_batch(mesh, {"i": imgs, "m": msks})
                state, metrics = train_step(state, b["i"], b["m"], key)
                n_imgs += args.batch_size
                prof.tick(metrics["train/loss"])  # fence only consumed when stopping
                if guard.stop_agreed(i):
                    _checkpoint()
                    return 0  # finally: flushes the profiler trace
            # epoch-end sync: catches signals in epochs shorter than the step
            # boundary (every host reaches here after the same batch count)
            if guard.stop_agreed(at_epoch_end=True):
                _checkpoint()
                return 0
            if metrics:
                loss = float(metrics["train/loss"])  # host fence
                if is_main:
                    print(f"epoch {epoch}: train/loss={loss:.4f} {n_imgs/(time.time()-t0):.0f} img/s", file=sys.stderr)
                    if args.profile and hasattr(train_loader, "timers"):
                        print(f"loader stages (epoch {epoch}):\n"
                              f"{train_loader.timers.report(reset=True)}",
                              file=sys.stderr)
                    logger.log({k: float(v) for k, v in metrics.items()},
                               step=int(np.asarray(state.step)), epoch=epoch)
            val = run_eval("val")
            if val and is_main:
                print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in val.items()), file=sys.stderr)
                logger.log(val, step=int(np.asarray(state.step)), epoch=epoch)
            if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0 \
                    and (epoch + 1) < args.max_epochs:  # final epoch saves below
                _checkpoint()

    finally:
        # flush the trace even if the run raises (e.g. an HBM OOM is
        # exactly when the partial trace is most wanted)
        prof.stop()
    test = run_eval("test")
    if test and is_main:
        print("test: " + " ".join(f"{k}={v:.4f}" for k, v in test.items()), file=sys.stderr)
        logger.log(test, step=int(np.asarray(state.step)), epoch=args.max_epochs)

    # final checkpoint — a lockstep point: all hosts finish the epoch loop
    # after the same batch count.
    _checkpoint()

    if args.full_res_window and is_main:
        from medical_image_segmentation_tpu.eval.sliding_window import make_unet_window_fn, sliding_window_predict
        from medical_image_segmentation_tpu.ops.dice import dice_coefficient, jaccard_index, post_process_masks

        ds = dm.dataset("test")
        window_fn = make_unet_window_fn(task, jax.device_get(state))
        mean_a = np.asarray(mean, np.float32)
        std_a = np.asarray(std, np.float32)
        dices, ious = [], []
        from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

        for i in range(len(ds)):
            img, msk = ds[i]
            x01 = img.astype(np.float32)[..., None] / 255.0  # (H, W, 1)
            if hu_windows:  # same input representation the network trained on
                x01 = np.asarray(apply_hu_windows(jnp.asarray(x01), hu_windows))
            x = (x01 - mean_a) / std_a  # (H, W, C)
            logits = sliding_window_predict(
                window_fn, jnp.asarray(x), window=args.full_res_window,
                mesh=mesh if nproc == 1 else None,  # all local chips serve windows
            )
            pred = post_process_masks(logits)
            dices.append(float(dice_coefficient(pred, jnp.asarray(msk[..., None], jnp.float32))))
            ious.append(float(jaccard_index(pred, jnp.asarray(msk[..., None], jnp.float32))))
        if dices:
            print(
                f"full-res sliding-window test: dice={np.mean(dices):.4f} iou={np.mean(ious):.4f} "
                f"({len(dices)} slices, window {args.full_res_window})",
                file=sys.stderr,
            )
            logger.log({"test/full_res_dice": float(np.mean(dices)),
                        "test/full_res_iou": float(np.mean(ious))},
                       step=int(np.asarray(state.step)), epoch=args.max_epochs)

    if args.predict_grid and is_main:
        loader = dm.loader("test", min(per_host, 16), shard=(0, 1))
        for imgs, msks in loader:
            x, y = segmentation_augment(jax.random.key(0), jnp.asarray(imgs), jnp.asarray(msks),
                                        out_size=size, mean=mean, std=std, train=False,
                                        dtype=dtype, hu_windows=hu_windows)
            pred = task.predict_step(state, x)
            save_combined_image_grid(np.asarray(imgs), np.asarray(pred), np.asarray(msks), args.predict_grid)
            print(f"prediction grid → {args.predict_grid}", file=sys.stderr)
            break

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
