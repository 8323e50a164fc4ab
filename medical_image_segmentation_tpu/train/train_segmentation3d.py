"""Volumetric (3D U-Net) segmentation training entry point.

Beyond-reference capability: the reference can only train on 2D slices
(`medical_image_segmentation/train/train_segmentation.py` consumes PNGs
from `slice_medical_decathlon_scans.py`). This CLI trains directly on
Medical Decathlon NIfTI volumes:

- host: `data/volumes.py` loads/pads volumes to a static shape;
- device: paired random crop/flip/jitter in `ops/augment3d.py`;
- model: `models/unet3d.py` (3³ convs), Dice semantics identical to the
  2D path;
- scaling: ``--space_shards S`` builds a ("data","space") mesh and shards
  volumes over batch AND depth — XLA GSPMD inserts the 3D conv halo
  exchanges (`parallel/mesh.py::spatial_sharding(ndim=5)`), so volumes
  larger than one chip's activation budget train without slicing.

Resilience matches the 2D trainers: periodic checkpoints, ``--resume``
(step count + data order + RNG stream), SIGTERM/SIGINT lockstep-agreed
preemption checkpoint (train/resilience.py).
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
    ap = argparse.ArgumentParser(description="3D U-Net volumetric segmentation")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--split_file", default=None)
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96), metavar=("D", "H", "W"),
                    help="static host-side pad/crop shape (XLA needs fixed shapes)")
    ap.add_argument("--crop_size", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="device-side random train crop (center crop at eval)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_epochs", type=int, default=50)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--min_lr", type=float, default=1e-2)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--mean", type=float, default=0.2089, help="dataset mean on the 0-1 scale")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--loss", default="dice", choices=["dice", "dice_ce"])
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (level:width on the 0-1 intensity scale) "
                         "stacked as input channels — multi-window CT representation; "
                         "applied at train, eval, and sliding-window eval")
    ap.add_argument("--space_shards", type=int, default=1,
                    help=">1: shard volume depth over a ('data','space') mesh (halo via GSPMD)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/seg3d")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--ssl_checkpoint", default=None,
                    help="volumetric-BYOL checkpoint (train_ssl3d) to initialize the encoder from")
    ap.add_argument("--full_res_window", type=int, nargs=3, default=None, metavar=("D", "H", "W"),
                    help="after training, evaluate test volumes at native resolution "
                         "via overlapped sliding-window blending (eval/sliding_window.py)")
    ap.add_argument("--eval_every_epochs", type=int, default=1,
                    help="run the val split every N epochs (the final epoch "
                         "always evaluates; test always runs at the end) — "
                         "on high-latency device links the per-epoch metric "
                         "fences can dominate short-epoch fine-tunes")
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--remat", action="store_true", help="checkpoint each conv block")
    ap.add_argument("--cache_volumes", action="store_true",
                    help="keep decoded volumes in host RAM between epochs "
                         "(len(ds)·∏volume_size·8 bytes; NIfTI gunzip+parse "
                         "otherwise repeats every epoch)")
    ap.add_argument("--device_cache", action="store_true",
                    help="ship each split's volumes+masks to device HBM once "
                         "and gather batches on-device by index — train AND "
                         "per-epoch val cost zero host→device volume traffic "
                         "(narrow-link/few-core hosts; single-process only)")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-run projected-memory guard (one extra AOT "
                         "compile, kept by the persistent compile cache)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even when the step is projected to exceed device "
                         "memory (it would fail to allocate on the GPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
    from medical_image_segmentation_tpu.data.volumes import DecathlonVolumeDataset, VolumeLoader
    from medical_image_segmentation_tpu.ops.augment3d import segmentation_augment_3d
    from medical_image_segmentation_tpu.parallel import initialize_distributed, make_mesh, replicated, shard_batch
    from medical_image_segmentation_tpu.parallel.mesh import spatial_sharding
    from medical_image_segmentation_tpu.train.resilience import PreemptionGuard
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    initialize_distributed()
    enable_compile_cache()
    ndev = len(jax.devices())
    if args.space_shards > 1:
        if ndev % args.space_shards:
            raise SystemExit(f"--space_shards {args.space_shards} must divide the device count {ndev}")
        mesh = make_mesh(axis_names=("data", "space"),
                         axis_sizes=(ndev // args.space_shards, args.space_shards))
        data_shards = ndev // args.space_shards
        if args.crop_size[0] % args.space_shards:
            raise SystemExit("--crop_size depth must be divisible by --space_shards")
        # XLA's spatial partitioning computes a 3³ convolution's input
        # gradient wrongly when a shard holds a single slice (the forward
        # pass stays right), so the bottleneck keeps two slices per shard
        bottom = args.crop_size[0] // 2 ** (len(args.features) - 1)
        if bottom % args.space_shards or bottom // args.space_shards < 2:
            raise SystemExit(
                f"--space_shards {args.space_shards} splits the bottleneck's depth {bottom} "
                f"(crop depth / 2^{len(args.features) - 1}) into fewer than 2 slices per "
                "shard, where sharded convolution gradients are wrong; use a deeper "
                "--crop_size or fewer shards")
    else:
        mesh = make_mesh()
        data_shards = ndev
    if args.batch_size % data_shards:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by the data shards {data_shards}")
    proc, nproc = jax.process_index(), jax.process_count()
    is_main = proc == 0

    ds_train = DecathlonVolumeDataset(args.images_dir, args.masks_dir,
                                      target_shape=tuple(args.volume_size),
                                      split_file=args.split_file, split="train",
                                      cache=args.cache_volumes)
    per_host = args.batch_size // nproc
    train_loader = VolumeLoader(ds_train, per_host, shuffle=True, seed=args.seed,
                                num_hosts=nproc, host_id=proc)
    if len(train_loader) == 0:
        # drop_last batching: a batch larger than the (sharded) train set
        # yields ZERO steps/epoch — training would silently no-op while val
        # metrics stay frozen at the init's scores.
        raise SystemExit(
            f"--batch_size {args.batch_size} (per host {per_host}) exceeds the "
            f"train split ({len(ds_train)} volumes): every epoch would run 0 "
            "steps. Lower --batch_size to at most the train-set size.")
    steps_per_epoch = max(len(train_loader), 1)
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)

    from medical_image_segmentation_tpu.ops.augment import parse_hu_windows

    hu_windows = (parse_hu_windows(args.hu_windows, value_max=1.0)
                  if args.hu_windows else ())
    in_ch = len(hu_windows) if hu_windows else 1
    task = Segmentation3DTask(
        n_classes=1, in_channels=in_ch, features=tuple(args.features), norm=args.norm,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        min_lr=args.min_lr, steps_per_epoch=steps_per_epoch, loss=args.loss,
        dtype=jnp.bfloat16 if args.bf16 else jnp.float32, remat=args.remat,
    )
    crop = tuple(args.crop_size)
    state = task.init(jax.random.key(args.seed), (1, *crop, in_ch))

    if args.ssl_checkpoint:
        from medical_image_segmentation_tpu.core.checkpoint import load_byol3d_encoder_into_unet3d

        byol_vars = restore_checkpoint(args.ssl_checkpoint)
        unet_vars = {"params": state.params, "batch_stats": state.batch_stats}
        src = {"params": byol_vars["params"], "batch_stats": byol_vars.get("batch_stats", {})}
        new_vars = load_byol3d_encoder_into_unet3d(unet_vars, src)
        state = state.replace(params=new_vars["params"],
                              batch_stats=new_vars.get("batch_stats", state.batch_stats))
        print(f"initialized 3D encoder from {args.ssl_checkpoint}", file=sys.stderr)

    start_epoch = 0
    skip_batches = 0
    if args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            state = restore_checkpoint(os.path.join(args.checkpoint_dir, str(step)), state)
            start_epoch = int(np.asarray(state.step)) // steps_per_epoch
            skip_batches = int(np.asarray(state.step)) % steps_per_epoch
            train_loader.epoch = start_epoch
            print(f"resumed from step {int(np.asarray(state.step))} (epoch {start_epoch}"
                  + (f", skipping {skip_batches} trained batches" if skip_batches else "")
                  + ")", file=sys.stderr)

    state = jax.device_put(state, replicated(mesh))
    mean, std = (args.mean,), (args.std,)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    vol_sharding = spatial_sharding(mesh, ndim=5) if args.space_shards > 1 else None

    @partial(jax.jit, donate_argnums=0)
    def train_step(state, vols, msks, key):
        x, y = segmentation_augment_3d(key, vols, msks, out_size=crop, mean=mean, std=std,
                                       hu_windows=hu_windows,
                                       train=True, dtype=dtype)
        if vol_sharding is not None:
            x = jax.lax.with_sharding_constraint(x, vol_sharding)
            y = jax.lax.with_sharding_constraint(y, vol_sharding)
        return task.train_step(state, x, y)

    from medical_image_segmentation_tpu.core.hbm import guard_step
    from medical_image_segmentation_tpu.parallel.mesh import data_sharding

    train_corpus = None
    if args.device_cache:
        if nproc > 1:
            raise SystemExit("--device_cache is single-process only (a per-host "
                             "corpus would desynchronize the global shuffle); "
                             "use --cache_volumes on multi-host runs")

        def build_corpus(ds):
            """(imgs f32, masks u8) device-resident; masks binarized 0/1 so
            the u8→f32 cast back is exact."""
            imgs, msks = zip(*(ds[i] for i in range(len(ds))))
            iv = jax.device_put(jnp.asarray(np.stack(imgs)), replicated(mesh))
            mv = jax.device_put(jnp.asarray(np.stack(msks).astype(np.uint8)),
                                replicated(mesh))
            return iv, mv

        train_corpus = build_corpus(ds_train)
        print(f"device corpus cache (train): {len(ds_train)} volumes, "
              f"{(train_corpus[0].nbytes + train_corpus[1].nbytes) / 2**30:.2f} "
              f"GiB HBM resident", file=sys.stderr)

        # corpora are ARGUMENTS, not closure captures: closed-over jax.Arrays
        # are hoisted as compile-time constants, and GiB-scale constants
        # stall lowering/cache serialization; as parameters the device-
        # resident arrays are passed by reference each call
        @partial(jax.jit, donate_argnums=0)
        def train_step_cached(state, iv, mv, idx, key):
            vols = jnp.take(iv, idx, axis=0)
            msks = jnp.take(mv, idx, axis=0).astype(jnp.float32)
            x, y = segmentation_augment_3d(key, vols, msks, out_size=crop,
                                           mean=mean, std=std,
                                           hu_windows=hu_windows,
                                           train=True, dtype=dtype)
            if vol_sharding is not None:
                x = jax.lax.with_sharding_constraint(x, vol_sharding)
                y = jax.lax.with_sharding_constraint(y, vol_sharding)
            return task.train_step(state, x, y)

    # Projected-memory guard: AOT-compile the step at the exact batch shapes
    # and refuse if XLA's static memory plan exceeds the device, BEFORE the
    # run starts (on the GPU such a step fails to allocate). Skipped on CPU
    # backends (no capacity to check; tests use the virtual CPU mesh).
    if train_corpus is not None:
        idx_spec = jax.ShapeDtypeStruct((per_host,), jnp.int32)
        specs = tuple(jax.ShapeDtypeStruct(c.shape, c.dtype, sharding=c.sharding)
                      for c in train_corpus)
        guard_step(train_step_cached,
                   (state, *specs, idx_spec, jax.random.key(0)),
                   label=f"seg3d cached train step (batch {args.batch_size})",
                   skip=args.skip_hbm_check, force=args.force_hbm)
    else:
        spec = jax.ShapeDtypeStruct(
            (args.batch_size, *args.volume_size, 1), jnp.float32,
            sharding=data_sharding(mesh, ndim=5))
        guard_step(train_step, (state, spec, spec, jax.random.key(0)),
                   label=f"seg3d train step (batch {args.batch_size})",
                   skip=args.skip_hbm_check, force=args.force_hbm)

    @jax.jit
    def eval_step(state, vols, msks):
        x, y = segmentation_augment_3d(jax.random.key(0), vols, msks, out_size=crop,
                                       mean=mean, std=std, train=False, dtype=dtype,
                                       hu_windows=hu_windows)
        return task.eval_step(state, x, y)

    # eval contexts are built ONCE per split and reused every epoch (the old
    # per-epoch dataset rebuild re-decoded NIfTIs each time); --device_cache
    # additionally pins each split's volumes on device so per-epoch val costs
    # zero host→device volume traffic
    _eval_ctx: dict = {}

    def _get_eval_ctx(split: str):
        if split in _eval_ctx:
            return _eval_ctx[split]
        ctx = None
        try:
            ds = DecathlonVolumeDataset(args.images_dir, args.masks_dir,
                                        target_shape=tuple(args.volume_size),
                                        split_file=args.split_file, split=split,
                                        cache=args.cache_volumes)
        except ValueError:
            ds = None
        if ds is not None:
            loader = VolumeLoader(ds, per_host, shuffle=False, drop_last=False,
                                  num_hosts=nproc, host_id=proc)
            if len(loader) > 0:
                corpora = build_corpus(ds) if args.device_cache else None
                ctx = (loader, corpora)
        _eval_ctx[split] = ctx
        return ctx

    @jax.jit
    def eval_step_cached(state, iv, mv, idx):
        v = jnp.take(iv, idx, axis=0)
        m = jnp.take(mv, idx, axis=0).astype(jnp.float32)
        x, y = segmentation_augment_3d(jax.random.key(0), v, m, out_size=crop,
                                       mean=mean, std=std, train=False,
                                       dtype=dtype, hu_windows=hu_windows)
        return task.eval_step(state, x, y)

    def run_eval(split: str):
        ctx = _get_eval_ctx(split)
        if ctx is None:
            return None
        loader, corpora = ctx
        aggr = {"loss": 0.0, "dice": 0.0, "iou": 0.0}
        n = 0
        if corpora is not None:
            for idx in loader.iter_index_batches():
                m = eval_step_cached(state, *corpora, jnp.asarray(idx))
                for k in aggr:
                    aggr[k] += float(m[k])
                n += 1
        else:
            for vols, msks in loader:
                b = shard_batch(mesh, {"v": vols, "m": msks})
                m = eval_step(state, b["v"], b["m"])
                for k in aggr:
                    aggr[k] += float(m[k])
                n += 1
        return {f"{split}/{k}": v / n for k, v in aggr.items()}

    logger = CSVMetricsLogger(args.log_dir) if is_main else None
    key = jax.random.fold_in(jax.random.key(args.seed + 1), int(np.asarray(state.step)))
    guard = PreemptionGuard(nproc)

    def _checkpoint():
        # COLLECTIVE: every host must call (orbax cross-process barriers)
        payload = jax.device_get(state) if nproc == 1 else state
        path = save_checkpoint(args.checkpoint_dir, payload, int(np.asarray(state.step)))
        if is_main:
            print(f"checkpoint → {path}", file=sys.stderr)

    for epoch in range(start_epoch, args.max_epochs):
        t0 = time.time()
        metrics = {}
        n_vols = 0
        batches = (train_loader.iter_index_batches() if train_corpus is not None
                   else train_loader)
        for i, item in enumerate(batches):
            if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                break
            if epoch == start_epoch and i < skip_batches:
                continue
            key = jax.random.fold_in(key, 1)
            if train_corpus is not None:
                state, metrics = train_step_cached(state, *train_corpus,
                                                   jnp.asarray(item), key)
            else:
                vols, msks = item
                b = shard_batch(mesh, {"v": vols, "m": msks})
                state, metrics = train_step(state, b["v"], b["m"], key)
            n_vols += args.batch_size
            if guard.stop_agreed(i):
                _checkpoint()
                return 0
        if guard.stop_agreed(at_epoch_end=True):
            _checkpoint()
            return 0
        if metrics:
            loss = float(metrics["train/loss"])  # host fence
            if is_main:
                print(f"epoch {epoch}: train/loss={loss:.4f} "
                      f"{n_vols/(time.time()-t0):.1f} vol/s", file=sys.stderr)
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=int(np.asarray(state.step)), epoch=epoch)
        val = (run_eval("val")
               if args.eval_every_epochs and (
                   (epoch + 1) % args.eval_every_epochs == 0
                   or epoch + 1 == args.max_epochs)
               else None)
        if val and is_main:
            print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in val.items()), file=sys.stderr)
            logger.log(val, step=int(np.asarray(state.step)), epoch=epoch)
        if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0 \
                and (epoch + 1) < args.max_epochs:
            _checkpoint()

    test = run_eval("test")
    if test and is_main:
        print("test: " + " ".join(f"{k}={v:.4f}" for k, v in test.items()), file=sys.stderr)
        logger.log(test, step=int(np.asarray(state.step)), epoch=args.max_epochs)
    _checkpoint()

    if args.full_res_window and is_main:
        from medical_image_segmentation_tpu.eval.sliding_window import sliding_window_predict_3d
        from medical_image_segmentation_tpu.ops.dice import dice_coefficient, jaccard_index, post_process_masks

        try:
            ds_test = DecathlonVolumeDataset(args.images_dir, args.masks_dir,
                                             target_shape=tuple(args.volume_size),
                                             split_file=args.split_file, split="test")
        except ValueError:
            ds_test = ds_train

        host_state = jax.device_get(state)

        @jax.jit
        def window_fn(windows):
            variables = {"params": host_state.params}
            if host_state.batch_stats:
                variables["batch_stats"] = host_state.batch_stats
            return task.model.apply(variables, windows, train=False)

        dices, ious = [], []
        from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

        for i in range(len(ds_test)):
            vol, msk = ds_test.raw(i)
            if hu_windows:  # same input representation the network trained on
                vol = np.asarray(apply_hu_windows(jnp.asarray(vol), hu_windows))
            x = (vol - args.mean) / args.std
            logits = sliding_window_predict_3d(
                window_fn, jnp.asarray(x), window=tuple(args.full_res_window),
                mesh=mesh if nproc == 1 else None,
            )
            pred = post_process_masks(logits)
            dices.append(float(dice_coefficient(pred, jnp.asarray(msk))))
            ious.append(float(jaccard_index(pred, jnp.asarray(msk))))
        if dices:
            print(f"full-res sliding-window test: dice={np.mean(dices):.4f} "
                  f"iou={np.mean(ious):.4f} ({len(dices)} volumes, "
                  f"window {tuple(args.full_res_window)})", file=sys.stderr)
            logger.log({"test/full_res_dice": float(np.mean(dices)),
                        "test/full_res_iou": float(np.mean(ious))},
                       step=int(np.asarray(state.step)), epoch=args.max_epochs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
