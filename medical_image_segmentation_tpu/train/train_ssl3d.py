"""Volumetric BYOL pretraining entry point.

Beyond-reference capability completing the 3D story: the reference's SSL
pipeline is 2D-only (BYOL over FFCV image crops); this CLI pretrains a 3D
encoder (`models/unet3d.py::UNet3DEncoder`) with BYOL on UNLABELED NIfTI
volumes — two random sub-volume crop views per volume
(`ops/augment3d.py::byol_two_view_augment_3d`), the same symmetric
``2 - 2·cos`` objective, EMA target, LARS + warmup-cosine as the 2D task
(`train/byol_task.py` is shape-agnostic; only the backbone and the view
pipeline change).

The pretrained encoder grafts into a ``UNet3D`` by block-name subtree copy
(`core/checkpoint.py::load_byol3d_encoder_into_unet3d`), consumed by
``mis-train-segmentation3d --ssl_checkpoint`` — the volumetric analogue of
the SSL→segmentation handoff this repo added over the reference.
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
    ap = argparse.ArgumentParser(description="Volumetric BYOL pretraining")
    ap.add_argument("--images_dir", required=True, help="directory of unlabeled .nii/.nii.gz volumes")
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96), metavar=("D", "H", "W"))
    ap.add_argument("--crop_size", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="view crop (must divide 2^(len(features)-1))")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--ema_momentum", type=float, default=0.99)
    ap.add_argument("--mean", type=float, default=0.2089)
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl3d")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight projected-HBM guard (core/hbm.py)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the step's projected HBM exceeds device "
                         "capacity (it would fail to allocate on the GPU)")
    ap.add_argument("--cache_volumes", action="store_true",
                    help="keep decoded volumes in host RAM between epochs "
                         "(len(ds)·∏volume_size·4 bytes; NIfTI gunzip+parse "
                         "otherwise repeats every epoch)")
    ap.add_argument("--device_cache", action="store_true",
                    help="ship the WHOLE unlabeled corpus to device HBM once "
                         "and gather batches on-device by index — epochs then "
                         "cost zero host→device volume traffic (the narrow-"
                         "link/few-core analogue of --host_precrop; "
                         "len(ds)·∏volume_size·4 bytes of HBM; single-process "
                         "runs only)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
    from medical_image_segmentation_tpu.data.volumes import UnlabeledVolumeDataset, VolumeLoader
    from medical_image_segmentation_tpu.ops.augment3d import byol_two_view_augment_3d
    from medical_image_segmentation_tpu.parallel import initialize_distributed, make_mesh, replicated, shard_batch
    from medical_image_segmentation_tpu.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu.train.resilience import PreemptionGuard
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache

    initialize_distributed()
    enable_compile_cache()
    mesh = make_mesh()
    ndev = len(jax.devices())
    if args.batch_size % ndev:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by the device count {ndev}")
    proc, nproc = jax.process_index(), jax.process_count()
    is_main = proc == 0

    ds = UnlabeledVolumeDataset(args.images_dir, target_shape=tuple(args.volume_size),
                                cache=args.cache_volumes)
    per_host = args.batch_size // nproc
    loader = VolumeLoader(ds, per_host, shuffle=True, seed=args.seed,
                          num_hosts=nproc, host_id=proc)
    if len(loader) == 0:
        # drop_last batching: batch > dataset yields 0 steps/epoch — the run
        # would silently train nothing (see train_segmentation3d.py).
        raise SystemExit(
            f"--batch_size {args.batch_size} (per host {per_host}) exceeds the "
            f"unlabeled set ({len(ds)} volumes): every epoch would run 0 "
            "steps. Lower --batch_size to at most the dataset size.")
    steps_per_epoch = max(len(loader), 1)
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)
    total_steps = steps_per_epoch * args.max_epochs

    crop = tuple(args.crop_size)
    task = BYOLTask(
        volumetric=True, features3d=tuple(args.features), in_channels=1,
        hidden_dim=args.hidden_dim, proj_dim=args.projection_dim, num_classes=2,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        base_ema_momentum=args.ema_momentum, total_steps=total_steps,
        steps_per_epoch=steps_per_epoch, probe_loss_weight=0.0,
        dtype=jnp.bfloat16 if args.bf16 else jnp.float32, remat=args.remat,
    )
    state = task.init(jax.random.key(args.seed), (1, *crop, 1))

    start_epoch = 0
    skip_batches = 0
    if args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            state = restore_checkpoint(os.path.join(args.checkpoint_dir, str(step)), state)
            start_epoch = int(np.asarray(state.step)) // steps_per_epoch
            skip_batches = int(np.asarray(state.step)) % steps_per_epoch
            loader.epoch = start_epoch
            print(f"resumed from step {int(np.asarray(state.step))} (epoch {start_epoch})",
                  file=sys.stderr)

    state = jax.device_put(state, replicated(mesh))
    mean, std = (args.mean,), (args.std,)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    from medical_image_segmentation_tpu.core.hbm import guard_step
    from medical_image_segmentation_tpu.parallel.mesh import data_sharding

    @partial(jax.jit, donate_argnums=0)
    def train_step(state, vols, key):
        v1, v2 = byol_two_view_augment_3d(key, vols, out_size=crop, mean=mean, std=std,
                                          dtype=dtype)
        return task.train_step(state, v1, v2)

    corpus = None
    if args.device_cache:
        if nproc > 1:
            raise SystemExit("--device_cache is single-process only (a per-host "
                             "corpus would desynchronize the global shuffle); "
                             "use --cache_volumes on multi-host runs")
        # one bulk upload, then epochs cost zero host-to-device traffic —
        # on a narrow host link this is the difference between link-bound
        # and device-bound pretraining
        host_corpus = np.stack([ds[i][0] for i in range(len(ds))])
        corpus = jax.device_put(jnp.asarray(host_corpus), replicated(mesh))
        del host_corpus
        print(f"device corpus cache: {len(ds)} volumes, "
              f"{corpus.nbytes / 2**30:.2f} GiB HBM resident", file=sys.stderr)

        # the corpus is an ARGUMENT, not a closure capture: closed-over
        # jax.Arrays are hoisted as compile-time constants, and a GiB-scale
        # constant stalls lowering/cache serialization; as a parameter the
        # device-resident array is passed by reference each call
        @partial(jax.jit, donate_argnums=0)
        def train_step_cached(state, corpus, idx, key):
            vols = jnp.take(corpus, idx, axis=0)
            vols = jax.lax.with_sharding_constraint(
                vols, data_sharding(mesh, ndim=5))
            v1, v2 = byol_two_view_augment_3d(key, vols, out_size=crop,
                                              mean=mean, std=std, dtype=dtype)
            return task.train_step(state, v1, v2)

    # Pre-flight projected-memory guard: BYOL's two-tower EMA state is
    # heavier per sample than the seg3d step. AOT-compile at the exact batch
    # shapes and refuse a step that would not fit before the run starts.
    # No-op on CPU test meshes.
    if corpus is not None:
        idx_spec = jax.ShapeDtypeStruct((per_host,), jnp.int32)
        corpus_spec = jax.ShapeDtypeStruct(corpus.shape, corpus.dtype,
                                           sharding=corpus.sharding)
        guard_step(train_step_cached,
                   (state, corpus_spec, idx_spec, jax.random.key(0)),
                   label=f"ssl3d cached train step (batch {args.batch_size} "
                         f"+ {corpus.nbytes / 2**30:.2f} GiB corpus)",
                   skip=args.skip_hbm_check, force=args.force_hbm)
    else:
        vol_spec = jax.ShapeDtypeStruct(
            (args.batch_size, *args.volume_size, 1), jnp.float32,
            sharding=data_sharding(mesh, ndim=5))
        guard_step(train_step, (state, vol_spec, jax.random.key(0)),
                   label=f"ssl3d train step (batch {args.batch_size})",
                   skip=args.skip_hbm_check, force=args.force_hbm)

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
        batches = loader.iter_index_batches() if corpus is not None else loader
        for i, item in enumerate(batches):
            if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                break
            if epoch == start_epoch and i < skip_batches:
                continue
            key = jax.random.fold_in(key, 1)
            if corpus is not None:
                state, metrics = train_step_cached(state, corpus,
                                                   jnp.asarray(item), key)
            else:
                b = shard_batch(mesh, item[0])
                state, metrics = train_step(state, b, key)
            n_vols += args.batch_size
            if guard.stop_agreed(i):
                _checkpoint()
                return 0
        if guard.stop_agreed(at_epoch_end=True):
            _checkpoint()
            return 0
        if metrics:
            loss = float(metrics["loss"])  # host fence
            if is_main:
                print(f"epoch {epoch}: loss={loss:.4f} tau={float(metrics['momentum']):.4f} "
                      f"{n_vols/(time.time()-t0):.1f} vol/s", file=sys.stderr)
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=int(np.asarray(state.step)), epoch=epoch)
        if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0 \
                and (epoch + 1) < args.max_epochs:
            _checkpoint()

    _checkpoint()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
