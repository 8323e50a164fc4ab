"""BYOL self-supervised pretraining entry point.

Parity with the reference `train/train_ssl.py` (argparse :16-63, main
:66-89): same flag surface and defaults (dataset registry name, batch 256,
lr 1.0, wd 1e-6, warmup 10, proj 256, hidden 4096, momentum 0.99→1.0,
workers/devices from SLURM env), plus what this stack adds:
checkpoint/resume, KNN + linear probes actually wired (the reference
callbacks are bit-rotted, SURVEY §"known bugs"), and a single jitted
augment+train step instead of Lightning/DDP.

Distributed: `jax.distributed` multi-host; the mesh spans all chips on one
``data`` axis; each host's loader reads its own shard
(shard = (process_index, process_count)).
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
    ap = argparse.ArgumentParser(description="BYOL SSL pretraining")
    # reference flag surface (train_ssl.py:16-63)
    ap.add_argument("--dataset", default="CIFAR10")
    ap.add_argument("--batch_size", type=int, default=256, help="global batch size")
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--base_momentum", type=float, default=0.99)
    ap.add_argument("--final_momentum", type=float, default=1.0)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--seed", type=int, default=0)
    # additions beyond the reference
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--val_every_epochs", type=int, default=1)
    ap.add_argument("--knn_every_epochs", type=int, default=0, help="0 disables the KNN probe")
    ap.add_argument("--knn_bank_size", type=int, default=262144,
                    help="cap on the KNN feature-bank rows (first-N, deterministic under "
                         "the loader seed); 0 = unbounded. At 1M×512-d f32 an unbounded "
                         "bank is ~2 GB on top of the two-tower state")
    ap.add_argument("--knn_bank_chunk", type=int, default=65536,
                    help="stream the similarity matmul over bank chunks of this many rows "
                         "(never materializes the (B, N) matrix); 0 = unchunked")
    ap.add_argument("--val_full_image", action="store_true",
                    help="validate on full stored images (normalize only) — exact parity "
                         "with the reference val pipeline (SimpleRGBImageDecoder + "
                         "Normalize, lightning_module.py:180-191). Default center-crops "
                         "to the train crop size, which is cheaper at stored 256² and "
                         "changes val/acc@k semantics slightly")
    ap.add_argument("--probe_loss_weight", type=float, default=1.0)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0, help="smoke-test cap (0 = full epoch)")
    ap.add_argument("--run_single_validation", action="store_true",
                    help="load --checkpoint_path (or latest in --checkpoint_dir) and run one val pass, no training "
                         "(the working version of the reference's stale scripts/train/val_ssl_pl_test)")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--aug_recipe", default=None, choices=["ffcv", "torchvision"],
                    help="SSL view pipeline: the reference's FFCV recipe (default) or its "
                         "torchvision variant with ColorJitter+GaussianBlur "
                         "(lightning_module.py:39-64)")
    ap.add_argument("--window_prob", type=float, default=None,
                    help="random CT re-windowing probability (0 = reference parity)")
    ap.add_argument("--host_precrop", action="store_true",
                    help="RandomResizedCrop in the C++ decode workers: ship 2x crop^2 "
                         "views instead of full images (~2.6x fewer H2D bytes at "
                         "256->112) and run only the elementwise augment tail on "
                         "device. Parity with the device path is bit-tested "
                         "(tests/test_precrop.py); requires a blur-free recipe "
                         "(the torchvision recipe needs the device resampler)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each residual block (less activation memory, "
                         "~1/3 more bwd FLOPs) — for resnet101/152 or very large batches")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight projected-HBM guard (core/hbm.py)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the step's projected memory exceeds device "
                         "capacity (e.g. resnet152 at batch 1024 without --remat "
                         "fails to allocate)")
    ap.add_argument("--model_parallel", type=int, default=1, metavar="N",
                    help="tensor-parallel degree for the MLP heads: devices form a "
                         "(data, model) mesh and the projector/predictor are "
                         "Megatron-sharded (parallel/tp.py); 1 = pure data parallel")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the first N steps with jax.profiler into <log_dir>/trace "
                         "and print per-stage loader timers each epoch")
    return ap.parse_args(argv)


def _val_preprocess(imgs, dm, full_image: bool = False):
    """Validation preprocessing with val stats.

    ``full_image=True`` is exact reference parity: the full stored image,
    normalize only (`SimpleRGBImageDecoder` + `NormalizeImage`, reference
    `lightning_module.py:180-191` — val never crops). The default
    (``full_image=False``) center-crops to the train crop size first
    (CenterCrop + Normalize, `lightning_module.py:154-177,239-248` semantics)
    — 4× cheaper at stored 256² vs 112² crops, but a deliberate,
    documented deviation that slightly changes val/acc@k semantics.
    Pinned by tests/test_tasks.py::test_val_preprocess_reference_parity."""
    import jax.numpy as jnp

    x = imgs.astype(jnp.float32)
    if not full_image:
        b, h, w, c = imgs.shape
        s = min(h, w, dm.crop_size)
        y0, x0 = (h - s) // 2, (w - s) // 2
        x = x[:, y0 : y0 + s, x0 : x0 + s, :]
    return (x - jnp.asarray(dm.val_mean)) / jnp.asarray(dm.val_std)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu.core.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache
    from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
    from medical_image_segmentation_tpu.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu.data.loader import device_put_sharded_batches
    from medical_image_segmentation_tpu.eval.knn import KNNEvaluator
    from medical_image_segmentation_tpu.ops.augment import two_view_augment
    from medical_image_segmentation_tpu.parallel import initialize_distributed, make_mesh, replicated
    from medical_image_segmentation_tpu.train.byol_task import BYOLTask

    initialize_distributed()
    enable_compile_cache()
    n_dev = len(jax.devices())
    mp = args.model_parallel
    if mp > 1:
        if n_dev % mp != 0:
            raise SystemExit(f"--model_parallel {mp} must divide the device count {n_dev}")
        if args.hidden_dim % mp != 0:
            raise SystemExit(f"--hidden_dim {args.hidden_dim} must be divisible by --model_parallel {mp}")
        mesh = make_mesh(axis_names=("data", "model"), axis_sizes=(n_dev // mp, mp))
    else:
        mesh = make_mesh()
    if args.batch_size % n_dev != 0:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by the device count {n_dev}"
        )
    proc, nproc = jax.process_index(), jax.process_count()
    is_main = proc == 0
    print(f"process {proc}/{nproc}: {n_dev} global devices ({jax.default_backend()})",
          file=sys.stderr)

    dm = get_datamodule(args.dataset)()
    if args.aug_recipe is not None:
        dm.aug_recipe = args.aug_recipe
    if args.window_prob is not None:
        dm.window_prob = args.window_prob
    cfg1, cfg2 = dm.view_configs()
    precrop = None
    if args.host_precrop:
        from medical_image_segmentation_tpu.ops.augment import precrop_supported

        if not (precrop_supported(cfg1) and precrop_supported(cfg2)):
            raise SystemExit(
                "--host_precrop requires an all-elementwise post-crop recipe "
                "(no GaussianBlur) — use the default ffcv recipe, not torchvision")
        if (cfg1.crop_scale, cfg1.crop_ratio, cfg1.hflip_prob) != (
                cfg2.crop_scale, cfg2.crop_ratio, cfg2.hflip_prob):
            raise SystemExit("--host_precrop needs both views to share crop geometry")
        precrop = {
            "out_hw": (dm.crop_size, dm.crop_size), "n_views": 2,
            "scale": cfg1.crop_scale, "ratio": cfg1.crop_ratio,
            "hflip_prob": cfg1.hflip_prob,
        }
    per_host_batch = args.batch_size // nproc
    train_loader = dm.train_loader(per_host_batch, num_threads=args.num_workers,
                                   seed=args.seed, shard=(proc, nproc), distributed=nproc > 1,
                                   precrop=precrop)
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        # drop_last batching: batch > dataset yields 0 steps/epoch — the run
        # would silently train nothing (see train_segmentation3d.py).
        raise SystemExit(
            f"--batch_size {args.batch_size} (per host {per_host_batch}) "
            "exceeds the train set: every epoch would run 0 steps. Lower "
            "--batch_size to at most the dataset size.")
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)
    total_steps = steps_per_epoch * args.max_epochs

    task = BYOLTask(
        arch=args.arch, in_channels=dm.channels, low_res=dm.low_res,
        hidden_dim=args.hidden_dim, proj_dim=args.projection_dim,
        num_classes=dm.NUM_CLASSES,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        base_ema_momentum=args.base_momentum, final_ema_momentum=args.final_momentum,
        total_steps=total_steps, steps_per_epoch=steps_per_epoch,
        probe_loss_weight=args.probe_loss_weight,
        dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
        remat=args.remat,
    )
    sample = (2, dm.crop_size, dm.crop_size, dm.channels)
    state = task.init(jax.random.key(args.seed), sample)
    if mp > 1:
        from medical_image_segmentation_tpu.parallel import byol_tp_shardings

        state = jax.device_put(state, byol_tp_shardings(mesh, state, args.hidden_dim))
    else:
        state = jax.device_put(state, replicated(mesh))

    if args.run_single_validation:
        path = args.checkpoint_path
        if path is None:
            step = latest_step(args.checkpoint_dir)
            if step is None:
                raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
            path = os.path.join(args.checkpoint_dir, str(step))
        state = restore_checkpoint(path, state)
        val_loader = dm.val_loader(per_host_batch, num_threads=args.num_workers, shard=(proc, nproc))
        aggr = {"val/loss": 0.0, "val/acc@1": 0.0, "val/acc@5": 0.0}
        n_b = 0
        for imgs, labels in device_put_sharded_batches(val_loader, mesh):
            m = task.val_step(state, _val_preprocess(imgs, dm, args.val_full_image), labels)
            for k in aggr:
                aggr[k] += float(m[k])
            n_b += 1
        aggr = {k: v / max(n_b, 1) for k, v in aggr.items()}
        print(" ".join(f"{k}={v:.4f}" for k, v in aggr.items()))
        return 0

    start_epoch = 0
    skip_batches = 0
    if args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            state = restore_checkpoint(os.path.join(args.checkpoint_dir, str(step)), state)
            start_epoch = int(np.asarray(state.step)) // steps_per_epoch
            # a preemption checkpoint can land mid-epoch: skip the batches
            # state.step already counts, or the resumed run would retrain
            # them and overshoot total_steps (exhausting the LR schedule
            # early). The data order is deterministic per (seed, epoch), so
            # the skipped prefix is exactly what the interrupted run saw.
            skip_batches = int(np.asarray(state.step)) % steps_per_epoch
            # continue the data order and augmentation stream instead of
            # replaying epoch 0's randomness
            train_loader.epoch = start_epoch
            print(f"resumed from step {int(np.asarray(state.step))} (epoch {start_epoch}"
                  + (f", skipping {skip_batches} trained batches" if skip_batches else "")
                  + ")", file=sys.stderr)

    mean, std = tuple(dm.train_mean), tuple(dm.train_std)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    has_labels = getattr(dm, "has_train_labels", True)

    # donate the state: the inner task.train_step's donate hint is ignored
    # under nested jit, and without it the full BYOLState is double-buffered
    @partial(jax.jit, donate_argnums=0)
    def train_step(state, imgs, labels, key):
        labels = labels if has_labels else None
        if args.host_precrop:
            # imgs: (2B, crop, crop, C) pre-cropped views from the C++ loader
            from medical_image_segmentation_tpu.ops.augment import two_view_tail_augment

            v1, v2 = two_view_tail_augment(key, imgs, cfg1, cfg2, mean=mean, std=std, dtype=dtype)
        else:
            v1, v2 = two_view_augment(key, imgs, cfg1, cfg2, mean=mean, std=std, dtype=dtype)
        return task.train_step(state, v1, v2, labels)

    # Pre-flight projected-memory guard: a step that cannot fit the device
    # (e.g. resnet152 at batch 1024 without --remat) is refused up front
    # with the diagnosis instead of failing to allocate mid-epoch. Specs match
    # what device_put_sharded_batches actually ships: pre-cropped (2B,c,c,C)
    # views in --host_precrop mode, full stored frames otherwise, in the
    # store's sample dtype (uint8, or uint16 for FLAG_U16 stores).
    from medical_image_segmentation_tpu.core.hbm import guard_step
    from medical_image_segmentation_tpu.parallel.mesh import data_sharding

    img_shape = ((2 * args.batch_size, dm.crop_size, dm.crop_size, train_loader.channels)
                 if args.host_precrop
                 else (args.batch_size, *train_loader.out_hw, train_loader.channels))
    guard_step(
        train_step,
        (state,
         jax.ShapeDtypeStruct(img_shape, jnp.dtype(train_loader.dtype),
                              sharding=data_sharding(mesh, ndim=4)),
         jax.ShapeDtypeStruct((args.batch_size,), jnp.int32,
                              sharding=data_sharding(mesh, ndim=1)),
         jax.random.key(0)),
        label=f"ssl train step (arch {args.arch}, batch {args.batch_size})",
        skip=args.skip_hbm_check, force=args.force_hbm)

    logger = CSVMetricsLogger(args.log_dir) if is_main else None
    key = jax.random.fold_in(jax.random.key(args.seed + 1), int(np.asarray(state.step)))

    # preemption safety: on SIGTERM/SIGINT finish the current step, agree the
    # stop across hosts at a lockstep boundary, checkpoint, exit 0 (resume
    # with --resume). Shared with the segmentation trainer (resilience.py).
    from medical_image_segmentation_tpu.train.resilience import PreemptionGuard

    guard = PreemptionGuard(nproc)
    _stop_agreed = guard.stop_agreed

    def _checkpoint():
        # COLLECTIVE: the save gathers the state across processes, so every
        # host must call it — a host-0-only save would pair that gather with
        # the peers' next train-step collectives and hang. Process 0 writes
        # (core/checkpoint.py). All call sites are lockstep points (agreed
        # stop, epoch boundaries).
        payload = jax.device_get(state) if nproc == 1 else state
        path = save_checkpoint(args.checkpoint_dir, payload, int(np.asarray(state.step)))
        if is_main:
            print(f"checkpoint → {path}", file=sys.stderr)

    # --profile N: jax.profiler trace of the first N steps (SURVEY §5.1 —
    # the reference has no profiling at all) + per-stage loader timers
    from medical_image_segmentation_tpu.core.profiling import StepProfiler

    prof = StepProfiler(args.profile if is_main else 0, args.log_dir)

    try:
        for epoch in range(start_epoch, args.max_epochs):
            t0 = time.time()
            n_imgs = 0
            metrics = {}
            for i, (imgs, labels) in enumerate(device_put_sharded_batches(train_loader, mesh)):
                if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                    break
                if epoch == start_epoch and i < skip_batches:
                    continue  # already trained before the preemption
                key = jax.random.fold_in(key, 1)
                state, metrics = train_step(state, imgs, labels, key)
                n_imgs += args.batch_size
                prof.tick(metrics["loss"])  # fence only consumed when stopping
                if _stop_agreed(i):
                    _checkpoint()
                    return 0  # finally: flushes the profiler trace
                if logger and (i % 50 == 0):
                    logger.log({k: float(v) for k, v in metrics.items()}, step=int(np.asarray(state.step)), epoch=epoch)
            # epoch-end sync: catches signals in epochs shorter than the step
            # boundary (every host reaches here after the same batch count)
            if _stop_agreed(at_epoch_end=True):
                _checkpoint()
                return 0  # finally: flushes the profiler trace
            if metrics:
                jax.block_until_ready(metrics)
                dt = time.time() - t0
                last_loss = float(metrics["loss"])
                if is_main:
                    print(
                        f"epoch {epoch}: loss={last_loss:.4f} "
                        f"{n_imgs/dt:.0f} img/s ({n_imgs/dt/n_dev:.0f}/chip) "
                        f"lr={float(metrics['lr']):.4f} tau={float(metrics['momentum']):.5f}",
                        file=sys.stderr,
                    )
                    if args.profile:
                        print(f"loader stages (epoch {epoch}):\n"
                              f"{train_loader.timers.report(reset=True)}",
                              file=sys.stderr)

            if args.val_every_epochs and (epoch + 1) % args.val_every_epochs == 0:
                try:
                    val_loader = dm.val_loader(per_host_batch, num_threads=args.num_workers, shard=(proc, nproc))
                except FileNotFoundError:
                    val_loader = None
                if val_loader is not None:
                    import contextlib

                    aggr = {"val/loss": 0.0, "val/acc@1": 0.0, "val/acc@5": 0.0}
                    n_b = 0
                    # closing(): rebuilt each val epoch — don't leak the
                    # store mmap/fd, on any exit path
                    with contextlib.closing(val_loader):
                        for imgs, labels in device_put_sharded_batches(val_loader, mesh):
                            x = _val_preprocess(imgs, dm, args.val_full_image)
                            m = task.val_step(state, x, labels)
                            for k in aggr:
                                aggr[k] += float(m[k])
                            n_b += 1
                    if n_b and is_main:
                        aggr = {k: v / n_b for k, v in aggr.items()}
                        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in aggr.items()), file=sys.stderr)
                        logger.log(aggr, step=int(np.asarray(state.step)), epoch=epoch)

            if args.knn_every_epochs and (epoch + 1) % args.knn_every_epochs == 0:
                try:
                    # contextlib.closing: probe loaders are rebuilt every probe
                    # epoch — without close() each leaks a store mmap + fd
                    import contextlib

                    with contextlib.closing(
                        dm.train_loader(per_host_batch, num_threads=args.num_workers,
                                        seed=args.seed, shard=(proc, nproc))
                    ) as bank_loader, contextlib.closing(
                        dm.val_loader(per_host_batch, num_threads=args.num_workers, shard=(proc, nproc))
                    ) as val_loader:
                        ev = KNNEvaluator(
                            num_classes=dm.NUM_CLASSES,
                            max_bank_size=args.knn_bank_size or None,
                            bank_chunk_size=args.knn_bank_chunk or None,
                        )
                        # feed mesh-global arrays: state is committed to the mesh,
                        # so host-local batches would raise "incompatible devices"
                        # on multi-host — the same device feed the train/val use
                        acc = ev.evaluate(
                            lambda x: task.embed_step(state, _val_preprocess(x, dm, args.val_full_image)),
                            device_put_sharded_batches(bank_loader, mesh),
                            device_put_sharded_batches(val_loader, mesh),
                        )
                    if is_main:
                        print(f"epoch {epoch}: online_knn_val_acc={acc:.4f}", file=sys.stderr)
                        logger.log({"online_knn_val_acc": acc}, step=int(np.asarray(state.step)), epoch=epoch)
                except FileNotFoundError:
                    pass

            if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0:
                _checkpoint()

    finally:
        # flush the trace even if the run raises (e.g. an HBM OOM is
        # exactly when the partial trace is most wanted)
        prof.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
