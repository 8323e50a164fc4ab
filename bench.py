"""End-to-end benchmark: on-device two-view augmentation + BYOL train step.

Workload = the reference's canonical SSL pretrain config
(`scripts/train/train_ssl_pl_test`: BYOL resnet18, 112^2 crops) fed from
256^2 stored uint8 grayscale images.

Two modes:
- default: device-resident batch (isolates aug+train — the device ceiling);
- ``--store PATH`` (or ``--store auto`` to synthesize one): feeds a real MIS
  store through the C++ decode loader + prefetch thread + ``device_put``
  double-buffering — the full input pipeline in the loop (the reference's
  FFCV os_cache path, `lightning_module.py:141-151`).

Runs on a GPU only (it exits when JAX finds none). Prints ONE JSON line:
  {"metric": "aug_train_images_per_sec_per_chip", "value": N,
   "unit": "images/sec/chip", "vs_baseline": N / 5000.0, ...}
(vs_baseline divides by 5000 img/s/chip, the earlier rounds' target; the
reference itself publishes no numbers). No line carries a utilization:
XLA's cost analysis on the GPU leaves out the cuDNN convolutions, which are
most of every step here, so a share of the card's peak (``PEAKS``) waits
for a FLOP count made from the step's shapes.

Each timed path is built by one function (``byol_case``, ``seg_case``,
``seg3d_case``, ``predict_case``, ``predict3d_case``); ``chip_smoke.py``
runs the same builders on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Published peaks per card, keyed by jax's device_kind: dense bf16 FLOP/s
# (no sparsity) and HBM bytes/s. Source: NVIDIA H100 Tensor Core GPU data
# sheet (SXM: 989 TFLOP/s, 3.35 TB/s; PCIe: 756 TFLOP/s, 2.0 TB/s). They
# assume the card's full power limit; report nvidia-smi's power.limit beside
# any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16_flops": 756e12, "hbm_bytes_per_s": 2.0e12},
}

# Default sizes of the timed paths. byol stores 256² and trains on 112²
# views; seg/predict run the reference's canonical 224²
# (train_segmentation.py:35); seg3d/predict3d follow train_segmentation3d.
BATCH = {"byol": 1024, "seg": 128, "seg3d": 4, "predict": 256, "predict3d": 8}
IMAGE_SIZE = {"byol": 256, "seg": 224, "seg3d": 256, "predict": 224, "predict3d": 256}
CROP = 112
VOLUME = (64, 96, 96)
CROP3D = (32, 64, 64)
FEATURES3D = (32, 64, 128, 256)
LIVER_MEAN, LIVER_STD = 0.2089, 0.2109  # liver registry stats


def peak_flops(kind: str) -> float:
    """Dense bf16 peak FLOP/s of one card of ``kind``; an unknown kind raises."""
    if kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {kind!r}; add it to bench.PEAKS")
    return PEAKS[kind]["bf16_flops"]


def byol_case(mesh, batch_size: int = BATCH["byol"], image_size: int = IMAGE_SIZE["byol"],
              crop_size: int = CROP, arch: str = "resnet18", remat: bool = False,
              precrop: bool = False):
    """The flagship: BYOL ``arch`` (heads 4096/256) on two ``crop_size``² views
    augmented on the device from ``image_size``² uint8 images, as the trainer
    runs it. Returns ``(step, state, batch, augment)``: ``step(state, batch,
    key)`` gives ``(state, metrics)`` and ``augment(key, batch)`` the two
    views alone. With ``precrop`` the batch is the loader's 2B pre-cropped
    views (rows 2i, 2i+1) and only the elementwise tail runs on the device."""
    from medical_image_segmentation_tpu.ops.augment import (
        BYOL_VIEW1, BYOL_VIEW2, two_view_augment, two_view_tail_augment,
    )
    from medical_image_segmentation_tpu.parallel import replicated, shard_batch
    from medical_image_segmentation_tpu.train import BYOLTask

    task = BYOLTask(
        arch=arch, in_channels=1, hidden_dim=4096, proj_dim=256,
        num_classes=10, total_steps=100_000,
        learning_rate=1.0, warmup_epochs=10, max_epochs=200,
        remat=remat,
    )
    state = jax.device_put(task.init(jax.random.key(0), (2, crop_size, crop_size, 1)),
                           replicated(mesh))
    cfg1, cfg2 = (dataclasses.replace(c, out_size=(crop_size, crop_size))
                  for c in (BYOL_VIEW1, BYOL_VIEW2))
    augment = partial(two_view_tail_augment if precrop else two_view_augment, cfg1=cfg1, cfg2=cfg2)

    @partial(jax.jit, donate_argnums=0)
    def step(state, batch, key):
        v1, v2 = augment(key, batch)
        return task.train_step(state, v1, v2)

    shape = ((2 * batch_size, crop_size, crop_size, 1) if precrop
             else (batch_size, image_size, image_size, 1))
    batch = shard_batch(mesh, np.random.default_rng(0).integers(0, 256, size=shape).astype(np.uint8))
    return step, state, batch, augment


def seg_case(mesh, batch_size: int = BATCH["seg"], image_size: int = IMAGE_SIZE["seg"],
             arch: str = "resnet18", remat: bool = False):
    """U-Net(``arch``) training with the trainer's device-side paired
    augmentation (the reference's canonical seg config: 224², batch 512 over
    4 GPUs → 128 per card, `train_segmentation.py:22,35`). Returns ``(step,
    state, inputs)``: ``step(state, *inputs, key)`` gives ``(state, metrics)``."""
    from medical_image_segmentation_tpu.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu.parallel import replicated, shard_batch
    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

    size = (image_size, image_size)
    task = SegmentationTask(
        arch=arch, n_classes=1, in_channels=1, learning_rate=1.0,
        warmup_epochs=10, max_epochs=50, steps_per_epoch=100, remat=remat,
    )
    state = jax.device_put(task.init(jax.random.key(0), (2, *size, 1)), replicated(mesh))

    @partial(jax.jit, donate_argnums=0)
    def step(state, imgs, msks, key):
        x, y = segmentation_augment(key, imgs, msks, out_size=size,
                                    mean=(LIVER_MEAN,), std=(LIVER_STD,), train=True,
                                    dtype=jnp.bfloat16)
        return task.train_step(state, x, y)

    rng = np.random.default_rng(0)
    shape = (batch_size, *size, 1)
    imgs = shard_batch(mesh, rng.integers(0, 256, size=shape).astype(np.uint8))
    msks = shard_batch(mesh, (rng.random(shape) < 0.2).astype(np.uint8))
    return step, state, (imgs, msks)


def seg3d_case(mesh, batch_size: int = BATCH["seg3d"], volume=VOLUME, crop=CROP3D,
               features=FEATURES3D, remat: bool = False):
    """3D U-Net training on random ``crop`` crops of stored ``volume``
    volumes (`train_segmentation3d.py` defaults). Returns ``(step, state,
    inputs)`` like ``seg_case``."""
    from medical_image_segmentation_tpu.ops.augment3d import segmentation_augment_3d
    from medical_image_segmentation_tpu.parallel import replicated, shard_batch
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

    crop = tuple(crop)
    task = Segmentation3DTask(
        features=tuple(features),
        learning_rate=1.0, warmup_epochs=10, max_epochs=50, steps_per_epoch=100,
        remat=remat,
    )
    state = jax.device_put(task.init(jax.random.key(0), (1, *crop, 1)), replicated(mesh))

    @partial(jax.jit, donate_argnums=0)
    def step(state, vols, msks, key):
        x, y = segmentation_augment_3d(key, vols, msks, out_size=crop, train=True,
                                       dtype=jnp.bfloat16)
        return task.train_step(state, x, y)

    rng = np.random.default_rng(0)
    shape = (batch_size, *volume, 1)
    vols = shard_batch(mesh, rng.random(shape).astype(np.float32))
    msks = shard_batch(mesh, (rng.random(shape) < 0.2).astype(np.float32))
    return step, state, (vols, msks)


def predict_case(mesh, batch_size: int = BATCH["predict"], image_size: int = IMAGE_SIZE["predict"],
                 arch: str = "resnet18", fp32: bool = False):
    """The serving function that `train/predict.py` jits and `mis-export`
    serializes (`serve.make_predict_fn`: uint8 in → normalize → U-Net eval
    forward → sigmoid-threshold mask out), bf16 unless ``fp32``. Returns
    ``(predict, task, state, images)``; ``predict(images)`` gives the masks."""
    from medical_image_segmentation_tpu.parallel import replicated, shard_batch
    from medical_image_segmentation_tpu.serve import make_predict_fn
    from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask

    task = SegmentationTask(
        arch=arch, n_classes=1, in_channels=1, learning_rate=1.0,
        warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
        dtype=jnp.float32 if fp32 else jnp.bfloat16,
    )
    state = jax.device_put(task.init(jax.random.key(0), (2, image_size, image_size, 1)),
                           replicated(mesh))
    predict = jax.jit(make_predict_fn(
        task, {"params": state.params, "batch_stats": state.batch_stats},
        LIVER_MEAN, LIVER_STD, fp32=fp32))
    imgs = shard_batch(mesh, np.random.default_rng(0).integers(
        0, 256, size=(batch_size, image_size, image_size, 1)).astype(np.uint8))
    return predict, task, state, imgs


def predict3d_case(batch_windows: int = BATCH["predict3d"], volume=VOLUME, window=CROP3D,
                   features=FEATURES3D, fp32: bool = False, sw_loop: bool = False):
    """Whole-volume masks by overlapped sliding windows, the path
    `mis-predict3d` deploys: by default one jitted program per volume
    (`make_fused_predictor_3d`: extract + batched 3D U-Net forwards + Hann
    blend in a ``lax.scan``), with ``sw_loop`` the multi-program loop.
    Returns ``run``; ``run()`` gives the volume's logits."""
    from medical_image_segmentation_tpu.eval.sliding_window import (
        make_fused_predictor_3d,
        sliding_window_predict_3d,
    )
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

    window = tuple(window)
    task = Segmentation3DTask(features=tuple(features),
                              learning_rate=1.0, warmup_epochs=0, max_epochs=1,
                              steps_per_epoch=1, dtype=jnp.float32 if fp32 else jnp.bfloat16)
    state = task.init(jax.random.key(0), (1, *window, 1))
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats

    @jax.jit
    def window_fn(windows):
        return task.model.apply(variables, windows, train=False)

    vol = jnp.asarray(np.random.default_rng(0).random((*volume, 1)).astype(np.float32))
    if sw_loop:
        return lambda: sliding_window_predict_3d(window_fn, vol, window=window,
                                                 batch_windows=batch_windows)
    run_fused = make_fused_predictor_3d(window_fn, vol.shape, window=window,
                                        batch_windows=batch_windows)
    return lambda: run_fused(vol)


def _step_memory(jitted, *args):
    """The projected-memory report of one compiled step (core/hbm.py), or
    None where the backend gives no memory analysis."""
    from medical_image_segmentation_tpu.core.hbm import device_hbm_capacity, memory_analysis_of

    try:
        compiled = jitted.lower(*args).compile()
    except Exception:
        return None
    mem = memory_analysis_of(compiled)
    if mem is not None:
        cap = device_hbm_capacity()
        mem["capacity"] = cap
        mem["oversubscribed"] = bool(cap is not None and mem["projected_peak"] > cap)
    return mem


def _hbm_json_fields(mem) -> dict:
    """JSON-line fields for the projected-HBM report (None-safe)."""
    if not mem:
        return {}
    out = {"projected_hbm_gb": round(mem["projected_peak"] / 1024**3, 3)}
    if mem.get("capacity"):
        out["hbm_capacity_gb"] = round(mem["capacity"] / 1024**3, 3)
        out["hbm_oversubscribed"] = mem["oversubscribed"]
    return out


def _hbm_check_exit(step, args_tuple, task: str, extra: dict | None = None) -> int:
    """--hbm_check: AOT-compile the step, print the projected-memory
    diagnosis, emit one JSON line, and exit WITHOUT running it — tells in one
    compile whether the step fits the device."""
    from medical_image_segmentation_tpu.core.hbm import format_hbm_report

    mem = _step_memory(step, *args_tuple)
    if mem is None:
        print("hbm_check: backend exposes no memory analysis", file=sys.stderr)
        return 4
    print(format_hbm_report(mem, label=f"{task} step"), file=sys.stderr)
    if mem.get("oversubscribed"):
        print(f"WARNING: {task} step projected to exceed device memory — it "
              "would fail to allocate; lower --batch_size, use --remat, or "
              "shard wider", file=sys.stderr)
    out = {"metric": f"{task}_projected_hbm_gb",
           "value": round(mem["projected_peak"] / 1024**3, 3),
           "unit": "GiB", "vs_baseline": None, "task": task,
           "hbm_check": True, **_hbm_json_fields(mem)}
    if extra:
        out.update(extra)
    print(json.dumps(out))
    return 2 if mem.get("oversubscribed") else 0


def _dispersion_fields(probe_lat, loop_ms_mean: float, label: str) -> dict:
    """Contention tripwire: per-step latency percentiles from a short FENCED
    probe run after the throughput loop, compared against the loop's unfenced
    mean. A contended card (another process computing on it) shows up as
    p99/p50 dispersion inside the probe and/or a loop mean far above the
    probe's p50. Prints a LOUD warning so a dirty capture can't pass silently;
    the fields land in the JSON line either way."""
    lat = np.asarray(probe_lat, dtype=np.float64) * 1e3  # ms
    p50 = float(np.percentile(lat, 50))
    p99 = float(np.percentile(lat, 99))
    fields = {"step_ms_p50": round(p50, 2), "step_ms_p99": round(p99, 2),
              "step_ms_loop_mean": round(loop_ms_mean, 2)}
    contended = []
    if p50 > 0 and p99 / p50 > 1.4:
        contended.append(f"probe p99/p50 = {p99 / p50:.2f} (> 1.4)")
    # the fenced probe pays one host round-trip per step, so its p50 sits
    # slightly ABOVE the pipelined loop mean on a quiet chip; the loop mean
    # exceeding the fenced p50 by >20% means something else ran DURING the loop
    if p50 > 0 and loop_ms_mean > 1.2 * p50:
        contended.append(
            f"loop mean {loop_ms_mean:.1f} ms vs fenced p50 {p50:.1f} ms")
    if contended:
        fields["contention_suspected"] = True
        print(f"WARNING: {label} step-latency dispersion suggests a CONTENDED "
              f"card ({'; '.join(contended)}) — another process may be using "
              "it; this measurement is NOT a clean capture", file=sys.stderr)
    return fields


def _time_train(step, state, next_inputs, args, label: str, profile: str | None = None):
    """Warm up, time ``args.steps`` steps (traced to ``profile`` when given),
    then run the fenced latency probe. ``next_inputs()`` gives the step's
    inputs before its key. Returns ``(metrics, seconds, dispersion fields)``;
    ``metrics`` are the last timed step's."""
    from medical_image_segmentation_tpu.core.profiling import trace_if

    key = jax.random.key(1)
    for i in range(args.warmup):
        state, metrics = step(state, *next_inputs(), jax.random.fold_in(key, i))
    jax.block_until_ready(metrics)
    with trace_if(profile or "", enabled=bool(profile)):
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, metrics = step(state, *next_inputs(), jax.random.fold_in(key, 100 + i))
        jax.block_until_ready(metrics)
        dt = time.perf_counter() - t0
    timed = metrics
    probe_lat = []
    for i in range(min(args.steps, 12)):
        t0 = time.perf_counter()
        state, metrics = step(state, *next_inputs(), jax.random.fold_in(key, 500 + i))
        jax.block_until_ready(metrics)
        probe_lat.append(time.perf_counter() - t0)
    return timed, dt, _dispersion_fields(probe_lat, dt / args.steps * 1e3, label)


def _device_only(args, task: str) -> None:
    if args.store is not None or args.precrop:
        raise SystemExit(f"--task {task} benchmarks device-resident batches "
                         "(paired stores are exercised by the trainer tests)")


def _seg_bench(args, n_chips: int):
    """U-Net segmentation train-step throughput (``seg_case``)."""
    from medical_image_segmentation_tpu.parallel import make_mesh

    _device_only(args, "seg")
    step, state, inputs = seg_case(make_mesh(), args.batch_size, args.image_size,
                                   args.arch, args.remat)
    if args.hbm_check:
        return _hbm_check_exit(step, (state, *inputs, jax.random.key(1)), "seg",
                               {"batch_size": args.batch_size,
                                "image_size": args.image_size})
    metrics, dt, disp = _time_train(step, state, lambda: inputs, args, "seg")
    imgs_per_sec = args.batch_size * args.steps / dt
    per_chip = imgs_per_sec / n_chips
    mem = _step_memory(step, state, *inputs, jax.random.key(1))
    print(f"[seg] loss={float(metrics['train/loss']):.4f} total={imgs_per_sec:.0f} img/s "
          f"({dt/args.steps*1e3:.1f} ms/step)", file=sys.stderr)
    print(json.dumps({
        "metric": "seg_train_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(per_chip / 5000.0, 3),
        "task": "seg",
        "image_size": args.image_size,
        **disp,
        **_hbm_json_fields(mem),
    }))
    return 0


def _seg3d_bench(args, n_chips: int):
    """3D U-Net volumetric train-step throughput (``seg3d_case``). The
    reference has no 3D path; vs_baseline counts each volume as crop-depth
    equivalent 2D slices against the 5k img/s/chip north star."""
    from medical_image_segmentation_tpu.parallel import make_mesh

    _device_only(args, "seg3d")
    crop = tuple(args.crop3d)
    step, state, inputs = seg3d_case(make_mesh(), args.batch_size, tuple(args.volume_size), crop,
                                     tuple(args.features3d), args.remat)
    if args.hbm_check:
        return _hbm_check_exit(step, (state, *inputs, jax.random.key(1)), "seg3d",
                               {"batch_size": args.batch_size,
                                "features": list(args.features3d)})
    metrics, dt, disp = _time_train(step, state, lambda: inputs, args, "seg3d")
    vols_per_sec = args.batch_size * args.steps / dt
    per_chip = vols_per_sec / n_chips
    mem = _step_memory(step, state, *inputs, jax.random.key(1))
    print(f"[seg3d] loss={float(metrics['train/loss']):.4f} total={vols_per_sec:.1f} vol/s "
          f"({dt/args.steps*1e3:.1f} ms/step, crop {crop})", file=sys.stderr)
    print(json.dumps({
        "metric": "seg3d_train_volumes_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "volumes/sec/chip",
        "vs_baseline": round(per_chip * crop[0] / 5000.0, 3),
        "task": "seg3d", "features": list(args.features3d),
        **disp,
        **_hbm_json_fields(mem),
    }))
    return 0


def _latencies(run, args) -> np.ndarray:
    """Seconds of each of ``args.steps`` calls of ``run``, each fenced with
    ``block_until_ready`` (device compute, not the copy to the host), after a
    compiling call and ``args.warmup`` more."""
    fence = jax.block_until_ready
    fence(run())
    for _ in range(args.warmup):
        run()
    fence(run())
    lat = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        fence(run())
        lat.append(time.perf_counter() - t0)
    return np.array(lat)


def _predict_bench(args, n_chips: int):
    """Serving-path inference throughput (``predict_case``), batched.
    Reports img/s/chip plus per-batch latency percentiles — the
    deployment-relevant numbers the reference cannot produce (its only
    predict path is trainer.predict grid dumps, train_segmentation.py:82-93)."""
    from medical_image_segmentation_tpu.parallel import make_mesh

    _device_only(args, "predict")
    predict, task, state, imgs = predict_case(make_mesh(), args.batch_size, args.image_size,
                                              args.arch, args.fp32)
    if args.hbm_check:
        return _hbm_check_exit(predict, (imgs,), "predict",
                               {"batch_size": args.batch_size,
                                "image_size": args.image_size})
    lat = _latencies(lambda: predict(imgs), args)
    per_chip = args.batch_size * args.steps / float(lat.sum()) / n_chips
    out_extra = {}
    if args.exported:
        # Also time the AOT serving-artifact path (`mis-export` → `.misx`):
        # the same weights exported at this batch bucket, the bucket function
        # called directly (what `ServingPredictor.__call__` dispatches to;
        # its numpy copy to the host is excluded, as in the jit path above).
        # Exported artifacts are lowered
        # without shardings — single-chip by design (serve.py docstring).
        from medical_image_segmentation_tpu.serve import export_predictor

        ex_b = args.batch_size // n_chips if n_chips > 1 else args.batch_size
        exported = export_predictor(
            task, state, args.image_size, LIVER_MEAN, LIVER_STD,
            batch_sizes=(ex_b,), fp32=args.fp32)[ex_b]
        ex_imgs = jnp.asarray(np.random.default_rng(1).integers(
            0, 256, size=(ex_b, args.image_size, args.image_size, 1)).astype(np.uint8))
        ex_lat = _latencies(lambda: exported.call(ex_imgs), args)
        out_extra = {
            "exported_images_per_sec_per_chip": round(ex_b * args.steps / float(ex_lat.sum()), 1),
            "exported_batch": ex_b,
            "exported_latency_ms_p50": round(float(np.percentile(ex_lat, 50)) * 1e3, 2),
            "exported_latency_ms_p99": round(float(np.percentile(ex_lat, 99)) * 1e3, 2),
        }
        print(f"[predict --exported] {out_extra['exported_images_per_sec_per_chip']:.0f} img/s "
              f"(batch {ex_b}, p50 {out_extra['exported_latency_ms_p50']:.1f} ms, "
              f"p99 {out_extra['exported_latency_ms_p99']:.1f} ms)", file=sys.stderr)
    print(f"[predict] total={per_chip*n_chips:.0f} img/s "
          f"(batch {args.batch_size} @ {args.image_size}², "
          f"p50 {np.percentile(lat,50)*1e3:.1f} ms, p99 {np.percentile(lat,99)*1e3:.1f} ms)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "predict_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(per_chip / 5000.0, 3),
        "task": "predict",
        "image_size": args.image_size, "fp32": args.fp32,
        "batch_latency_ms_p50": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "batch_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3, 2),
        **out_extra,
    }))
    return 0


def _predict3d_bench(args):
    """Volumetric serving-path throughput (``predict3d_case``): END-TO-END
    per-volume latency of window extraction + batched 3D U-Net forwards +
    Hann scatter-blend, all on device; reports vol/s and p50/p99 per-volume
    latency. The reference has no 3D path at all."""
    _device_only(args, "predict3d")
    if args.hbm_check:
        raise SystemExit("--hbm_check is for train steps (seg/seg3d) and "
                         "predict; sliding-window inference is many small "
                         "programs, not one")
    vol = tuple(args.volume_size)
    window = tuple(args.crop3d)
    run = predict3d_case(args.batch_size, vol, window, tuple(args.features3d),
                         args.fp32, args.sw_loop)
    lat = _latencies(run, args)
    vols_per_sec = args.steps / float(lat.sum())
    # windows per volume (right-aligned half-overlap tiling)
    n_win = 1
    for full, w in zip(vol, window):
        s = max(1, w // 2)
        n_win *= 1 if full <= w else len(range(0, full - w + 1, s)) + (
            0 if (full - w) % s == 0 else 1)
    print(f"[predict3d] {vols_per_sec:.2f} vol/s (volume {vol}, window {window}, "
          f"{n_win} windows/{math.ceil(n_win / args.batch_size)} batches, "
          f"p50 {np.percentile(lat,50)*1e3:.0f} ms, p99 {np.percentile(lat,99)*1e3:.0f} ms)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "predict3d_volumes_per_sec_per_chip",
        "value": round(vols_per_sec, 2),
        "unit": "volumes/sec/chip",
        "vs_baseline": round(vols_per_sec * vol[0] / 5000.0, 4),
        "task": "predict3d",
        "sw_mode": "loop" if args.sw_loop else "fused",
        "volume": list(vol), "window": list(window),
        "windows_per_volume": n_win,
        "volume_latency_ms_p50": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "volume_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3, 2),
    }))
    return 0


def _make_auto_store(path: str, n: int, size: int, codec_name: str) -> None:
    from medical_image_segmentation_tpu.data.store import CODEC_JPEG, CODEC_RAW, StoreWriter

    codec = CODEC_JPEG if codec_name == "jpeg" else CODEC_RAW
    rng = np.random.default_rng(0)
    with StoreWriter(path, channels=1) as w:
        for _ in range(n):
            w.add(rng.integers(0, 256, size=(size, size, 1)).astype(np.uint8), codec=codec)


def _byol_bench(args, n_chips: int):
    """The flagship (``byol_case``), from a device-resident batch or a store."""
    from medical_image_segmentation_tpu.parallel import make_mesh

    if args.hbm_check:
        raise SystemExit("--hbm_check supports tasks seg/seg3d/predict")
    if args.precrop and args.store is None:
        raise SystemExit("--precrop requires --store")
    print(f"devices: {jax.devices()}", file=sys.stderr)
    mesh = make_mesh()
    step, state, probe, _ = byol_case(mesh, args.batch_size, args.image_size, args.crop_size,
                                      args.arch, args.remat, args.precrop)

    mode = "device" if args.store is None else "store"
    loader = None
    tmpdir = None
    if mode == "store":
        import tempfile

        store_path = args.store
        if store_path == "auto":
            tmpdir = tempfile.mkdtemp()
            store_path = os.path.join(tmpdir, "bench.mis")
            _make_auto_store(store_path, args.store_images, args.image_size, args.store_codec)
            print(f"synthetic {args.store_codec} store: "
                  f"{os.path.getsize(store_path)/1e6:.1f} MB, {args.store_images} images",
                  file=sys.stderr)
        from medical_image_segmentation_tpu.data.loader import (
            RANDOM, Loader, device_put_sharded_batches,
        )

        loader = Loader(
            store_path, args.batch_size, order=RANDOM,
            num_threads=args.num_threads or (os.cpu_count() or 4),
            out_hw=(args.image_size, args.image_size),
            precrop={"out_hw": (args.crop_size, args.crop_size)} if args.precrop else None,
        )
        if loader.channels != 1:
            raise SystemExit("bench expects a grayscale (1-channel) store")

        def batches():
            while True:  # loop epochs; each gets a fresh permutation
                yield from device_put_sharded_batches(loader, mesh)

        feed = batches()

        def next_inputs():
            imgs, _ = next(feed)
            return (imgs,)
    else:
        def next_inputs():
            return (probe,)

    metrics, dt, disp = _time_train(step, state, next_inputs, args, "byol", args.profile)
    imgs_per_sec = args.batch_size * args.steps / dt
    per_chip = imgs_per_sec / n_chips
    print(f"[{mode}] loss={float(metrics['loss']):.4f} total={imgs_per_sec:.0f} img/s "
          f"({dt/args.steps*1e3:.1f} ms/step)", file=sys.stderr)
    out = {
        "metric": "aug_train_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(per_chip / 5000.0, 3),
        "mode": mode,
        **disp,
    }
    if mode == "store":
        # bytes the loader actually ships per image: 2 crop² views in
        # precrop mode (windowed decode reads even less), full frames else
        shipped = (2 * args.crop_size * args.crop_size if args.precrop
                   else args.image_size * args.image_size)
        out["loader_gbytes_per_sec"] = round(imgs_per_sec * shipped / 1e9, 3)
        # machine-checkable bottleneck attribution: the per-stage split must
        # be in the JSON line, not just stderr
        out["num_decode_threads"] = args.num_threads or (os.cpu_count() or 4)
        out["precrop"] = args.precrop
        out["h2d_bytes_per_batch"] = (
            2 * args.batch_size * args.crop_size * args.crop_size
            if args.precrop
            else args.batch_size * args.image_size * args.image_size)
        if loader.timers is not None:
            for stage, (tot, n) in loader.timers.snapshot().items():
                out[f"{stage}_ms_per_batch"] = round(tot / max(n, 1) * 1e3, 2)
                out[f"{stage}_batches_timed"] = n
            print(loader.timers.report(), file=sys.stderr)
    print(json.dumps(out))
    if loader is not None:
        loader.close()
    if tmpdir is not None:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_size", type=int, default=None,
                    help="default: 1024 (byol), 128 (seg), 4 (seg3d), "
                         "256 (predict), 8 windows (predict3d)")
    ap.add_argument("--image_size", type=int, default=None,
                    help="default: 256 stored (byol), 224 (seg/predict — the "
                         "reference's canonical seg resolution, "
                         "train_segmentation.py:35)")
    ap.add_argument("--crop_size", type=int, default=CROP)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--fp32", action="store_true",
                    help="predict: f32 activations instead of bf16")
    ap.add_argument("--store", default=None,
                    help="feed from a real MIS store through the C++ loader "
                         "('auto' synthesizes one); default: device-resident batch")
    ap.add_argument("--store_codec", default="jpeg", choices=["jpeg", "raw"],
                    help="codec for --store auto")
    ap.add_argument("--store_images", type=int, default=4096, help="size of --store auto")
    ap.add_argument("--num_threads", type=int, default=0,
                    help="loader decode threads (0 = host cpu count)")
    ap.add_argument("--precrop", action="store_true",
                    help="with --store: host-side RandomResizedCrop in the C++ "
                         "workers (ships 2x crop^2 views instead of full images "
                         "— ~2.6x fewer H2D bytes at 256->112; the elementwise "
                         "augment tail still runs on device)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint residual blocks (fit bigger archs/batches)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the timed steps to DIR")
    ap.add_argument("--task", default="byol",
                    choices=["byol", "seg", "seg3d", "predict", "predict3d"],
                    help="seg: U-Net(arch) segmentation train step with "
                         "device-side paired augmentation (canonical config "
                         "= the defaults: batch 128 @ 224²); "
                         "seg3d: volumetric 3D U-Net train step (--volume_size/"
                         "--crop3d, e.g. --task seg3d --batch_size 4); "
                         "predict: serving-path U-Net inference (img/s/chip + "
                         "per-batch latency percentiles; --exported also times "
                         "the .misx artifact path); "
                         "predict3d: whole-volume sliding-window serving "
                         "(vol/s + per-volume latency); "
                         "device-resident batches only")
    ap.add_argument("--sw_loop", action="store_true",
                    help="predict3d: use the multi-program loop variant of "
                         "sliding-window inference instead of the fused "
                         "one-dispatch program (A/B lever for the serving row)")
    ap.add_argument("--exported", action="store_true",
                    help="predict: additionally export a .misx-equivalent "
                         "artifact (jax.export) and time its bucket function")
    ap.add_argument("--hbm_check", action="store_true",
                    help="seg/seg3d/predict: AOT-compile the step, print "
                         "projected peak device memory vs capacity, and exit "
                         "WITHOUT running (exit 2 if it does not fit)")
    ap.add_argument("--volume_size", type=int, nargs=3, default=VOLUME,
                    metavar=("D", "H", "W"), help="seg3d: stored volume shape")
    ap.add_argument("--crop3d", type=int, nargs=3, default=CROP3D,
                    metavar=("D", "H", "W"), help="seg3d: random train crop")
    ap.add_argument("--features3d", type=int, nargs="+", default=FEATURES3D,
                    help="seg3d: UNet3D stage widths (matches "
                         "train_segmentation3d --features)")
    args = ap.parse_args()
    if args.batch_size is None:
        args.batch_size = BATCH[args.task]
    if args.image_size is None:
        args.image_size = IMAGE_SIZE[args.task]
    if args.warmup < 1 or args.steps < 1:
        raise SystemExit("--warmup and --steps must be >= 1")

    from medical_image_segmentation_tpu.core.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    n_chips = len(require_gpu())
    if args.task != "predict3d" and args.batch_size % n_chips:
        raise SystemExit(f"--batch_size {args.batch_size} must divide {n_chips} devices")
    if args.task == "seg":
        return _seg_bench(args, n_chips)
    if args.task == "seg3d":
        return _seg3d_bench(args, n_chips)
    if args.task == "predict":
        return _predict_bench(args, n_chips)
    if args.task == "predict3d":
        return _predict3d_bench(args)
    return _byol_bench(args, n_chips)


if __name__ == "__main__":
    sys.exit(main())
