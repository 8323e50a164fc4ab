"""Smoke run of the system's main paths on NVIDIA GPUs, in one process.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: sharded-step parity only

One card, in order:

1. device: JAX must run on a GPU (there is no CPU path); prints the device
   and the card's name and power limit from ``nvidia-smi``;
2. augmentation: ``ops.augment.two_view_augment`` on the GPU against the
   same call on the CPU under ``jax.default_matmul_precision("highest")``,
   for a uint8 batch and a windowed uint16 batch at the flagship's widths
   (1024 images of 256², two 112² views); then the augmentation alone and
   ``bench.py``'s flagship BYOL step, each timed behind ``block_until_ready``;
3. trainer: ``train.train_ssl.main`` trains BYOL ResNet-18 at batch 1024
   from a seeded raw-codec store through the C++ loader, checkpoints each
   epoch, then resumes from its checkpoint and trains on;
4. the other timed paths of ``bench.py``, built by its own functions at its
   default sizes: U-Net training, UNet3D training, batched 2D predict and the
   fused 3D sliding window;
5. the test suite's ``gpu``-marked tests (``tests/test_gpu.py``), which
   skip where there is no card.

Any failed phase exits non-zero. When all pass, the last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Times printed here are smoke numbers (compile counted apart as set-up),
not benchmarks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# the flagship's widths (bench.py's defaults): BYOL ResNet-18 at batch 1024
# on 256² stored images, two 112² views, heads 4096/256
BATCH = 1024
RAW_HW = 256
TIMED_STEPS = 20
# The reference rounded every view to uint8, so half a grey level on the
# 0-255 scale is within what it does itself. uint16 views are held to the
# same share of full scale (0.5 * 257 levels of 65535).
TOL_GREY = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the phase (an exception, so the script exits non-zero)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi`` runs in a child)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def contract_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}})


def view_error(out: np.ndarray, ref: np.ndarray, cfg, mean, std) -> float:
    """Largest |out - ref| in the store's grey levels. Solarize is the one
    step whose output jumps with its input: where the reference lies within
    one grey level of the threshold, the reflected value also matches."""
    g = out.astype(np.float64) * std[0] + mean[0]
    r = ref.astype(np.float64) * std[0] + mean[0]
    err = np.abs(g - r)
    if cfg.solarize_prob > 0:
        step, vmax, thr = cfg.value_max / 255.0, cfg.value_max, cfg.solarize_threshold
        near = (np.abs(r - thr) <= step) | (np.abs(vmax - r - thr) <= step)
        err = np.where(near, np.minimum(err, np.abs(vmax - g - r)), err)
    return float(err.max())


def fenced_ms(run, n: int) -> float:
    """Mean ms per call of ``run(i)`` over ``n`` calls after one warm-up
    (``run(n)``), fenced with ``block_until_ready``."""
    import jax

    jax.block_until_ready(run(n))
    t0 = time.perf_counter()
    out = None
    for i in range(n):
        out = run(i)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def phase_augment(gpu, card: str) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from medical_image_segmentation_tpu.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu.ops.augment import two_view_augment
    from medical_image_segmentation_tpu.parallel import make_mesh

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(SEED)
    key = jax.random.key(SEED)
    out = {}
    for name, dm_name, dtype, window_prob in (("u8", "RADIOLOGY_1M", np.uint8, 0.0),
                                              ("u16", "RADIOLOGY_1M_U16", np.uint16, 0.5)):
        dm = get_datamodule(dm_name)(window_prob=window_prob)
        cfgs = dm.view_configs()
        mean, std = tuple(dm.train_mean), tuple(dm.train_std)
        raw = rng.integers(0, int(dm.value_max) + 1, size=(BATCH, RAW_HW, RAW_HW, 1), dtype=dtype)

        def views(device, precision):
            ctx = jax.default_matmul_precision(precision) if precision else contextlib.nullcontext()
            with ctx:
                v = two_view_augment(jax.device_put(key, device), jax.device_put(raw, device),
                                     *cfgs, mean=mean, std=std, dtype=jnp.float32)
                return [np.asarray(x) for x in v]

        ref = views(cpu, "highest")
        errs = {}
        for label, precision in (("default", None), ("highest", "highest")):
            got = views(gpu, precision)
            check(all(np.isfinite(x).all() and x.shape == (BATCH, dm.crop_size, dm.crop_size, 1)
                      for x in got), f"augment {name}: non-finite views or wrong shape")
            errs[label] = max(view_error(g, r, c, mean, std) for g, r, c in zip(got, ref, cfgs))
            errs[label] *= 255.0 / dm.value_max  # grey levels on the 0-255 scale
        log(f"augment {name}: max |GPU - CPU highest| = {errs['default']!r} grey levels "
            f"(default precision), {errs['highest']!r} (highest); tolerance {TOL_GREY}")
        for label, e in errs.items():
            check(e < TOL_GREY, f"augment {name} ({label} precision): error {e} >= {TOL_GREY}")
        out[name] = errs

    # the augmentation's share of bench.py's flagship step, both in bf16 as trained
    step, state, raw, augment = bench.byol_case(make_mesh([gpu]), BATCH, RAW_HW)
    aug_ms = fenced_ms(lambda i: augment(jax.random.fold_in(key, i), raw), TIMED_STEPS)
    box = [state]

    def run(i):
        box[0], metrics = step(box[0], raw, jax.random.fold_in(key, 1000 + i))
        return metrics["loss"]

    t0 = time.perf_counter()
    jax.block_until_ready(run(500))
    compile_s = time.perf_counter() - t0
    step_ms = fenced_ms(run, TIMED_STEPS)
    loss = float(run(99))
    check(math.isfinite(loss), f"flagship step loss {loss}")
    share = aug_ms / step_ms
    log(f"flagship step (bench.byol_case: BYOL resnet18, batch {BATCH}, {RAW_HW}²→2×112², bf16): "
        f"{step_ms!r} ms/step, "
        f"augmentation alone {aug_ms!r} ms = {share:.2%} of the step; "
        f"first call {compile_s:.1f} s; on {card}")
    out.update(aug_ms=aug_ms, step_ms=step_ms, aug_share=share, step_compile_s=compile_s)
    return out


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _run_cli(main, argv) -> str:
    """Run a CLI ``main`` in-process; return what it wrote to stderr."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {' '.join(argv)} returned {rc}")
    return buf.getvalue()


def phase_trainer(workdir: str, card: str) -> dict:
    from medical_image_segmentation_tpu.core.checkpoint import latest_step, restore_checkpoint
    from medical_image_segmentation_tpu.data.store import CODEC_RAW, StoreWriter
    from medical_image_segmentation_tpu.data.store.native import get_lib
    from medical_image_segmentation_tpu.train import train_ssl

    if get_lib() is None:  # the trainer would fall back to the Python reader
        raise RuntimeError("the C++ store loader did not build")
    store = os.path.join(workdir, "radiology_train.mis")
    rng = np.random.default_rng(SEED)
    with StoreWriter(store, channels=1) as w:  # two steps per epoch
        for _ in range(2 * BATCH):
            w.add(rng.integers(0, 256, size=(RAW_HW, RAW_HW, 1), dtype=np.uint8),
                  codec=CODEC_RAW)
    os.environ["RADIOLOGY_1M_TRAIN_STORE"] = store
    ckpt = os.path.join(workdir, "ckpt")
    base = ["--dataset", "RADIOLOGY_1M", "--arch", "resnet18", "--batch_size", str(BATCH),
            "--val_every_epochs", "0", "--checkpoint_dir", ckpt,
            "--log_dir", os.path.join(workdir, "logs"), "--seed", str(SEED)]
    epoch_re = re.compile(r"epoch (\d+): loss=(\S+) (\d+) img/s")

    t0 = time.perf_counter()
    err = _run_cli(train_ssl.main, base + ["--max_epochs", "2"])
    first_s = time.perf_counter() - t0
    epochs = epoch_re.findall(err)
    check([int(e) for e, _, _ in epochs] == [0, 1], f"epochs logged: {epochs}")
    check(latest_step(ckpt) == 4, f"checkpoint steps: {os.listdir(ckpt)}")

    t0 = time.perf_counter()
    err = _run_cli(train_ssl.main, base + ["--max_epochs", "3", "--resume"])
    resume_s = time.perf_counter() - t0
    check("resumed from step 4 (epoch 2)" in err, "the resumed run did not restore step 4")
    resumed = epoch_re.findall(err)
    check([int(e) for e, _, _ in resumed] == [2], f"resumed epochs logged: {resumed}")
    check(latest_step(ckpt) == 6, f"checkpoint steps after resume: {os.listdir(ckpt)}")
    check(int(restore_checkpoint(os.path.join(ckpt, "6"))["step"]) == 6, "checkpoint 6 holds step 6")

    losses = [float(v) for _, v, _ in epochs + resumed]
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    ms = BATCH / float(epochs[-1][2]) * 1e3
    log(f"trainer: BYOL resnet18 batch {BATCH} through train_ssl.main, losses {losses}, "
        f"checkpoint at steps 2/4, resumed 4→6; epoch-1 {ms:.1f} ms/step incl. loader "
        f"(smoke number, not a benchmark) on {card}; runs took {first_s:.1f} s and "
        f"{resume_s:.1f} s")
    return {"losses": losses, "ms_per_step": ms, "first_run_s": first_s, "resume_run_s": resume_s}


def _steps(step, n: int = 3):
    """First call (compile) seconds and the outputs of ``n`` calls."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(step(0))
    first = time.perf_counter() - t0
    for i in range(1, n):
        out = step(i)
    return first, jax.block_until_ready(out)


def phase_paths() -> dict:
    """bench.py's other timed paths at its default sizes, through its builders."""
    import jax

    import bench
    from medical_image_segmentation_tpu.parallel import make_mesh

    mesh = make_mesh()
    key = jax.random.key(SEED)
    out = {}
    for name, case in (("seg", bench.seg_case), ("seg3d", bench.seg3d_case)):
        step, state, inputs = case(mesh)
        box = [state]

        def train(i):
            box[0], m = step(box[0], *inputs, jax.random.fold_in(key, i))
            return m["train/loss"]

        first, loss = _steps(train)
        check(math.isfinite(float(loss)), f"{name} loss {loss}")
        out[name] = {"compile_s": first, "loss": float(loss)}

    predict, _, _, imgs = bench.predict_case(mesh)
    first, masks = _steps(lambda i: predict(imgs))
    masks = np.asarray(masks)
    check(masks.shape == imgs.shape and set(np.unique(masks)) <= {0, 1}, f"predict masks {masks.shape}")
    out["predict"] = {"compile_s": first}

    run3d = bench.predict3d_case()
    first, logits = _steps(lambda i: run3d())
    logits = np.asarray(logits)
    check(logits.shape[:3] == bench.VOLUME and np.isfinite(logits).all(),
          f"predict3d logits {logits.shape}")
    out["predict3d"] = {"compile_s": first}
    log("paths: " + ", ".join(
        f"{k} first call {v['compile_s']:.1f} s" + (f" loss {v['loss']!r}" if "loss" in v else "")
        for k, v in out.items()) + " — all finite")
    return out


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_card_tests() -> dict:
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    os.environ["MIS_TEST_ON_GPU"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_gpu.py")], plugins=[outcomes])
    log(f"card tests: {outcomes.counts}")
    if rc != 0 or set(outcomes.counts) != {"passed"}:
        raise RuntimeError(f"gpu-marked tests: exit {rc}, outcomes {outcomes.counts}")
    return outcomes.counts


def _flat_params(state) -> np.ndarray:
    import jax

    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(state.params)])


def _one_step(train_step, state, *inputs, loss_key: str = "train/loss"):
    """Loss and parameter change (flattened, float64) of one training step."""
    p0 = _flat_params(state)  # read first: the step donates ``state``
    state, m = train_step(state, *inputs)
    return float(m[loss_key]), _flat_params(state) - p0


# Parity tolerances, relative, in f32 under "highest". The loss is the
# forward pass (sync BatchNorm statistics included); the parameter change of
# the one step, compared as a vector, is where a missing or partial gradient
# all-reduce shows. LARS scales each layer's update to a fixed share of its
# weights, so the change's norm alone would not see one. The first step from
# a random init magnifies rounding: on four CPU devices at reduced widths the
# change differs by up to 9e-3 between layouts (7e-3 merely from reordering
# the batch on one device), while gradients taken from a quarter of the batch
# (one replica's, as with no all-reduce) move it by 0.77 to 0.97.
LOSS_RTOL = 2e-4
DELTA_RTOL = 0.1


def sharded_parity(devices) -> list:
    """One training step of each sharded layout against the same seeded step
    on one device, at the flagship and seg3d widths, with the learning rate
    above 0 at step 0. Returns ``(tag, loss_sharded, loss_one,
    change_sharded, change_one)`` rows.

    The mesh follows the algorithm alone (the cards are joined all to all):
    ``data`` over all devices, or ``data`` × ``space`` / ``model`` of 2 × 2."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from medical_image_segmentation_tpu.ops.augment import BYOL_VIEW1, BYOL_VIEW2, two_view_augment
    from medical_image_segmentation_tpu.parallel import byol_tp_shardings, data_sharding, make_mesh, shard_batch
    from medical_image_segmentation_tpu.parallel.mesh import spatial_sharding
    from medical_image_segmentation_tpu.train import BYOLTask, SegmentationTask
    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask

    n = len(devices)
    check(n == 4, f"the parity cases are laid out for 4 devices, got {n}")
    one = make_mesh(devices[:1])
    rng = np.random.default_rng(SEED)
    view_hw, seg_hw, hidden = bench.CROP, RAW_HW, 4096
    rows = []

    def replicate(state, mesh):
        return jax.device_put(state, NamedSharding(mesh, P()))

    with jax.default_matmul_precision("highest"):
        task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=hidden, proj_dim=256,
                        num_classes=10, total_steps=100, warmup_epochs=0, dtype=jnp.float32)
        raw = rng.integers(0, 256, size=(BATCH, RAW_HW, RAW_HW, 1), dtype=np.uint8)
        labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
        cfgs = [dataclasses.replace(c, out_size=(view_hw, view_hw)) for c in (BYOL_VIEW1, BYOL_VIEW2)]

        def dp(mesh):
            state = replicate(task.init(jax.random.key(0), (2, view_hw, view_hw, 1)), mesh)
            v1, v2 = two_view_augment(jax.random.key(1), shard_batch(mesh, raw), *cfgs,
                                      dtype=jnp.float32)
            return _one_step(task.train_step, state, v1, v2, shard_batch(mesh, labels), loss_key="loss")

        rows.append((f"dp({n}) BYOL resnet18 batch {BATCH}", *_pair(dp(make_mesh(devices)), dp(one))))

        seg = SegmentationTask(arch="resnet18", warmup_epochs=0, dtype=jnp.float32)
        s_imgs = rng.normal(size=(4, seg_hw, seg_hw, 1)).astype(np.float32)
        s_msks = (rng.random((4, seg_hw, seg_hw, 1)) > 0.5).astype(np.float32)

        def sp(mesh, sharded):
            state = replicate(seg.init(jax.random.key(2), (2, seg_hw, seg_hw, 1)), mesh)
            put = (lambda a: jax.device_put(a, spatial_sharding(mesh))) if sharded else jnp.asarray
            return _one_step(seg.train_step, state, put(s_imgs), put(s_msks))

        ds = make_mesh(devices, axis_names=("data", "space"), axis_sizes=(2, 2))
        rows.append((f"dp+space(2x2) U-Net {seg_hw}²", *_pair(sp(ds, True), sp(one, False))))

        seg3 = Segmentation3DTask(features=bench.FEATURES3D, warmup_epochs=0, dtype=jnp.float32)
        v_imgs = rng.normal(size=(4, *bench.CROP3D, 1)).astype(np.float32)
        v_msks = (rng.random((4, *bench.CROP3D, 1)) > 0.7).astype(np.float32)

        def sp3(mesh, sharded):
            state = replicate(seg3.init(jax.random.key(4), (2, *bench.CROP3D, 1)), mesh)
            put = (lambda a: jax.device_put(a, spatial_sharding(mesh, ndim=5))) if sharded else jnp.asarray
            return _one_step(seg3.train_step, state, put(v_imgs), put(v_msks))

        rows.append((f"dp+space3d(2x2) UNet3D {bench.FEATURES3D} crop {bench.CROP3D}",
                     *_pair(sp3(ds, True), sp3(one, False))))

        t_v1 = rng.normal(size=(16, view_hw, view_hw, 1)).astype(np.float32)
        t_v2 = rng.normal(size=(16, view_hw, view_hw, 1)).astype(np.float32)

        def tp(mesh, sharded):
            state = task.init(jax.random.key(3), (2, view_hw, view_hw, 1))
            if sharded:
                state = jax.device_put(state, byol_tp_shardings(mesh, state, hidden_dim=hidden))
                a, b = (jax.device_put(jnp.asarray(v), data_sharding(mesh, 4)) for v in (t_v1, t_v2))
            else:
                state, a, b = replicate(state, mesh), jnp.asarray(t_v1), jnp.asarray(t_v2)
            return _one_step(task.train_step, state, a, b, loss_key="loss")

        dm = make_mesh(devices, axis_names=("data", "model"), axis_sizes=(2, 2))
        rows.append((f"dp+tp(2x2) BYOL heads {hidden}", *_pair(tp(dm, True), tp(one, False))))
    return rows


def _pair(sharded, single):
    return sharded[0], single[0], sharded[1], single[1]


def check_parity(rows) -> list:
    """Print each row; return the tags that miss a tolerance or whose step
    left the parameters where they were."""
    failed = []
    for tag, loss_n, loss_1, change_n, change_1 in rows:
        dl = abs(loss_n - loss_1) / max(abs(loss_1), 1e-12)
        size = float(np.linalg.norm(change_1))
        dc = float(np.linalg.norm(change_n - change_1)) / max(size, 1e-30)
        ok = math.isfinite(loss_n) and size > 0 and dl <= LOSS_RTOL and dc <= DELTA_RTOL
        log(f"parity {tag}: loss {loss_n!r} vs {loss_1!r} (Δrel {dl:.2e}, tolerance {LOSS_RTOL:g}); "
            f"parameter change |Δp| {float(np.linalg.norm(change_n))!r} vs {size!r}, "
            f"|Δp_sharded - Δp_one| / |Δp_one| = {dc:.2e} (tolerance {DELTA_RTOL:g}) — "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(tag)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded-step parity cases, on four cards")
    args = ap.parse_args(argv)
    if args.four:
        # parity needs no fastest algorithm: without autotuning the eight
        # programs compile in a fraction of the time (set before JAX starts)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()

    from medical_image_segmentation_tpu.core.runtime import device_record, enable_compile_cache, require_gpu

    cache = enable_compile_cache()
    devices = require_gpu()
    device = device_record()
    card = card_line()
    log(f"device: {device['platform']} {device['kind']} x{device['count']}; "
        f"nvidia-smi: {card}; compile cache {cache}")
    t_all = time.perf_counter()

    if args.four:
        if len(devices) != 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        failed = check_parity(sharded_parity(devices))
        if failed:
            raise SystemExit(f"parity failed: {failed}")
    else:
        times = {}
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            for name, run in (("augment", lambda: phase_augment(devices[0], card)),
                              ("trainer", lambda: phase_trainer(workdir, card)),
                              ("paths", phase_paths),
                              ("card tests", phase_card_tests)):
                t0 = time.perf_counter()
                run()
                times[name] = time.perf_counter() - t0
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log("phase seconds (compile included): "
            + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(contract_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
