"""AOT-exported serving artifacts (``.misx``).

``mis-export`` (train/export.py) serializes the EXACT inference function
``mis-predict`` deploys — uint8 batch → normalize → U-Net eval forward →
sigmoid-threshold mask — with the trained weights baked in as constants, via
``jax.export``. The artifact is a single self-contained file: serving hosts
deserialize and call it with NO model code, NO checkpoint restore, and NO
tracing/compile-from-Python step (XLA consumes the embedded StableHLO
directly). This is the deployment story the reference lacks entirely: its
only inference path is ``trainer.predict`` grid dumps inside the training
script (reference ``train_segmentation.py:82-93``).

Design notes:
- **Static batch buckets.** One exported function per batch size keeps every
  serving shape static (one compiled program each); the predictor routes a request to the
  smallest bucket that fits and pads the tail (padding rows repeat the last
  sample and are trimmed before returning).
- **Multi-platform lowering.** ``platforms=("cuda", "cpu")`` bakes both
  lowerings into one artifact, so the same file serves on a GPU host and in
  a CPU canary/CI environment. The meta records the platforms the artifact
  itself reports, and loading refuses one that cannot run here.
- **Size scales with buckets.** jax.export has no cross-function constant
  sharing, so every batch bucket embeds its own copy of the weights —
  artifact size ≈ n_buckets × params (float32: params keep
  ``param_dtype=float32`` regardless of the compute dtype). Pick the few
  bucket sizes the serving tier actually uses.
- **Single-device serving.** An artifact is lowered without shardings, so
  ``Exported.call`` runs each bucket on one card — the right unit for a
  serving tier that scales by replication. The checkpoint-backed
  ``mis-predict`` path instead shards each batch over all local cards; on a
  multi-card host it can be up to card-count× faster per process.

Container layout: ``MISX1\\n`` magic, a u32 little-endian JSON-header
length, the JSON header ``{"meta": ..., "buckets": {"<B>": [offset, size]}}``
(offsets relative to the end of the header), then the concatenated
``jax.export`` blobs.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

_MAGIC = b"MISX1\n"


def make_predict_fn(task, variables, mean, std, threshold=0.5,
                    fp32=False, hu_windows=()):
    """THE deployed 2D serving function — uint8 batch → normalize (+optional
    multi-window channels) → U-Net eval forward → sigmoid-threshold uint8
    masks. Single source of truth: `mis-predict` jits it, `mis-export`
    serializes it, `bench.py --task predict` times it."""
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.ops.augment import apply_hu_windows
    from medical_image_segmentation_tpu.ops.dice import post_process_masks

    dtype = jnp.float32 if fp32 else jnp.bfloat16
    hu_windows = tuple(tuple(w) for w in hu_windows)

    def fn(imgs_u8):
        x = imgs_u8.astype(jnp.float32) / np.float32(255.0)
        x = apply_hu_windows(x, hu_windows)  # no-op when () — 1 channel
        x = ((x - np.float32(mean)) / np.float32(std)).astype(dtype)
        logits = task.model.apply(variables, x, train=False)
        return post_process_masks(logits, threshold=threshold).astype(jnp.uint8)

    return fn


def export_predictor(
    task,
    state,
    image_size: int,
    mean: float,
    std: float,
    threshold: float = 0.5,
    batch_sizes: Sequence[int] = (1, 8, 64),
    platforms: Optional[Sequence[str]] = None,
    fp32: bool = False,
    hu_windows: Sequence = (),
):
    """Export the serving function at each batch bucket → {B: Exported}.

    ``task`` is a SegmentationTask, ``state`` its (restored) TrainState; the
    weights are embedded in the artifact as constants.
    """
    import jax
    import jax.numpy as jnp

    variables = {
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats),
    }
    fn = make_predict_fn(task, variables, mean, std, threshold=threshold,
                         fp32=fp32, hu_windows=hu_windows)

    out = {}
    for b in sorted(set(int(b) for b in batch_sizes)):
        if b < 1:
            raise ValueError(f"batch bucket must be >= 1, got {b}")
        spec = jax.ShapeDtypeStruct((b, image_size, image_size, 1), jnp.uint8)
        out[b] = jax.export.export(
            jax.jit(fn), platforms=list(platforms) if platforms else None)(spec)
    return out


def export_window_predictor(
    task,
    state,
    window: Sequence[int],
    mean: float,
    std: float,
    batch_windows: int = 4,
    platforms: Optional[Sequence[str]] = None,
    fp32: bool = False,
    hu_windows: Sequence = (),
):
    """Volumetric analogue of :func:`export_predictor`: export the 3D U-Net
    WINDOW function for ``eval.sliding_window.sliding_window_predict_3d`` —
    raw 0..1 windows (B, d, h, w, 1) float32 in, logits (B, d, h, w, K)
    float32 out, with hu-window stacking + normalization + weights baked in.
    The host keeps only window extraction and the Hann blend (bandwidth-
    trivial); every FLOP crosses through the artifact. → {B: Exported}.
    """
    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

    dtype = jnp.float32 if fp32 else jnp.bfloat16
    hu_windows = tuple(tuple(w) for w in hu_windows)
    variables = {"params": jax.device_get(state.params)}
    bs = jax.device_get(state.batch_stats)
    if bs:
        variables["batch_stats"] = bs

    def fn(windows01):
        x = apply_hu_windows(windows01, hu_windows)  # no-op when ()
        x = ((x - np.float32(mean)) / np.float32(std)).astype(dtype)
        return task.model.apply(variables, x, train=False).astype(jnp.float32)

    d, h, w = (int(v) for v in window)
    spec = jax.ShapeDtypeStruct((int(batch_windows), d, h, w, 1), jnp.float32)
    exported = jax.export.export(
        jax.jit(fn), platforms=list(platforms) if platforms else None)(spec)
    return {int(batch_windows): exported}


def save_predictor(path: str, exported: Dict[int, object], meta: dict) -> None:
    """Write {batch: Exported} + metadata as one ``.misx`` container."""
    blobs = {int(b): bytes(e.serialize()) for b, e in exported.items()}
    buckets = {}
    offset = 0
    for b in sorted(blobs):
        buckets[str(b)] = [offset, len(blobs[b])]
        offset += len(blobs[b])
    header = json.dumps({"meta": meta, "buckets": buckets}).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for b in sorted(blobs):
            f.write(blobs[b])


class ServingPredictor:
    """A loaded ``.misx`` artifact: call with a (N, S, S, 1) uint8 batch of
    any N; returns (N, S, S, 1) uint8 0/1 masks. Buckets deserialize lazily
    and are cached (first call per bucket pays the XLA consume/compile)."""

    def __init__(self, meta: dict, blobs: Dict[int, bytes]):
        self.meta = meta
        self._blobs = blobs
        self._fns: Dict[int, object] = {}

    @property
    def image_size(self) -> int:
        return int(self.meta["image_size"])

    @property
    def batch_sizes(self):
        return sorted(self._blobs)

    def _bucket_fn(self, b: int):
        if b not in self._fns:
            import jax

            self._fns[b] = jax.export.deserialize(bytearray(self._blobs[b]))
        return self._fns[b]

    def __call__(self, imgs_u8: np.ndarray) -> np.ndarray:
        imgs_u8 = np.ascontiguousarray(imgs_u8, np.uint8)
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 1:
            raise ValueError(f"expected (N, S, S, 1) uint8, got {imgs_u8.shape}")
        s = self.image_size
        if imgs_u8.shape[1:3] != (s, s):
            raise ValueError(
                f"artifact was exported for {s}x{s} inputs, got {imgs_u8.shape[1:3]}")
        n = imgs_u8.shape[0]
        sizes = self.batch_sizes
        out = np.empty((n, s, s, 1), np.uint8)
        i = 0
        while i < n:
            rem = n - i
            # greedy decomposition: largest bucket that fits, so a 9-image
            # tail with buckets (1, 8, 64) runs 8 then 1 instead of padding
            # 64; only a remainder smaller than every bucket pads (up to the
            # smallest bucket that covers it — waste bounded by min bucket).
            fits = [x for x in sizes if x <= rem]
            b = fits[-1] if fits else next(x for x in sizes if x >= rem)
            take = min(rem, b)
            chunk = imgs_u8[i : i + take]
            if take < b:  # pad the tail by repeating the last sample
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - take, axis=0)], axis=0)
            masks = self._bucket_fn(b).call(chunk)
            out[i : i + take] = np.asarray(masks)[:take]
            i += take
        return out


def _read_container(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a .misx artifact (bad magic)")
    (hlen,) = struct.unpack_from("<I", data, len(_MAGIC))
    hstart = len(_MAGIC) + 4
    header = json.loads(data[hstart : hstart + hlen])
    base = hstart + hlen
    blobs = {}
    for b, (off, size) in header["buckets"].items():
        blob = data[base + off : base + off + size]
        if len(blob) != size:
            raise ValueError(f"{path}: truncated artifact (bucket {b})")
        blobs[int(b)] = blob
    return header["meta"], blobs


def artifact_platforms(exported) -> list:
    """The lowering platforms the exported functions report (jax's names:
    ``cuda`` for NVIDIA GPUs, ``cpu``), for the artifact's meta."""
    return sorted({p for e in exported.values() for p in e.platforms})


def _check_platform(path: str, meta: dict) -> None:
    import jax

    here = jax.export.default_export_platform()
    platforms = meta.get("platforms")
    if platforms and here not in platforms:
        raise ValueError(
            f"{path}: artifact was lowered for {platforms}, not for this host's "
            f"{here!r}; re-export with --platforms {','.join(sorted({*platforms, here}))}")


def load_predictor(path: str) -> ServingPredictor:
    """Read a batched-2D ``.misx`` container → ServingPredictor (blobs held
    in memory, deserialized per bucket on first use)."""
    meta, blobs = _read_container(path)
    _check_platform(path, meta)
    if meta.get("kind", "batched2d") != "batched2d":
        raise ValueError(
            f"{path}: artifact kind {meta.get('kind')!r} is not a batched 2D "
            f"predictor (use load_window_predictor / mis-predict3d --exported)")
    return ServingPredictor(meta, blobs)


def load_window_predictor(path: str):
    """Read a volumetric window ``.misx`` artifact → (meta, window_fn).

    ``window_fn`` takes EXACTLY ``meta['batch_windows']`` raw 0..1 windows
    (B, d, h, w, 1) float32 and returns logits — the ``apply_fn`` contract of
    ``sliding_window_predict_3d`` (which always pads the tail batch)."""
    meta, blobs = _read_container(path)
    _check_platform(path, meta)
    if meta.get("kind") != "window3d":
        raise ValueError(
            f"{path}: artifact kind {meta.get('kind')!r} is not a volumetric "
            f"window predictor (use load_predictor / mis-predict --exported)")
    if len(blobs) != 1:
        raise ValueError(
            f"{path}: window3d artifacts must contain exactly one bucket "
            f"(got {sorted(blobs)}); sliding_window_predict_3d pads every "
            f"batch to one static size")
    (b,) = blobs.keys()
    fns = {}

    def window_fn(windows01):
        if b not in fns:
            import jax

            fns[b] = jax.export.deserialize(bytearray(blobs[b]))
        return fns[b].call(windows01)

    return meta, window_fn
