"""Sliding-window full-resolution segmentation inference.

BASELINE.json config #4 ("segmentation fine-tune from SSL encoder: Dice+CE,
sliding-window eval, full-res masks"): evaluate a window-trained U-Net on
arbitrarily large slices by tiling overlapping windows, batching them
through the jitted forward, and blending logits back with a smooth
center-peaked weight map (so window-edge artifacts cancel).

Design: window extraction, the model forward, and the scatter-blend are
three jitted programs with static shapes — each compiled once regardless of
image size class; the blend is a `fori_loop` of dynamic-slice updates.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _window_starts(full: int, window: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, full) with the last window right-aligned."""
    if full <= window:
        return np.array([0], np.int32)
    starts = list(range(0, full - window + 1, stride))
    if starts[-1] != full - window:
        starts.append(full - window)
    return np.asarray(starts, np.int32)


def _blend_weights(window: int) -> np.ndarray:
    """1-D center-peaked (Hann) blend profile, strictly positive."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(window) + 0.5) / window)
    return (w + 1e-3).astype(np.float32)


@partial(jax.jit, static_argnames=("window",))
def _extract_windows(image, coords, window: int):
    def one(c):
        return jax.lax.dynamic_slice(image, (c[0], c[1], 0), (window, window, image.shape[2]))

    return jax.vmap(one)(coords)


@partial(jax.jit, static_argnames=("window",))
def _blend_batch(out_logits, weight_sum, coords, weighted, blend, valid, window: int):
    """fori_loop scatter-add of weighted window logits into the canvas."""
    k = out_logits.shape[-1]

    def body(j, carry):
        ol, ws = carry
        y, x = coords[j, 0], coords[j, 1]
        v = (j < valid).astype(jnp.float32)
        patch = jax.lax.dynamic_slice(ol, (y, x, 0), (window, window, k))
        ol = jax.lax.dynamic_update_slice(ol, patch + weighted[j] * v, (y, x, 0))
        wpatch = jax.lax.dynamic_slice(ws, (y, x, 0), (window, window, 1))
        ws = jax.lax.dynamic_update_slice(ws, wpatch + blend * v, (y, x, 0))
        return ol, ws

    return jax.lax.fori_loop(0, coords.shape[0], body, (out_logits, weight_sum))


def sliding_window_predict(
    apply_fn: Callable[[jax.Array], jax.Array],   # (N, S, S, C) → (N, S, S, K) logits
    image: jax.Array,                              # (H, W, C) full-res, already normalized
    window: int,
    stride: int = 0,
    batch_windows: int = 16,
    num_classes: int = 1,
    mesh=None,
) -> jax.Array:
    """Full-res logits (H, W, K) by overlapped window blending.

    ``mesh``: optional ``jax.sharding.Mesh`` — shards each window batch over
    the mesh's ``data`` axis so the U-Net forward (the FLOPs) runs on all
    chips; extraction and the scatter-blend stay replicated (they are
    bandwidth-trivial next to the forward). ``batch_windows`` is rounded up
    to a multiple of the mesh size."""
    if stride <= 0:
        stride = window // 2
    shard_views = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        ndev = int(np.prod(list(mesh.shape.values())))
        batch_windows = -(-batch_windows // ndev) * ndev
        sharding = NamedSharding(mesh, PartitionSpec("data"))

        def shard_views(v):
            return jax.device_put(v, sharding)
    orig_h, orig_w, c = image.shape
    pad_h = max(window - orig_h, 0)
    pad_w = max(window - orig_w, 0)
    if pad_h or pad_w:
        image = jnp.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
    h, w, _ = image.shape

    ys = _window_starts(h, window, stride)
    xs = _window_starts(w, window, stride)
    coords = np.array([(y, x) for y in ys for x in xs], np.int32)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])

    wy = jnp.asarray(_blend_weights(window))
    blend = (wy[:, None] * wy[None, :])[..., None]  # (S, S, 1)

    out_logits = jnp.zeros((h, w, num_classes), jnp.float32)
    weight_sum = jnp.zeros((h, w, 1), jnp.float32)
    for s in range(0, len(coords), batch_windows):
        cb = jnp.asarray(coords[s : s + batch_windows])
        windows = _extract_windows(image, cb, window)
        if shard_views is not None:
            windows = shard_views(windows)
        logits = apply_fn(windows).astype(jnp.float32)        # (B, S, S, K)
        valid = jnp.int32(min(n - s, batch_windows))
        out_logits, weight_sum = _blend_batch(
            out_logits, weight_sum, cb, logits * blend, blend, valid, window
        )

    full = out_logits / weight_sum
    return full[:orig_h, :orig_w]


def _make_fused_predictor(
    apply_fn: Callable[[jax.Array], jax.Array],
    shape,                                        # (*spatial, C) of the inputs served
    window,                                       # per-dim window extents
    stride=None,
    batch_windows: int = 8,
    num_classes: int = 1,
):
    """Shape-specialized ONE-DISPATCH sliding-window predictor (N-D core).

    The loop variants above launch 3 programs per window batch (extract /
    forward / blend) plus a host→device coordinate transfer — ~12 dispatches
    for a 125-window CT volume. In serving, the window grid is a pure
    function of the volume shape class, so it can be precomputed once and
    baked into a single jitted program: a `lax.scan` over window batches
    whose body extracts, forwards, and Hann-scatter-blends on device. One
    dispatch per volume; the latency overhead of program launches and
    coordinate uploads disappears.

    Logits and blend weights accumulate in ONE (..., K+1)-channel canvas so
    each window costs a single dynamic-slice/update pair instead of two.
    Numerics match the loop variant bit-for-bit in f32 accumulation.
    """
    window = tuple(int(w) for w in window)
    nd = len(window)
    if stride is None:
        stride = tuple(max(1, s // 2) for s in window)
    stride = tuple(int(s) for s in stride)
    orig = tuple(int(s) for s in shape[:nd])
    channels = int(shape[nd])
    pads = tuple(max(w - o, 0) for w, o in zip(window, orig))
    dims = tuple(o + p for o, p in zip(orig, pads))

    starts = [_window_starts(dims[i], window[i], stride[i]) for i in range(nd)]
    grids = np.meshgrid(*starts, indexing="ij")
    coords = np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])
    nb = len(coords) // batch_windows
    coord_batches = coords.reshape(nb, batch_windows, nd)
    bases = (np.arange(nb, dtype=np.int32) * batch_windows)

    profiles = [_blend_weights(w) for w in window]
    blend = profiles[0]
    for p in profiles[1:]:
        blend = blend[..., None] * p
    blend = jnp.asarray(blend[..., None])            # (*window, 1)

    @jax.jit
    def predict(x):                                   # (*orig, C) → (*orig, K)
        if any(pads):
            x = jnp.pad(x, tuple((0, p) for p in pads) + ((0, 0),))
        canvas = jnp.zeros((*dims, num_classes + 1), jnp.float32)

        def batch_body(canvas, inp):
            cb, base = inp                            # (B, nd), scalar

            def extract(c):
                return jax.lax.dynamic_slice(
                    x, (*(c[i] for i in range(nd)), 0), (*window, channels))

            wins = jax.vmap(extract)(cb)
            logits = apply_fn(wins).astype(jnp.float32)
            weighted = jnp.concatenate(
                [logits * blend,
                 jnp.broadcast_to(blend, (batch_windows, *window, 1))], axis=-1)

            def body(j, cv):
                v = ((base + j) < n).astype(jnp.float32)
                at = (*(cb[j, i] for i in range(nd)), 0)
                patch = jax.lax.dynamic_slice(cv, at, (*window, num_classes + 1))
                return jax.lax.dynamic_update_slice(cv, patch + weighted[j] * v, at)

            return jax.lax.fori_loop(0, batch_windows, body, canvas), None

        canvas, _ = jax.lax.scan(
            batch_body, canvas, (jnp.asarray(coord_batches), jnp.asarray(bases)))
        full = canvas[..., :num_classes] / canvas[..., num_classes:]
        return full[tuple(slice(0, o) for o in orig)]

    return predict


def make_fused_predictor_3d(apply_fn, volume_shape, window, stride=None,
                            batch_windows: int = 8, num_classes: int = 1):
    """One-dispatch variant of `sliding_window_predict_3d` for serving:
    specialize once per (D, H, W, C) shape class, then each call is a single
    compiled program. Parity with the loop variant is pinned in
    `tests/test_sliding_window.py`."""
    return _make_fused_predictor(apply_fn, volume_shape, window, stride,
                                 batch_windows, num_classes)


def make_fused_predictor_2d(apply_fn, image_shape, window: int, stride: int = 0,
                            batch_windows: int = 16, num_classes: int = 1):
    """One-dispatch variant of `sliding_window_predict` (2D serving)."""
    return _make_fused_predictor(apply_fn, image_shape, (window, window),
                                 (stride, stride) if stride > 0 else None,
                                 batch_windows, num_classes)


def make_unet_window_fn(task, state):
    """Jitted normalized-window forward for `sliding_window_predict`."""

    @jax.jit
    def fn(windows):
        return task.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            windows, train=False,
        )

    return fn


# ---------------------------------------------------------------------------
# volumetric (3D) variant — same tiling/Hann-blend scheme over (D, H, W)


@partial(jax.jit, static_argnames=("window",))
def _extract_windows_3d(volume, coords, window):
    wd, wh, ww = window

    def one(c):
        return jax.lax.dynamic_slice(volume, (c[0], c[1], c[2], 0), (wd, wh, ww, volume.shape[3]))

    return jax.vmap(one)(coords)


@partial(jax.jit, static_argnames=("window",))
def _blend_batch_3d(out_logits, weight_sum, coords, weighted, blend, valid, window):
    wd, wh, ww = window
    k = out_logits.shape[-1]

    def body(j, carry):
        ol, ws = carry
        z, y, x = coords[j, 0], coords[j, 1], coords[j, 2]
        v = (j < valid).astype(jnp.float32)
        patch = jax.lax.dynamic_slice(ol, (z, y, x, 0), (wd, wh, ww, k))
        ol = jax.lax.dynamic_update_slice(ol, patch + weighted[j] * v, (z, y, x, 0))
        wpatch = jax.lax.dynamic_slice(ws, (z, y, x, 0), (wd, wh, ww, 1))
        ws = jax.lax.dynamic_update_slice(ws, wpatch + blend * v, (z, y, x, 0))
        return ol, ws

    return jax.lax.fori_loop(0, coords.shape[0], body, (out_logits, weight_sum))


def sliding_window_predict_3d(
    apply_fn: Callable[[jax.Array], jax.Array],   # (N, d, h, w, C) → (N, d, h, w, K)
    volume: jax.Array,                             # (D, H, W, C) full-res, normalized
    window,                                        # (d, h, w)
    stride=None,                                   # (d, h, w); default window // 2
    batch_windows: int = 4,
    num_classes: int = 1,
    mesh=None,
) -> jax.Array:
    """Full-res volumetric logits (D, H, W, K) by overlapped window blending
    — the standard way to evaluate a crop-trained 3D U-Net on whole CT/MR
    volumes (the 3D analogue of `sliding_window_predict`; the reference has
    neither). ``mesh`` shards each window batch over the ``data`` axis."""
    window = tuple(window)
    if stride is None:
        stride = tuple(max(1, s // 2) for s in window)
    stride = tuple(stride)
    shard_views = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        ndev = int(np.prod(list(mesh.shape.values())))
        batch_windows = -(-batch_windows // ndev) * ndev
        sharding = NamedSharding(mesh, PartitionSpec("data"))

        def shard_views(v):
            return jax.device_put(v, sharding)
    orig = volume.shape[:3]
    pads = [max(w - o, 0) for w, o in zip(window, orig)]
    if any(pads):
        volume = jnp.pad(volume, tuple((0, p) for p in pads) + ((0, 0),))
    dims = volume.shape[:3]

    starts = [_window_starts(dims[i], window[i], stride[i]) for i in range(3)]
    coords = np.array([(z, y, x) for z in starts[0] for y in starts[1] for x in starts[2]], np.int32)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])

    wz, wy, wx = (jnp.asarray(_blend_weights(w)) for w in window)
    blend = (wz[:, None, None] * wy[None, :, None] * wx[None, None, :])[..., None]

    out_logits = jnp.zeros((*dims, num_classes), jnp.float32)
    weight_sum = jnp.zeros((*dims, 1), jnp.float32)
    for s in range(0, len(coords), batch_windows):
        cb = jnp.asarray(coords[s : s + batch_windows])
        windows = _extract_windows_3d(volume, cb, window)
        if shard_views is not None:
            windows = shard_views(windows)
        logits = apply_fn(windows).astype(jnp.float32)
        valid = jnp.int32(min(n - s, batch_windows))
        out_logits, weight_sum = _blend_batch_3d(
            out_logits, weight_sum, cb, logits * blend, blend, valid, window
        )

    full = out_logits / weight_sum
    return full[: orig[0], : orig[1], : orig[2]]
