"""Host-side RandomResizedCrop pre-crop for the SSL input pipeline.

Default pipeline: the host ships full stored images and the device does the
RandomResizedCrop as two batched matmuls (ops/augment.py). That is the right
split when the device has time to spare — augmentation rides along for
free. But on hosts with a narrow host<->device link (PCIe-starved VMs,
remote devices) the H2D copy of the full-resolution batch can be the
bottleneck. This module moves only
the *geometric* part of the augmentation (crop + resize + hflip) to the C++
decode workers, shipping 2 x crop^2 views instead of 1 x image^2 pixels —
~2x fewer bytes for the canonical 256^2 store -> 2x112^2 BYOL views — while
the elementwise tail (solarize / CT windowing / normalize) stays on device
(ops.augment.two_view_tail_augment).

The crop geometry matches the device resampler bit-for-bit in convention
(half-pixel centers, 2-tap bilinear, output-coordinate mirroring for flips
— ops/augment.py::_resize_matrix/_flip_cols); tests/test_precrop.py pins
C++ vs numpy-oracle vs device-resampler agreement.

The reference has no analogue: FFCV's RandomResizedCropRGBImageDecoder does
crop-at-decode on the host *always* (reference lightning_module.py:77-80);
here it is an opt-in mode of a device-first design.

Window sampling is reproducible per (seed, epoch, batch_index) so
``--resume`` re-creates the identical augmentation stream (same contract as
Loader.make_order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_rrc_windows_np(
    rng: np.random.Generator,
    batch: int,
    in_h: int,
    in_w: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
    hflip_prob: float = 0.5,
) -> np.ndarray:
    """Sample (batch, 5) float32 RRC windows (y0, x0, h, w, flip).

    numpy mirror of ops.augment.sample_rrc_window (single-shot area/ratio
    sample, clamped to bounds) + the hflip coin; same distribution, host RNG.
    """
    area = in_h * in_w * rng.uniform(scale[0], scale[1], size=batch)
    aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]), size=batch))
    w = np.sqrt(area * aspect)
    h = np.sqrt(area / aspect)
    w = np.clip(w, 1.0, in_w)
    h = np.clip(h, 1.0, in_h)
    y0 = rng.uniform(size=batch) * (in_h - h)
    x0 = rng.uniform(size=batch) * (in_w - w)
    flip = (rng.uniform(size=batch) < hflip_prob).astype(np.float32)
    return np.stack([y0, x0, h, w, flip], axis=1).astype(np.float32)


def make_view_params(
    seed: int,
    epoch: int,
    batch_index: int,
    batch: int,
    in_h: int,
    in_w: int,
    n_views: int = 2,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
    hflip_prob: float = 0.5,
    shard: int = 0,
) -> np.ndarray:
    """Deterministic (batch, n_views, 5) window params for one batch.

    ``shard`` (the host index under multi-host training) MUST be folded in:
    every host holds a distinct slice of the global batch, so reusing one
    window stream across hosts would apply identical (y0,x0,h,w,flip) to
    slot-i of every host's shard — silently dividing augmentation diversity
    by the host count relative to the device-side path, which samples an
    independent window per global sample."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, batch_index, shard]))
    return np.stack(
        [sample_rrc_windows_np(rng, batch, in_h, in_w, scale, ratio, hflip_prob)
         for _ in range(n_views)],
        axis=1,
    )


def crop_resize_bilinear_np(
    img: np.ndarray,  # (H, W, C) uint8 or uint16
    y0: float,
    x0: float,
    ch: float,
    cw: float,
    flip: bool,
    vh: int,
    vw: int,
) -> np.ndarray:
    """Pure-numpy oracle for csrc/mis_loader.cpp::crop_resize_bilinear.

    Same half-pixel convention as the device resampler
    (ops/augment.py::_resize_matrix): src = start + (i+0.5)*size/out - 0.5,
    clipped to [0, dim-1], 2-tap lerp; flips mirror the OUTPUT coordinate.
    Rounds to nearest in the input dtype. Used as the no-toolchain fallback
    and as the parity reference in tests.
    """
    sh, sw = img.shape[:2]
    i = np.arange(vh, dtype=np.float32)
    j = np.arange(vw, dtype=np.float32)
    jpos = (vw - (j + 0.5)) if flip else (j + 0.5)
    fy = np.clip(np.float32(y0) + (i + 0.5) * np.float32(ch / vh) - 0.5, 0, sh - 1)
    fx = np.clip(np.float32(x0) + jpos * np.float32(cw / vw) - 0.5, 0, sw - 1)
    ylo = fy.astype(np.int64)
    xlo = fx.astype(np.int64)
    yhi = np.minimum(ylo + 1, sh - 1)
    xhi = np.minimum(xlo + 1, sw - 1)
    yf = (fy - ylo).astype(np.float32)[:, None, None]
    xf = (fx - xlo).astype(np.float32)[None, :, None]
    a = img[ylo][:, xlo].astype(np.float32)
    b = img[ylo][:, xhi].astype(np.float32)
    c = img[yhi][:, xlo].astype(np.float32)
    d = img[yhi][:, xhi].astype(np.float32)
    top = a + (b - a) * xf
    bot = c + (d - c) * xf
    out = top + (bot - top) * yf
    return (out + 0.5).astype(img.dtype)


def fetch_views_fallback(reader, indices, params, out_hw):
    """StoreReader-backed pure-Python fetch_views (no native toolchain).

    Same output layout as NativeStore.fetch_views: (B*V, vh, vw, C) in the
    store's sample dtype, SAMPLE-major (view v of sample i at row i*V + v)
    + (B,) int32 labels.
    """
    n = len(indices)
    views = params.shape[1]
    vh, vw = out_hw
    c = reader.header.channels
    out = np.empty((n * views, vh, vw, c), reader.header.sample_dtype)
    labels = np.empty((n,), np.int32)
    for i, idx in enumerate(indices):
        img, lab = reader[int(idx)]
        labels[i] = lab
        h, w = img.shape[:2]
        for v in range(views):
            y0, x0, ch, cw, flip = params[i, v]
            ch = float(np.clip(ch, 1.0, h))
            cw = float(np.clip(cw, 1.0, w))
            y0 = float(np.clip(y0, 0.0, h - ch))
            x0 = float(np.clip(x0, 0.0, w - cw))
            out[i * views + v] = crop_resize_bilinear_np(
                img, y0, x0, ch, cw, bool(flip), vh, vw)
    return out, labels
