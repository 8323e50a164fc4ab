"""On-device batched augmentation — the FFCV pipeline re-designed for the accelerator.

Replaces the reference's FFCV/Numba two-view SSL pipeline
(`medical_image_segmentation/train/data_loaders/lightning_module.py:67-98`):
RandomResizedCrop(scale=(0.08,1.0), ratio=(0.75,1.333)) → RandomHFlip →
RandomGrayscale(p=0.2) → Solarization → Normalize(mean·255, std·255), and
the torchvision variant's extras (`lightning_module.py:39-64`): ColorJitter
(brightness/contrast/saturation) and GaussianBlur(k=23).

Design — *resampling as matmul*:
    A bilinear crop-resize is separable, so each sample's view is
        view = R_y @ img @ R_xᵀ        (per channel)
    where R_y (out_h, in_h) and R_x (out_w, in_w) are interpolation
    matrices with ≤2 nonzeros per row, built on device from the sampled
    crop window via `broadcasted_iota` comparisons. The batch of views is
    then two batched matmuls (`einsum` → `dot_general` with batch dims,
    cuBLAS on the GPU) — no gathers, no dynamic shapes, and the
    elementwise tail (grayscale mix, solarize, normalize) fuses into the
    same HBM pass. Horizontal flip is folded into R_x by reversing the
    sampled window (zero cost). Gaussian blur is two more tiny matmuls
    with a Toeplitz kernel matrix.

    Cost: a 224→112 two-view batch is ~135 MFLOP/img of bf16 matmul —
    ~3 orders of magnitude below a ResNet-18 fwd/bwd, so augmentation
    rides along invisibly instead of bottlenecking the input pipeline the
    way host-side decode/augment does in the reference (SURVEY §7 "the
    loader, not the model").

Deviations from torchvision documented inline:
    - RandomResizedCrop samples area/ratio once (no 10-try rejection
      loop; identical distribution in the overwhelmingly common accept
      case, static control flow for XLA).
    - GaussianBlur sigma ~ U(0.1, 2.0) as in torchvision's SSL recipes.

Coordinate convention: half-pixel centers (`align_corners=False`), matching
cv2/torch/PIL bilinear used by the reference loaders.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def _resize_matrix(
    start: jax.Array,  # (B,) crop start (pixels, float)
    size: jax.Array,   # (B,) crop size (pixels, float)
    in_dim: int,
    out_dim: int,
    dtype=jnp.float32,
) -> jax.Array:
    """Batched bilinear interpolation matrices (B, out_dim, in_dim).

    Row i holds the two-tap bilinear weights for output coordinate i of a
    crop [start, start+size) resized to out_dim, half-pixel convention.
    """
    scale = size / out_dim                                      # (B,)
    i = jax.lax.broadcasted_iota(jnp.float32, (1, out_dim, 1), 1)
    src = start[:, None, None] + (i + 0.5) * scale[:, None, None] - 0.5  # (B, out, 1)
    src = jnp.clip(src, 0.0, in_dim - 1)
    lo = jnp.floor(src)
    frac = src - lo
    k = jax.lax.broadcasted_iota(jnp.float32, (1, 1, in_dim), 2)
    w = (k == lo) * (1.0 - frac) + (k == lo + 1.0) * frac
    # when src lands exactly on the last pixel, lo+1 is out of range and the
    # (k==lo) term already carries weight (1-frac)=1.
    return w.astype(dtype)


def _nearest_matrix(start, size, in_dim: int, out_dim: int, dtype=jnp.float32) -> jax.Array:
    """Nearest-neighbor resampling matrices (for masks — reference resizes
    masks with NEAREST, `lightning_module.py:694-699`)."""
    scale = size / out_dim
    i = jax.lax.broadcasted_iota(jnp.float32, (1, out_dim, 1), 1)
    src = start[:, None, None] + (i + 0.5) * scale[:, None, None] - 0.5
    src = jnp.clip(jnp.round(src), 0.0, in_dim - 1)
    k = jax.lax.broadcasted_iota(jnp.float32, (1, 1, in_dim), 2)
    return (k == src).astype(dtype)


def _flip_cols(r_x: jax.Array, flip: jax.Array) -> jax.Array:
    """Fold a per-sample horizontal flip into the column matrices by
    reversing the output rows of R_x where flip is set."""
    flipped = r_x[:, ::-1, :]
    return jnp.where(flip[:, None, None], flipped, r_x)


def apply_resample(img: jax.Array, r_y: jax.Array, r_x: jax.Array) -> jax.Array:
    """Batched separable resample: (B,H,W,C) → (B,h,w,C) via two matmuls."""
    dt = r_y.dtype
    img = img.astype(dt)
    tmp = jnp.einsum("boh,bhwc->bowc", r_y, img)   # rows
    out = jnp.einsum("bpw,bowc->bopc", r_x, tmp)   # cols
    return out


def sample_rrc_window(
    rng: jax.Array,
    batch: int,
    in_h: int,
    in_w: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
):
    """Sample RandomResizedCrop windows (single-shot, clamped to bounds).

    torchvision rejection-samples up to 10 times
    (`lightning_module.py:77-80` uses FFCV's decoder with the same
    (scale, ratio)); we sample once and clamp — identical in distribution
    whenever the first try fits, which dominates for these parameters.
    """
    r_area, r_ratio, r_y, r_x = jax.random.split(rng, 4)
    area = in_h * in_w * jax.random.uniform(r_area, (batch,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(
        r_ratio, (batch,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])
    )
    aspect = jnp.exp(log_r)
    w = jnp.sqrt(area * aspect)
    h = jnp.sqrt(area / aspect)
    w = jnp.clip(w, 1.0, in_w)
    h = jnp.clip(h, 1.0, in_h)
    y0 = jax.random.uniform(r_y, (batch,)) * (in_h - h)
    x0 = jax.random.uniform(r_x, (batch,)) * (in_w - w)
    return y0, x0, h, w


@dataclasses.dataclass(frozen=True)
class ViewConfig:
    """Augmentation parameters for one SSL view (reference
    `BYOLRGBFFCVDataTransforms`, `lightning_module.py:67-98`; blur/jitter
    from the torchvision variant `lightning_module.py:39-64`)."""

    out_size: Tuple[int, int] = (112, 112)
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_prob: float = 0.5
    grayscale_prob: float = 0.2
    solarize_prob: float = 0.0          # view1: 0.0, view2: 0.2
    solarize_threshold: float = 128.0
    blur_prob: float = 0.0              # torchvision recipe: 1.0 / 0.1
    blur_kernel: int = 23
    jitter_prob: float = 0.0            # reference ColorJitter applied w.p. 0.8
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    # random CT windowing (PAPERS.md: "Random Window Augmentations for Deep
    # Learning Robustness in CT", "View it like a radiologist"): re-window
    # the 0-255 intensity range with a random level/width, simulating
    # different radiology display windows. Off by default (not in the
    # reference pipeline).
    window_prob: float = 0.0
    window_level_range: Tuple[float, float] = (96.0, 160.0)
    window_width_range: Tuple[float, float] = (128.0, 255.0)
    # full-scale sample value: 255 for uint8 stores, 65535 for 16-bit
    # (FLAG_U16) stores — the HU-native path the reference cannot express
    # (its FFCV data is squashed to uint8 at build time). Scales the
    # windowing output range, the solarize reflection, and the jitter clip;
    # thresholds/ranges in this config are on the SAME scale (the
    # datamodule rescales them, datamodules.py::view_configs).
    value_max: float = 255.0


# Canonical two-view configs (BYOL asymmetry: solarize only on view 2,
# blur strong on view 1 — reference lightning_module.py:55-60, 86-88).
# FFCV-pipeline parity (the reference's canonical SSL path): no blur/jitter.
BYOL_VIEW1 = ViewConfig(solarize_prob=0.0)
BYOL_VIEW2 = ViewConfig(solarize_prob=0.2)

# torchvision-pipeline parity (reference BYOLRGBDataTransforms,
# lightning_module.py:39-64): ColorJitter(0.4,0.4,0.2)@p=0.8,
# GaussianBlur(k=23)@(1.0, 0.1), Solarize@(0.0, 0.2).
BYOL_TV_VIEW1 = ViewConfig(blur_prob=1.0, jitter_prob=0.8, brightness=0.4, contrast=0.4,
                           saturation=0.2, solarize_prob=0.0)
BYOL_TV_VIEW2 = ViewConfig(blur_prob=0.1, jitter_prob=0.8, brightness=0.4, contrast=0.4,
                           saturation=0.2, solarize_prob=0.2)


def _blur_matrix(rng: jax.Array, batch: int, dim: int, kernel: int, prob: float, dtype) -> jax.Array:
    """Per-sample Gaussian blur as a (B, dim, dim) Toeplitz matrix, identity
    where the blur coin comes up tails. sigma ~ U(0.1, 2.0)."""
    r_sig, r_coin = jax.random.split(rng)
    sigma = jax.random.uniform(r_sig, (batch,), minval=0.1, maxval=2.0)
    coin = jax.random.uniform(r_coin, (batch,)) < prob
    half = kernel // 2
    i = jax.lax.broadcasted_iota(jnp.float32, (1, dim, dim), 1)
    j = jax.lax.broadcasted_iota(jnp.float32, (1, dim, dim), 2)
    d = j - i
    g = jnp.exp(-(d * d) / (2.0 * sigma[:, None, None] ** 2))
    g = jnp.where(jnp.abs(d) <= half, g, 0.0)
    g = g / jnp.sum(g, axis=2, keepdims=True)
    eye = jnp.eye(dim, dtype=jnp.float32)[None]
    return jnp.where(coin[:, None, None], g, eye).astype(dtype)


def augment_view(
    rng: jax.Array,
    images: jax.Array,          # (B, H, W, C) uint8 or float in [0, 255]
    cfg: ViewConfig,
    mean: Sequence[float],      # per-channel, 0-255 scale
    std: Sequence[float],
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Produce one augmented, normalized view (B, out_h, out_w, C)."""
    b, in_h, in_w, c = images.shape
    out_h, out_w = cfg.out_size
    keys = jax.random.split(rng, 8)

    y0, x0, h, w = sample_rrc_window(keys[0], b, in_h, in_w, cfg.crop_scale, cfg.crop_ratio)
    r_y = _resize_matrix(y0, h, in_h, out_h, dtype)
    r_x = _resize_matrix(x0, w, in_w, out_w, dtype)
    flip = jax.random.uniform(keys[1], (b,)) < cfg.hflip_prob
    r_x = _flip_cols(r_x, flip)

    if cfg.blur_prob > 0.0:
        # blur after resize (on the small view) — separable, two matmuls
        r_y = jnp.einsum("bij,bjk->bik", _blur_matrix(keys[2], b, out_h, cfg.blur_kernel, cfg.blur_prob, dtype), r_y)
        r_x = jnp.einsum("bij,bjk->bik", _blur_matrix(keys[3], b, out_w, cfg.blur_kernel, cfg.blur_prob, dtype), r_x)

    x = apply_resample(images, r_y, r_x).astype(jnp.float32)  # (B,h,w,C), 0..255
    return _elementwise_tail((keys[4], keys[5], keys[6], keys[7]), x, cfg, mean, std, dtype)


def _elementwise_tail(keys, x, cfg: ViewConfig, mean, std, dtype) -> jax.Array:
    """The post-resample elementwise ops (jitter / grayscale / windowing /
    solarize / normalize), shared by the full device path (augment_view) and
    the host-precrop tail (augment_view_tail). ``keys`` = (jitter, grayscale,
    solarize, window) — positions match augment_view's historical key split,
    so the RNG stream of the full path is unchanged by this refactor."""
    b = x.shape[0]
    c = x.shape[-1]

    if cfg.jitter_prob > 0.0:
        jk = jax.random.split(keys[0], 4)
        on = (jax.random.uniform(jk[0], (b, 1, 1, 1)) < cfg.jitter_prob).astype(jnp.float32)
        if cfg.brightness > 0:
            f = jax.random.uniform(jk[1], (b, 1, 1, 1), minval=1 - cfg.brightness, maxval=1 + cfg.brightness)
            x = x * (1.0 + on * (f - 1.0))
        if cfg.contrast > 0:
            f = jax.random.uniform(jk[2], (b, 1, 1, 1), minval=1 - cfg.contrast, maxval=1 + cfg.contrast)
            m = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
            x = jnp.where(on > 0, m + f * (x - m), x)
        if cfg.saturation > 0 and c == 3:
            f = jax.random.uniform(jk[3], (b, 1, 1, 1), minval=1 - cfg.saturation, maxval=1 + cfg.saturation)
            gray = jnp.sum(x * jnp.asarray([0.299, 0.587, 0.114]), axis=-1, keepdims=True)
            x = jnp.where(on > 0, gray + f * (x - gray), x)
        x = jnp.clip(x, 0.0, cfg.value_max)

    if cfg.grayscale_prob > 0.0 and c == 3:
        coin = jax.random.uniform(keys[1], (b, 1, 1, 1)) < cfg.grayscale_prob
        gray = jnp.sum(x * jnp.asarray([0.299, 0.587, 0.114]), axis=-1, keepdims=True)
        x = jnp.where(coin, jnp.broadcast_to(gray, x.shape), x)

    if cfg.window_prob > 0.0:
        wk1, wk2, wk3 = jax.random.split(keys[3], 3)
        on = jax.random.uniform(wk1, (b, 1, 1, 1)) < cfg.window_prob
        level = jax.random.uniform(wk2, (b, 1, 1, 1), minval=cfg.window_level_range[0],
                                   maxval=cfg.window_level_range[1])
        width = jax.random.uniform(wk3, (b, 1, 1, 1), minval=cfg.window_width_range[0],
                                   maxval=cfg.window_width_range[1])
        lo = level - width / 2.0
        rewin = jnp.clip((x - lo) / width * cfg.value_max, 0.0, cfg.value_max)
        x = jnp.where(on, rewin, x)

    if cfg.solarize_prob > 0.0:
        coin = jax.random.uniform(keys[2], (b, 1, 1, 1)) < cfg.solarize_prob
        x = jnp.where(coin & (x >= cfg.solarize_threshold), cfg.value_max - x, x)

    mean_a = jnp.asarray(mean, jnp.float32).reshape(1, 1, 1, -1)
    std_a = jnp.asarray(std, jnp.float32).reshape(1, 1, 1, -1)
    return ((x - mean_a) / std_a).astype(dtype)


@partial(jax.jit, static_argnames=("cfg1", "cfg2", "mean", "std", "dtype"))
def two_view_augment(
    rng: jax.Array,
    images: jax.Array,
    cfg1: ViewConfig = BYOL_VIEW1,
    cfg2: ViewConfig = BYOL_VIEW2,
    mean: Tuple[float, ...] = (57.9764,),   # RADIOLOGY_1M train stats,
    std: Tuple[float, ...] = (60.4759,),    # lightning_module.py:212-213
    dtype=jnp.bfloat16,
) -> Tuple[jax.Array, jax.Array]:
    """The SSL two-view pipeline: one batch in, two independent views out.

    Replaces FFCV's `custom_field_mapper={"image_1": "image"}` decode-twice
    trick (`lightning_module.py:124-152`) — here the raw batch is decoded
    once and both views are sampled from it on device.
    """
    r1, r2 = jax.random.split(rng)
    v1 = augment_view(r1, images, cfg1, mean, std, dtype)
    v2 = augment_view(r2, images, cfg2, mean, std, dtype)
    return v1, v2


def precrop_supported(cfg: ViewConfig) -> bool:
    """True if ``cfg``'s post-crop ops are all elementwise, i.e. the view can
    be produced by the host pre-crop path (data/host_precrop.py) + the device
    tail. Only Gaussian blur disqualifies — it needs the resample matrices."""
    return cfg.blur_prob == 0.0


def augment_view_tail(
    rng: jax.Array,
    views: jax.Array,           # (B, out_h, out_w, C) uint8 pre-cropped views
    cfg: ViewConfig,
    mean: Sequence[float],
    std: Sequence[float],
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Elementwise tail for host-pre-cropped views: the crop/resize/flip
    already happened in the C++ loader (mis_fetch_views); apply the same
    jitter/grayscale/windowing/solarize/normalize ops as augment_view."""
    if not precrop_supported(cfg):
        raise ValueError("blur_prob > 0 requires the full device augment path")
    keys = jax.random.split(rng, 4)
    return _elementwise_tail(keys, views.astype(jnp.float32), cfg, mean, std, dtype)


@partial(jax.jit, static_argnames=("cfg1", "cfg2", "mean", "std", "dtype"))
def two_view_tail_augment(
    rng: jax.Array,
    views: jax.Array,           # (2B, h, w, C) sample-major (rows 2i, 2i+1)
    cfg1: ViewConfig = BYOL_VIEW1,
    cfg2: ViewConfig = BYOL_VIEW2,
    mean: Tuple[float, ...] = (57.9764,),
    std: Tuple[float, ...] = (60.4759,),
    dtype=jnp.bfloat16,
) -> Tuple[jax.Array, jax.Array]:
    """Two-view elementwise tail over the (2B, h, w, C) array that
    NativeStore.fetch_views ships (SAMPLE-major: rows 2i, 2i+1 are the two
    views of sample i). Pairs with Loader(precrop=...).

    Sample-major keeps the split shard-local under SPMD: a batch-sharded
    (2B, ...) array reshapes to (B, 2, ...) with each device slicing its
    own rows, and per-host shards concatenate into a correct global batch
    (view-major would pair view 1 of host 0 with view 1 of host 1)."""
    b2 = views.shape[0]
    if b2 % 2:
        raise ValueError("precrop views array must hold 2 views per sample")
    b = b2 // 2
    vv = views.reshape(b, 2, *views.shape[1:])
    r1, r2 = jax.random.split(rng)
    v1 = augment_view_tail(r1, vv[:, 0], cfg1, mean, std, dtype)
    v2 = augment_view_tail(r2, vv[:, 1], cfg2, mean, std, dtype)
    return v1, v2


@partial(jax.jit, static_argnames=("out_size", "mean", "std", "train", "dtype",
                                   "value_scale", "hu_windows"))
def segmentation_augment(
    rng: jax.Array,
    images: jax.Array,           # (B, H, W, 1) float 0..1 or uint8 0..255
    masks: jax.Array,            # (B, H, W, 1) binary
    out_size: Tuple[int, int] = (224, 224),
    mean: Tuple[float, ...] = (0.2089,),   # Decathlon liver stats,
    std: Tuple[float, ...] = (0.2109,),    # lightning_module.py:749-750
    train: bool = True,
    value_scale: float = 1.0 / 255.0,
    dtype=jnp.bfloat16,
    hu_windows: Tuple[Tuple[float, float], ...] = (),
):
    """Paired image/mask pipeline (reference `DecathlonDataModule`,
    `lightning_module.py:580-721` + paired flips in
    `pytorch_datasets.py:284-293`): resize to ``out_size`` (bilinear for
    image, NEAREST for mask), shared random h/v flips at train time,
    ColorJitter(0.2, 0.2) on the image only, normalize with dataset stats
    (0-1 scale).

    ``hu_windows``: optional fixed (level, width) pairs on the 0..1 scaled
    intensity axis — each becomes an input CHANNEL (clip((x-lo)/width, 0, 1)),
    the "view it like a radiologist" multi-window representation (PAPERS.md):
    the network sees every configured display window at full contrast instead
    of one squashed ramp. Deterministic (train AND eval — it is an input
    representation, not an augmentation); a single-entry mean/std broadcasts
    across the window channels. Pays off most on 16-bit HU-native stores
    where the windows address the full dynamic range."""
    b, in_h, in_w, _ = images.shape
    out_h, out_w = out_size
    zeros = jnp.zeros((b,))
    full_h = jnp.full((b,), float(in_h))
    full_w = jnp.full((b,), float(in_w))
    r_y = _resize_matrix(zeros, full_h, in_h, out_h, dtype)
    r_x = _resize_matrix(zeros, full_w, in_w, out_w, dtype)
    n_y = _nearest_matrix(zeros, full_h, in_h, out_h, dtype)
    n_x = _nearest_matrix(zeros, full_w, in_w, out_w, dtype)

    if train:
        kh, kv, kb, kc = jax.random.split(rng, 4)
        hflip = jax.random.uniform(kh, (b,)) < 0.5
        vflip = jax.random.uniform(kv, (b,)) < 0.5
        r_x = _flip_cols(r_x, hflip)
        n_x = _flip_cols(n_x, hflip)
        r_y = _flip_cols(r_y, vflip)   # same trick on rows = vertical flip
        n_y = _flip_cols(n_y, vflip)

    img = apply_resample(images, r_y, r_x).astype(jnp.float32) * value_scale  # → 0..1
    msk = apply_resample(masks, n_y, n_x).astype(jnp.float32)
    msk = (msk > 0.5).astype(jnp.float32)

    if train:
        # ColorJitter(0.2, 0.2), always applied at train time — reference
        # DecathlonDataModule train transform (`lightning_module.py:686-691`)
        fb = jax.random.uniform(kb, (b, 1, 1, 1), minval=0.8, maxval=1.2)
        img = jnp.clip(img * fb, 0.0, 1.0)
        fc = jax.random.uniform(kc, (b, 1, 1, 1), minval=0.8, maxval=1.2)
        m = jnp.mean(img, axis=(1, 2, 3), keepdims=True)
        img = jnp.clip(m + fc * (img - m), 0.0, 1.0)

    img = apply_hu_windows(img, hu_windows)
    mean_a = jnp.asarray(mean, jnp.float32).reshape(1, 1, 1, -1)
    std_a = jnp.asarray(std, jnp.float32).reshape(1, 1, 1, -1)
    img = ((img - mean_a) / std_a).astype(dtype)
    return img, msk


def parse_hu_windows(spec: str, value_max: float = 255.0) -> Tuple[Tuple[float, float], ...]:
    """Parse a CLI windows spec ``"L:W,L:W,…"`` (level:width in STORED value
    units — 0-255 for uint8 stores, 0-65535 for FLAG_U16) → (level, width)
    pairs on the 0..1 scale `segmentation_augment` expects."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            lv, wd = (float(t) for t in part.split(":"))
        except ValueError:
            raise ValueError(f"bad window {part!r}: expected LEVEL:WIDTH") from None
        if wd <= 0:
            raise ValueError(f"bad window {part!r}: width must be > 0")
        out.append((lv / value_max, wd / value_max))
    if not out:
        raise ValueError(f"no windows in spec {spec!r}")
    return tuple(out)


def apply_hu_windows(
    img: jax.Array,  # (..., 1) intensities on the 0..1 scale
    hu_windows: Tuple[Tuple[float, float], ...],
) -> jax.Array:
    """Stack fixed (level, width) display windows as channels: channel c is
    ``clip((x - (level_c - width_c/2)) / width_c, 0, 1)``. No-op when
    ``hu_windows`` is empty. One elementwise pass — XLA fuses it into the
    surrounding normalize."""
    if not hu_windows:
        return img
    chans = [
        jnp.clip((img - (float(lv) - float(wd) / 2.0)) / float(wd), 0.0, 1.0)
        for lv, wd in hu_windows
    ]
    return jnp.concatenate(chans, axis=-1)
