"""Paired volumetric augmentation (device-side, jit-native).

3D analogue of `ops/augment.py::segmentation_augment` for the volumetric
path (the reference has no 3D pipeline — it slices volumes to 2D PNGs,
`slice_medical_decathlon_scans.py:55-83`; this module is the beyond-parity
replacement). All ops are static-shape jnp: per-sample random
crops are ``lax.dynamic_slice`` under ``vmap`` (no gathers), flips are
``jnp.flip``-vs-identity selects shared between image and mask, intensity
jitter (brightness/contrast, the 2D recipe's ColorJitter(0.2, 0.2)) touches
the image only, and normalization uses dataset stats on the 0-1 scale.

Train: random crop to ``out_size`` + random flips along each spatial axis.
Eval: center crop, no flips, no jitter.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _crop_offsets(key, b, in_dims, out_dims, train: bool):
    """Per-sample crop origins: uniform at train, centered at eval."""
    offs = []
    for ax, (i, o) in enumerate(zip(in_dims, out_dims)):
        if i < o:
            raise ValueError(f"volume dim {ax} ({i}) smaller than crop ({o}); pad on host")
        if train and i > o:
            k = jax.random.fold_in(key, ax)
            offs.append(jax.random.randint(k, (b,), 0, i - o + 1))
        else:
            offs.append(jnp.full((b,), (i - o) // 2, jnp.int32))
    return jnp.stack(offs, axis=-1)  # (B, 3)


@partial(jax.jit, static_argnames=("out_size", "mean", "std", "train", "value_scale",
                                   "dtype", "hu_windows"))
def segmentation_augment_3d(
    rng: jax.Array,
    vols: jax.Array,            # (B, D, H, W, 1) float 0..1 (or scaled by value_scale)
    masks: jax.Array,           # (B, D, H, W, 1) binary
    out_size: Tuple[int, int, int] = (64, 64, 64),
    mean: Tuple[float, ...] = (0.2089,),
    std: Tuple[float, ...] = (0.2109,),
    train: bool = True,
    value_scale: float = 1.0,
    dtype=jnp.bfloat16,
    hu_windows: Tuple[Tuple[float, float], ...] = (),
):
    """``hu_windows``: optional fixed (level, width) display windows on the
    0..1 intensity scale, stacked as input CHANNELS (see
    ops/augment.py::apply_hu_windows — the 'view it like a radiologist'
    representation, most valuable on volumetric CT). Deterministic at train
    and eval; a single-entry mean/std broadcasts across window channels."""
    b = vols.shape[0]
    in_dims = vols.shape[1:4]
    od, oh, ow = out_size
    kcrop, kflip, kb, kc = jax.random.split(rng, 4)

    offs = _crop_offsets(kcrop, b, in_dims, out_size, train)

    def crop(v, o):
        return lax.dynamic_slice(v, (o[0], o[1], o[2], 0), (od, oh, ow, v.shape[-1]))

    img = jax.vmap(crop)(vols, offs).astype(jnp.float32) * value_scale
    msk = jax.vmap(crop)(masks, offs).astype(jnp.float32)
    msk = (msk > 0.5).astype(jnp.float32)

    if train:
        # paired flips along D/H/W — one shared coin per sample per axis
        flips = jax.random.uniform(kflip, (b, 3)) < 0.5
        for ax in range(3):
            f = flips[:, ax].reshape(b, 1, 1, 1, 1)
            img = jnp.where(f, jnp.flip(img, axis=ax + 1), img)
            msk = jnp.where(f, jnp.flip(msk, axis=ax + 1), msk)
        # intensity jitter, image only (2D recipe's ColorJitter(0.2, 0.2))
        fb = jax.random.uniform(kb, (b, 1, 1, 1, 1), minval=0.8, maxval=1.2)
        img = jnp.clip(img * fb, 0.0, 1.0)
        fc = jax.random.uniform(kc, (b, 1, 1, 1, 1), minval=0.8, maxval=1.2)
        m = jnp.mean(img, axis=(1, 2, 3, 4), keepdims=True)
        img = jnp.clip(m + fc * (img - m), 0.0, 1.0)

    if hu_windows:
        from medical_image_segmentation_tpu.ops.augment import apply_hu_windows

        img = apply_hu_windows(img, hu_windows)
    mean_a = jnp.asarray(mean, jnp.float32).reshape(1, 1, 1, 1, -1)
    std_a = jnp.asarray(std, jnp.float32).reshape(1, 1, 1, 1, -1)
    img = ((img - mean_a) / std_a).astype(dtype)
    return img, msk


def _byol_view_3d(key, vols, out_size, mean, std, value_scale, dtype):
    """One augmented view: random crop + flips + intensity jitter + normalize."""
    b = vols.shape[0]
    od, oh, ow = out_size
    kcrop, kflip, kb, kc = jax.random.split(key, 4)
    offs = _crop_offsets(kcrop, b, vols.shape[1:4], out_size, train=True)

    def crop(v, o):
        return lax.dynamic_slice(v, (o[0], o[1], o[2], 0), (od, oh, ow, v.shape[-1]))

    img = jax.vmap(crop)(vols, offs).astype(jnp.float32) * value_scale
    flips = jax.random.uniform(kflip, (b, 3)) < 0.5
    for ax in range(3):
        f = flips[:, ax].reshape(b, 1, 1, 1, 1)
        img = jnp.where(f, jnp.flip(img, axis=ax + 1), img)
    fb = jax.random.uniform(kb, (b, 1, 1, 1, 1), minval=0.8, maxval=1.2)
    img = jnp.clip(img * fb, 0.0, 1.0)
    fc = jax.random.uniform(kc, (b, 1, 1, 1, 1), minval=0.8, maxval=1.2)
    m = jnp.mean(img, axis=(1, 2, 3, 4), keepdims=True)
    img = jnp.clip(m + fc * (img - m), 0.0, 1.0)
    mean_a = jnp.asarray(mean, jnp.float32).reshape(1, 1, 1, 1, -1)
    std_a = jnp.asarray(std, jnp.float32).reshape(1, 1, 1, 1, -1)
    return ((img - mean_a) / std_a).astype(dtype)


@partial(jax.jit, static_argnames=("out_size", "mean", "std", "value_scale", "dtype"))
def byol_two_view_augment_3d(
    rng: jax.Array,
    vols: jax.Array,            # (B, D, H, W, 1) float 0..1 (× value_scale)
    out_size: Tuple[int, int, int] = (32, 64, 64),
    mean: Tuple[float, ...] = (0.2089,),
    std: Tuple[float, ...] = (0.2109,),
    value_scale: float = 1.0,
    dtype=jnp.bfloat16,
):
    """Two independent augmented views per volume for volumetric BYOL —
    the 3D analogue of the 2D two-view pipeline (random sub-volume crop
    replaces RandomResizedCrop; flips along each axis; intensity jitter)."""
    k1, k2 = jax.random.split(rng)
    v1 = _byol_view_3d(k1, vols, out_size, mean, std, value_scale, dtype)
    v2 = _byol_view_3d(k2, vols, out_size, mean, std, value_scale, dtype)
    return v1, v2
