"""Dice loss and segmentation metrics.

Semantics match the reference implementation
(`medical_image_segmentation/train/model/segmentation.py:12-43`):

- ``dice_loss``: sigmoid on logits, flatten everything (whole batch pooled
  into one Dice score, not per-sample), smooth=1.0 in both numerator and
  denominator, loss = 1 - dice.
- ``post_process_masks``: sigmoid > 0.5 hard threshold.
- ``dice_coefficient`` / ``jaccard_index``: computed on already-binarized
  masks, flattened over the whole batch, smooth=1.0 / 1e-6 respectively.

All functions are pure jnp and safe under jit/vmap/grad. Reductions are
performed in float32 regardless of input dtype so bf16 activations do not
lose mass in the sums (the reductions fuse with the elementwise sigmoid
in XLA).
"""

from __future__ import annotations

import jax.numpy as jnp
import jax


def dice_loss(logits: jax.Array, targets: jax.Array, smooth: float = 1.0) -> jax.Array:
    """Soft Dice loss over the flattened batch.

    Parameters
    ----------
    logits : raw (pre-sigmoid) predictions, any shape.
    targets : binary ground-truth masks, same shape.
    smooth : additive smoothing (reference uses 1.0).
    """
    probs = jax.nn.sigmoid(logits.astype(jnp.float32)).reshape(-1)
    targets = targets.astype(jnp.float32).reshape(-1)
    intersection = jnp.sum(probs * targets)
    denom = jnp.sum(probs) + jnp.sum(targets)
    dice = (2.0 * intersection + smooth) / (denom + smooth)
    return 1.0 - dice


def post_process_masks(logits: jax.Array, threshold: float = 0.5) -> jax.Array:
    """Binarize logits: sigmoid(logits) > threshold, as float32."""
    return (jax.nn.sigmoid(logits.astype(jnp.float32)) > threshold).astype(jnp.float32)


def dice_coefficient(pred_masks: jax.Array, targets: jax.Array, smooth: float = 1.0) -> jax.Array:
    """Hard Dice coefficient over the flattened batch (binarized inputs)."""
    p = pred_masks.astype(jnp.float32).reshape(-1)
    t = targets.astype(jnp.float32).reshape(-1)
    intersection = jnp.sum(p * t)
    return (2.0 * intersection + smooth) / (jnp.sum(p) + jnp.sum(t) + smooth)


def jaccard_index(pred_masks: jax.Array, targets: jax.Array, smooth: float = 1e-6) -> jax.Array:
    """Hard IoU over the flattened batch (binarized inputs)."""
    p = pred_masks.astype(jnp.float32).reshape(-1)
    t = targets.astype(jnp.float32).reshape(-1)
    intersection = jnp.sum(p * t)
    union = jnp.sum(p) + jnp.sum(t) - intersection
    return (intersection + smooth) / (union + smooth)
