"""Volumetric 3D U-Net (models/nn.py modules, NDHWC) — beyond-reference capability.

The reference pipeline is strictly 2D: Medical Decathlon volumes are sliced
to PNGs (`medical_image_segmentation/analyze_data/slice_medical_decathlon_scans.py:55-83`)
because its FFCV/torchvision input path and `smp.Unet` are 2D-only. Here
the formulation is volumetric: XLA hands the 3D convolutions to cuDNN, and
large volumes shard over the mesh's
``space`` axis with GSPMD-inserted halo exchanges (`parallel/mesh.py::
spatial_sharding(ndim=5)`), so no slicing is ever required.

Architecture (the standard Çiçek et al. 3D U-Net shape):

- encoder: ``len(features)`` stages of [Conv3³ + Norm + ReLU] × 2, each
  followed by stride-2 3³ conv downsampling (except the last/bottleneck);
- decoder: mirror stages of nearest 2× upsample → concat skip → double conv;
- head: 1³ conv to ``n_classes`` logits in float32 (Dice applies the
  sigmoid, same semantics as 2D — `ops/dice.py`).

Norm: GroupNorm by default — volumetric batches are small (2-8), where
BatchNorm statistics collapse; ``norm="batch"`` is available for parity
experiments and syncs across shards by sharding alone like the rest of the
framework. Activations bf16, params/logits f32, optional per-block remat.

Input must be (B, D, H, W, C) with D/H/W divisible by 2^(len(features)-1).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Sequence

import jax.numpy as jnp

from medical_image_segmentation_tpu.models import nn
from medical_image_segmentation_tpu.models.resnet import conv_kernel_init


def nearest_upsample_3d(x, factor: int = 2):
    """NDHWC nearest-neighbor upsample via broadcast (gather-free, fusible)."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :]
    x = jnp.broadcast_to(x, (b, d, factor, h, factor, w, factor, c))
    return x.reshape(b, d * factor, h * factor, w * factor, c)


class ConvBlock3D(nn.Module):
    """[Conv3³ + Norm + ReLU] × 2."""

    filters: int
    norm: str = "group"
    groups: int = 8
    dtype: Any = jnp.bfloat16

    def __call__(self, x, train: bool = True):
        conv = partial(
            nn.Conv, use_bias=False, dtype=self.dtype, param_dtype=jnp.float32,
            kernel_init=conv_kernel_init,
        )
        for _ in range(2):
            x = conv(self.filters, (3, 3, 3), padding=1)(x)
            if self.norm == "batch":
                x = nn.BatchNorm(
                    use_running_average=not train, momentum=0.9,
                    dtype=self.dtype, param_dtype=jnp.float32,
                )(x)
            else:
                g = min(self.groups, self.filters)
                x = nn.GroupNorm(num_groups=g, dtype=self.dtype, param_dtype=jnp.float32)(x)
            x = nn.relu(x)
        return x


class UNet3DEncoder(nn.Module):
    """The encoder half of ``UNet3D`` as a standalone backbone for
    volumetric BYOL pretraining. Block/downsample names (``enc{i}``,
    ``down{i}``) match UNet3D exactly, so a pretrained encoder grafts into
    a UNet3D's parameter tree by subtree copy
    (`core/checkpoint.py::load_byol3d_encoder_into_unet3d`) — the 3D
    analogue of the SSL→segmentation handoff.

    Returns globally average-pooled bottleneck features (B, features[-1])."""

    in_channels: int = 1
    features: Sequence[int] = (32, 64, 128, 256)
    norm: str = "group"
    dtype: Any = jnp.bfloat16
    remat: bool = False

    def __call__(self, x, train: bool = True):
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got shape {x.shape}")
        block_cls = ConvBlock3D
        if self.remat:
            block_cls = nn.remat(ConvBlock3D)
        x = x.astype(self.dtype)
        for i, f in enumerate(self.features):
            x = block_cls(f, norm=self.norm, dtype=self.dtype, name=f"enc{i}")(x, train)
            if i < len(self.features) - 1:
                x = nn.Conv(
                    f, (3, 3, 3), strides=(2, 2, 2), padding=1, use_bias=False,
                    dtype=self.dtype, param_dtype=jnp.float32,
                    kernel_init=conv_kernel_init, name=f"down{i}",
                )(x)
        return jnp.mean(x.astype(jnp.float32), axis=(1, 2, 3))


class UNet3D(nn.Module):
    n_classes: int = 1
    in_channels: int = 1
    features: Sequence[int] = (32, 64, 128, 256)
    norm: str = "group"
    dtype: Any = jnp.bfloat16
    remat: bool = False

    def __call__(self, x, train: bool = True):
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got shape {x.shape}")
        stride = 2 ** (len(self.features) - 1)
        d, h, w = x.shape[1], x.shape[2], x.shape[3]
        if d % stride or h % stride or w % stride:
            raise ValueError(
                f"UNet3D input D/H/W must be divisible by {stride} "
                f"({len(self.features) - 1} down/upsample stages); got {d}x{h}x{w}."
            )
        block_cls = ConvBlock3D
        if self.remat:
            block_cls = nn.remat(ConvBlock3D)

        x = x.astype(self.dtype)
        skips = []
        for i, f in enumerate(self.features):
            x = block_cls(f, norm=self.norm, dtype=self.dtype, name=f"enc{i}")(x, train)
            if i < len(self.features) - 1:
                skips.append(x)
                x = nn.Conv(
                    f, (3, 3, 3), strides=(2, 2, 2), padding=1, use_bias=False,
                    dtype=self.dtype, param_dtype=jnp.float32,
                    kernel_init=conv_kernel_init, name=f"down{i}",
                )(x)

        for i, f in enumerate(reversed(self.features[:-1])):
            x = nearest_upsample_3d(x, 2)
            skip = skips[-(i + 1)]
            x = jnp.concatenate([x, skip.astype(x.dtype)], axis=-1)
            x = block_cls(f, norm=self.norm, dtype=self.dtype, name=f"dec{i}")(x, train)

        logits = nn.Conv(
            self.n_classes, (1, 1, 1), use_bias=True, dtype=jnp.float32,
            param_dtype=jnp.float32, name="head",
        )(x.astype(jnp.float32))
        return logits
