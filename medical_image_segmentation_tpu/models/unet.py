"""U-Net with a ResNet encoder (models/nn.py modules, NHWC).

Capability parity with `smp.Unet(encoder_name=arch, encoder_weights=None,
in_channels=1, classes=n)` as used by the reference segmentation learner
(`medical_image_segmentation/train/model/segmentation.py:52-57`):

- encoder: any arch from ``RESNET_CONFIGS`` (default resnet18), 1-channel;
- decoder: 5 blocks with channels (256,128,64,32,16); each block is
  nearest-neighbor 2× upsample → concat skip → [Conv3x3 + BN + ReLU] × 2
  (smp's ``DecoderBlock`` with ``use_batchnorm=True``);
- head: 3×3 conv to ``n_classes`` logits (no activation — Dice loss applies
  the sigmoid, reference `segmentation.py:12-24`).

Notes: NHWC, bf16 activations, logits in float32. Nearest upsample is a
reshape-broadcast (no gather), which XLA fuses with the following conv.
The encoder subtree is named ``encoder`` so an SSL-pretrained backbone can
be restored into it directly (the handoff the reference left unwired —
SURVEY §5.4).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Sequence

import jax.numpy as jnp

from medical_image_segmentation_tpu.models import nn
from medical_image_segmentation_tpu.models.resnet import RESNET_CONFIGS, ResNet, conv_kernel_init


def nearest_upsample(x, factor: int = 2):
    """NHWC nearest-neighbor upsample via broadcast (gather-free, fusible)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :]
    x = jnp.broadcast_to(x, (b, h, factor, w, factor, c))
    return x.reshape(b, h * factor, w * factor, c)


class DecoderBlock(nn.Module):
    filters: int
    dtype: Any = jnp.bfloat16

    def __call__(self, x, skip=None, train: bool = True):
        conv = partial(
            nn.Conv, use_bias=False, dtype=self.dtype, param_dtype=jnp.float32, kernel_init=conv_kernel_init
        )
        norm = partial(
            nn.BatchNorm, use_running_average=not train, momentum=0.9, dtype=self.dtype, param_dtype=jnp.float32
        )
        x = nearest_upsample(x, 2)
        if skip is not None:
            x = jnp.concatenate([x, skip.astype(x.dtype)], axis=-1)
        x = conv(self.filters, (3, 3), padding=1)(x)
        x = norm()(x)
        x = nn.relu(x)
        x = conv(self.filters, (3, 3), padding=1)(x)
        x = norm()(x)
        x = nn.relu(x)
        return x


class UNet(nn.Module):
    arch: str = "resnet18"
    n_classes: int = 1
    in_channels: int = 1
    decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)
    dtype: Any = jnp.bfloat16
    remat: bool = False

    def __call__(self, x, train: bool = True):
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(
                f"U-Net input H/W must be divisible by 32 (5 down/upsample stages); got {h}x{w}. "
                f"Resize or pad the batch (e.g. segmentation_augment out_size)."
            )
        block_cls, stages, expansion = RESNET_CONFIGS[self.arch]
        encoder = ResNet(
            block_cls=block_cls,
            stage_sizes=stages,
            expansion=expansion,
            in_channels=self.in_channels,
            low_res=False,
            dtype=self.dtype,
            remat=self.remat,
            name="encoder",
        )
        # pyramid: [stride2 (stem), stride4, stride8, stride16, stride32]
        pyramid = encoder(x, train=train, return_pyramid=True)
        feats = pyramid[::-1]  # deepest first
        y = feats[0]
        skips = feats[1:] + [None]  # stride16, 8, 4, 2, then no skip at stride1
        for filters, skip in zip(self.decoder_channels, skips):
            y = DecoderBlock(filters=filters, dtype=self.dtype)(y, skip, train=train)
        logits = nn.Conv(self.n_classes, (3, 3), padding=1, dtype=self.dtype, param_dtype=jnp.float32, name="head")(y)
        return logits.astype(jnp.float32)
