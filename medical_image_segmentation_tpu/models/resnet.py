"""ResNet encoder family (models/nn.py modules, NHWC, bf16-friendly).

Capability parity with the reference's torchvision backbone usage
(`medical_image_segmentation/train/model/byol_pytorch.py:54-82`):

- arch selected by name ("resnet18"/"34"/"50"/"101"/"152");
- **low-res stem surgery**: 3×3 stride-1 conv and no max-pool (CIFAR-style),
  reference `byol_pytorch.py:58-69`;
- **grayscale stem surgery**: 1-channel input 7×7 stride-2 conv, reference
  `byol_pytorch.py:71-82`;
- Kaiming (fan_out) init of the surgically replaced conv — we use it for all
  convs, matching torchvision's default init.

Design notes:
- NHWC layout (channels last, the layout cuDNN's tensor-core convolutions
  prefer; avoids transposes).
- ``dtype`` controls compute/activation dtype (default bfloat16 for
  tensor-core throughput); parameters are kept in float32 (``param_dtype``).
- BatchNorm uses float32 statistics. Under ``jit`` with the batch sharded
  over a ``data`` mesh axis, the batch-mean/var reductions are global, so
  XLA inserts the cross-replica psum automatically — this *is* the
  reference's ``sync_batchnorm=True`` (`train_ssl.py:82`), with zero extra
  code.
- ``feature_maps`` exposes the stride-2..32 pyramid for the U-Net decoder.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Sequence

import jax.numpy as jnp

from medical_image_segmentation_tpu.models import nn

ModuleDef = Any

# Kaiming normal, fan_out, ReLU gain — torchvision resnet's conv init.
conv_kernel_init = nn.initializers.variance_scaling(2.0, "fan_out", "normal")


class BasicBlock(nn.Module):
    filters: int
    strides: int = 1
    conv: ModuleDef = nn.Conv
    norm: ModuleDef = nn.BatchNorm

    def __call__(self, x):
        residual = x
        y = self.conv(self.filters, (3, 3), strides=(self.strides, self.strides), padding=1)(x)
        y = self.norm()(y)
        y = nn.relu(y)
        y = self.conv(self.filters, (3, 3), padding=1)(y)
        y = self.norm()(y)
        if residual.shape != y.shape:
            residual = self.conv(self.filters, (1, 1), strides=(self.strides, self.strides), name="downsample_conv")(x)
            residual = self.norm(name="downsample_bn")(residual)
        return nn.relu(y + residual)


class Bottleneck(nn.Module):
    """Bottleneck with torchvision's groups/base_width semantics
    (enables resnext50_32x4d and wide_resnet50_2 by name)."""

    filters: int
    strides: int = 1
    conv: ModuleDef = nn.Conv
    norm: ModuleDef = nn.BatchNorm
    expansion: int = 4
    groups: int = 1
    base_width: int = 64

    def __call__(self, x):
        residual = x
        width = int(self.filters * (self.base_width / 64.0)) * self.groups
        y = self.conv(width, (1, 1))(x)
        y = self.norm()(y)
        y = nn.relu(y)
        y = self.conv(width, (3, 3), strides=(self.strides, self.strides), padding=1,
                      feature_group_count=self.groups)(y)
        y = self.norm()(y)
        y = nn.relu(y)
        out_ch = self.filters * self.expansion
        y = self.conv(out_ch, (1, 1))(y)
        y = self.norm()(y)
        if residual.shape != y.shape:
            residual = self.conv(out_ch, (1, 1), strides=(self.strides, self.strides), name="downsample_conv")(x)
            residual = self.norm(name="downsample_bn")(residual)
        return nn.relu(y + residual)


from functools import partial as _partial

RESNET_CONFIGS = {
    # name: (block_cls, stage_sizes, expansion) — torchvision naming
    # (`byol_pytorch.py:54` instantiates by models.__dict__[arch])
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 4),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 4),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 4),
    "resnext50_32x4d": (_partial(Bottleneck, groups=32, base_width=4), (3, 4, 6, 3), 4),
    "resnext101_32x8d": (_partial(Bottleneck, groups=32, base_width=8), (3, 4, 23, 3), 4),
    "wide_resnet50_2": (_partial(Bottleneck, base_width=128), (3, 4, 6, 3), 4),
    "wide_resnet101_2": (_partial(Bottleneck, base_width=128), (3, 4, 23, 3), 4),
}


class ResNet(nn.Module):
    """ResNet backbone returning either pooled features or the skip pyramid.

    Attributes
    ----------
    block_cls / stage_sizes / expansion : from ``RESNET_CONFIGS``.
    in_channels : input channel count (1 for grayscale medical images).
    low_res : CIFAR-style stem (3×3 s1 conv, no max-pool), reference
        `byol_pytorch.py:58-69`.
    dtype : activation/compute dtype (bfloat16 by default).
    """

    block_cls: Callable = BasicBlock
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    expansion: int = 1
    in_channels: int = 3
    low_res: bool = False
    dtype: Any = jnp.bfloat16
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    remat: bool = False  # checkpoint each residual block: trades ~1/3 more
    # FLOPs in bwd for O(depth) less activation memory — lets resnet101/152
    # and large batches fit one chip (SURVEY "hard parts": EMA + two towers)

    @property
    def feature_dim(self) -> int:
        return 512 * self.expansion

    def __call__(self, x, train: bool = True, return_pyramid: bool = False):
        conv = partial(
            nn.Conv, use_bias=False, dtype=self.dtype, param_dtype=jnp.float32, kernel_init=conv_kernel_init
        )
        norm = partial(
            nn.BatchNorm,
            use_running_average=not train,
            momentum=self.bn_momentum,
            epsilon=self.bn_epsilon,
            dtype=self.dtype,
            param_dtype=jnp.float32,
        )

        x = x.astype(self.dtype)
        pyramid = []
        if self.low_res:
            x = conv(64, (3, 3), padding=1, name="conv1")(x)
            x = norm(name="bn1")(x)
            x = nn.relu(x)
            pyramid.append(x)  # stride 1
        else:
            x = conv(64, (7, 7), strides=(2, 2), padding=3, name="conv1")(x)
            x = norm(name="bn1")(x)
            x = nn.relu(x)
            pyramid.append(x)  # stride 2
            x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))

        block_cls = nn.remat(self.block_cls) if self.remat else self.block_cls
        for i, (n_blocks, filters) in enumerate(zip(self.stage_sizes, (64, 128, 256, 512))):
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                x = block_cls(filters=filters, strides=strides, conv=conv, norm=norm, name=f"layer{i+1}_{j}")(x)
            pyramid.append(x)  # strides 4, 8, 16, 32 (or 1,2,4,8 low_res)

        if return_pyramid:
            return pyramid
        x = jnp.mean(x, axis=(1, 2))  # global average pool
        return x.astype(jnp.float32)


def make_resnet(arch: str, in_channels: int = 3, low_res: bool = False,
                dtype: Any = jnp.bfloat16, remat: bool = False) -> ResNet:
    """Build a ResNet by torchvision-style name (reference `byol_pytorch.py:54`)."""
    if arch not in RESNET_CONFIGS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(RESNET_CONFIGS)}")
    block_cls, stages, expansion = RESNET_CONFIGS[arch]
    return ResNet(
        block_cls=block_cls,
        stage_sizes=stages,
        expansion=expansion,
        in_channels=in_channels,
        low_res=low_res,
        dtype=dtype,
        remat=remat,
    )
