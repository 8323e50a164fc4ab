"""Projection / prediction MLP head.

Matches the reference `MLP` (`medical_image_segmentation/train/model/
byol_pytorch.py:27-44`): Linear → BatchNorm1d → ReLU → Linear.
BatchNorm statistics are batch-global under pjit (sync-BN for free).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from medical_image_segmentation_tpu.models import nn


class MLP(nn.Module):
    hidden_dim: int = 4096
    out_dim: int = 256
    dtype: Any = jnp.bfloat16

    def __call__(self, x, train: bool = True):
        x = x.astype(self.dtype)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype, param_dtype=jnp.float32)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=self.dtype, param_dtype=jnp.float32)(x)
        x = nn.relu(x)
        x = nn.Dense(self.out_dim, dtype=self.dtype, param_dtype=jnp.float32)(x)
        return x.astype(jnp.float32)
