"""BYOL network modules.

Capability parity with the reference `BYOL(pl.LightningModule)` construction
(`medical_image_segmentation/train/model/byol_pytorch.py:93-129`):

- ``Encoder`` = ResNet backbone (fc removed — we never create one) +
  projection `MLP` (reference `Encoder`, `byol_pytorch.py:47-90`), with
  low-res / grayscale stem surgery flags.
- ``BYOLNet`` = online encoder + predictor MLP + linear probe trained on
  stop-gradiented backbone features (the reference computes this probe's
  logits at `byol_pytorch.py:218-221`; we wire its loss in, fixing the
  reference's dead code — SURVEY §"known bugs").

The momentum ("target") branch is *not* a module copy: the training task
keeps a second param/batch-stats tree for the same ``Encoder`` definition
and EMA-updates it (`train/byol_task.py`), applying this module with those
variables. That keeps one set of code paths under jit and makes the EMA a
pure pytree op XLA can fuse.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from medical_image_segmentation_tpu.models import nn
from medical_image_segmentation_tpu.models.mlp import MLP
from medical_image_segmentation_tpu.models.resnet import make_resnet


class Encoder(nn.Module):
    """Backbone + projector. ``return_embedding=True`` gives pooled backbone
    features (for KNN / linear probes), else the projection z.

    ``volumetric=True`` swaps the ResNet for a ``UNet3DEncoder`` backbone
    (inputs become (B, D, H, W, C)); everything downstream — projector,
    predictor, probe, EMA, LARS — is shape-agnostic and unchanged."""

    arch: str = "resnet18"
    in_channels: int = 3
    low_res: bool = False
    hidden_dim: int = 4096
    proj_dim: int = 256
    dtype: Any = jnp.bfloat16
    remat: bool = False
    volumetric: bool = False
    features3d: Any = (32, 64, 128, 256)

    def __call__(self, x, train: bool = True, return_embedding: bool = False):
        if self.volumetric:
            from medical_image_segmentation_tpu.models.unet3d import UNet3DEncoder

            backbone = UNet3DEncoder(in_channels=self.in_channels,
                                     features=tuple(self.features3d),
                                     dtype=self.dtype, remat=self.remat)
        else:
            backbone = make_resnet(self.arch, in_channels=self.in_channels, low_res=self.low_res,
                                   dtype=self.dtype, remat=self.remat)
        feats = backbone(x, train=train)
        if return_embedding:
            return feats
        z = MLP(hidden_dim=self.hidden_dim, out_dim=self.proj_dim, dtype=self.dtype, name="projector")(
            feats, train=train
        )
        return z, feats


class BYOLNet(nn.Module):
    """Online side of BYOL: encoder + predictor + (stop-grad) linear probe."""

    arch: str = "resnet18"
    in_channels: int = 3
    low_res: bool = False
    hidden_dim: int = 4096
    proj_dim: int = 256
    num_classes: int = 10
    dtype: Any = jnp.bfloat16
    remat: bool = False
    volumetric: bool = False
    features3d: Any = (32, 64, 128, 256)

    def setup(self):
        self.encoder = Encoder(
            arch=self.arch,
            in_channels=self.in_channels,
            low_res=self.low_res,
            hidden_dim=self.hidden_dim,
            proj_dim=self.proj_dim,
            dtype=self.dtype,
            remat=self.remat,
            volumetric=self.volumetric,
            features3d=self.features3d,
        )
        self.predictor = MLP(hidden_dim=self.hidden_dim, out_dim=self.proj_dim, dtype=self.dtype)
        self.probe = nn.Dense(self.num_classes, param_dtype=jnp.float32)

    def __call__(self, x, train: bool = True):
        """Online forward: predictions p, projections z, backbone feats,
        probe logits (on stop-grad feats so the probe never trains the
        backbone — reference `byol_pytorch.py:218-221`)."""
        z, feats = self.encoder(x, train=train)
        p = self.predictor(z, train=train)
        probe_logits = self.probe(jax.lax.stop_gradient(feats))
        return p, z, feats, probe_logits

    def embed(self, x, train: bool = False):
        """Pooled backbone features (KNN feature bank / linear eval)."""
        return self.encoder(x, train=train, return_embedding=True)

    def classify(self, x, train: bool = False):
        """Probe logits for validation top-1/top-5
        (reference `byol_pytorch.py:298-317`)."""
        feats = self.encoder(x, train=train, return_embedding=True)
        return self.probe(feats)
