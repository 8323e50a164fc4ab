"""Segmentation training/eval task (U-Net + Dice), jit/pjit-native.

Capability parity with the reference `Segmentation(pl.LightningModule)`
(`medical_image_segmentation/train/model/segmentation.py:46-134`):

- U-Net with ResNet encoder, 1-channel input, ``n_classes`` logits;
- DiceLoss (sigmoid, flatten, smooth=1) for train;
- val/test metrics: dice + IoU at threshold 0.5;
- LARS optimizer with warmup-cosine schedule, bias/BN excluded from decay
  and adaptation (`segmentation.py:62-77`).

One jitted ``train_step`` (donated state) whose gradient
all-reduce and global BatchNorm stats come from XLA when the batch is
sharded over the mesh's ``data`` axis; no DDP/sync-BN machinery.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from medical_image_segmentation_tpu.core.struct import PyTreeNode

from medical_image_segmentation_tpu.models.unet import UNet
from medical_image_segmentation_tpu.ops.dice import dice_coefficient, dice_loss, jaccard_index, post_process_masks
from medical_image_segmentation_tpu.ops.lars import lars, make_lars_mask
from medical_image_segmentation_tpu.ops.schedules import linear_warmup_cosine_annealing


class SegState(PyTreeNode):
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any


class SegmentationTask:
    def __init__(
        self,
        arch: str = "resnet18",
        n_classes: int = 1,
        in_channels: int = 1,
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 50,
        min_lr: float = 1e-2,
        steps_per_epoch: int = 1,
        loss: str = "dice",
        dtype: Any = jnp.bfloat16,
        remat: bool = False,
    ):
        if loss not in ("dice", "dice_ce"):
            raise ValueError(f"loss must be 'dice' or 'dice_ce', got {loss!r}")
        self.loss_kind = loss
        self.model = UNet(arch=arch, n_classes=n_classes, in_channels=in_channels, dtype=dtype,
                          remat=remat)
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, eta_min=min_lr, steps_per_epoch=steps_per_epoch
        )
        self.tx = lars(
            self.schedule, weight_decay=weight_decay, momentum=momentum, mask=make_lars_mask
        )

    def init(self, rng: jax.Array, sample_shape: Tuple[int, ...]) -> SegState:
        variables = self.model.init(rng, jnp.zeros(sample_shape, jnp.float32), train=True)
        params = variables["params"]
        return SegState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=self.tx.init(params),
        )

    def _loss(self, logits: jax.Array, masks: jax.Array) -> jax.Array:
        """Dice, or Dice + sigmoid binary cross-entropy (BASELINE config #4
        "Dice+CE" fine-tune objective)."""
        loss = dice_loss(logits, masks)
        if self.loss_kind == "dice_ce":
            ce = optax.sigmoid_binary_cross_entropy(
                logits.astype(jnp.float32), masks.astype(jnp.float32)
            ).mean()
            loss = loss + ce
        return loss

    @partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: SegState, images: jax.Array, masks: jax.Array):
        def loss_fn(params):
            (logits, mutated) = self.model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                images,
                train=True,
                mutable=["batch_stats"],
            )
            return self._loss(logits, masks), mutated["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {"train/loss": loss, "lr": self.schedule(state.step)}
        return (
            state.replace(step=state.step + 1, params=new_params, batch_stats=new_bs, opt_state=new_opt),
            metrics,
        )

    @partial(jax.jit, static_argnums=0)
    def eval_step(self, state: SegState, images: jax.Array, masks: jax.Array) -> Dict[str, jax.Array]:
        logits = self.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats}, images, train=False
        )
        pred = post_process_masks(logits)
        return {
            "loss": dice_loss(logits, masks),
            "dice": dice_coefficient(pred, masks),
            "iou": jaccard_index(pred, masks),
        }

    @partial(jax.jit, static_argnums=0)
    def predict_step(self, state: SegState, images: jax.Array) -> jax.Array:
        """Binarized masks for visualization (reference `segmentation.py:130-134`)."""
        logits = self.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats}, images, train=False
        )
        return post_process_masks(logits)
