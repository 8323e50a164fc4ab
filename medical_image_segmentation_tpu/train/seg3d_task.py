"""Volumetric segmentation task (3D U-Net + Dice), jit/pjit-native.

Beyond-reference capability: the reference trains only on 2D slices
(`medical_image_segmentation/train/train_segmentation.py` over PNGs from
`slice_medical_decathlon_scans.py`). This task trains directly on Medical
Decathlon volumes with the same loss/metric semantics as the 2D path
(`ops/dice.py` is shape-agnostic: sigmoid, flatten-all, smooth=1.0,
threshold 0.5) and the same LARS + warmup-cosine optimization
(`segmentation.py:62-77` semantics).

One jitted ``train_step`` (donated state). Under a
("data","space") mesh, volumes shard over batch AND depth
(`parallel/mesh.py::spatial_sharding(ndim=5)`) — XLA GSPMD inserts the 3D
conv halo exchanges; gradient all-reduce comes from the sharding alone.
GroupNorm (default) has no cross-sample statistics, so spatial sharding
changes nothing semantically; ``norm="batch"`` syncs via sharded reductions
like the 2D tasks.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

from medical_image_segmentation_tpu.core.struct import PyTreeNode

from medical_image_segmentation_tpu.models.unet3d import UNet3D
from medical_image_segmentation_tpu.ops.dice import dice_coefficient, dice_loss, jaccard_index, post_process_masks
from medical_image_segmentation_tpu.ops.lars import lars, make_lars_mask
from medical_image_segmentation_tpu.ops.schedules import linear_warmup_cosine_annealing


class Seg3DState(PyTreeNode):
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any


class Segmentation3DTask:
    def __init__(
        self,
        n_classes: int = 1,
        in_channels: int = 1,
        features: Sequence[int] = (32, 64, 128, 256),
        norm: str = "group",
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
        self.model = UNet3D(
            n_classes=n_classes, in_channels=in_channels, features=tuple(features),
            norm=norm, dtype=dtype, remat=remat,
        )
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, eta_min=min_lr, steps_per_epoch=steps_per_epoch
        )
        self.tx = lars(
            self.schedule, weight_decay=weight_decay, momentum=momentum, mask=make_lars_mask
        )

    def init(self, rng: jax.Array, sample_shape: Tuple[int, ...]) -> Seg3DState:
        variables = self.model.init(rng, jnp.zeros(sample_shape, jnp.float32), train=True)
        params = variables["params"]
        return Seg3DState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=self.tx.init(params),
        )

    def _apply(self, params, batch_stats, vols, train: bool, mutable):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        return self.model.apply(variables, vols, train=train, mutable=mutable)

    def _loss(self, logits: jax.Array, masks: jax.Array) -> jax.Array:
        loss = dice_loss(logits, masks)
        if self.loss_kind == "dice_ce":
            ce = optax.sigmoid_binary_cross_entropy(
                logits.astype(jnp.float32), masks.astype(jnp.float32)
            ).mean()
            loss = loss + ce
        return loss

    @partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: Seg3DState, vols: jax.Array, masks: jax.Array):
        has_bn = bool(state.batch_stats)

        def loss_fn(params):
            if has_bn:
                logits, mutated = self._apply(params, state.batch_stats, vols, True, ["batch_stats"])
                new_bs = mutated["batch_stats"]
            else:
                logits = self._apply(params, {}, vols, True, False)
                new_bs = state.batch_stats
            return self._loss(logits, masks), new_bs

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {"train/loss": loss, "lr": self.schedule(state.step)}
        return (
            state.replace(step=state.step + 1, params=new_params, batch_stats=new_bs, opt_state=new_opt),
            metrics,
        )

    @partial(jax.jit, static_argnums=0)
    def eval_step(self, state: Seg3DState, vols: jax.Array, masks: jax.Array) -> Dict[str, jax.Array]:
        logits = self._apply(state.params, state.batch_stats, vols, False, False)
        pred = post_process_masks(logits)
        return {
            "loss": dice_loss(logits, masks),
            "dice": dice_coefficient(pred, masks),
            "iou": jaccard_index(pred, masks),
        }

    @partial(jax.jit, static_argnums=0)
    def predict_step(self, state: Seg3DState, vols: jax.Array) -> jax.Array:
        logits = self._apply(state.params, state.batch_stats, vols, False, False)
        return post_process_masks(logits)
