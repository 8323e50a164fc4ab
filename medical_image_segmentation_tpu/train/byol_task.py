"""BYOL self-supervised pretraining task, jit/pjit-native.

Capability parity with the reference `BYOL(pl.LightningModule)`
(`medical_image_segmentation/train/model/byol_pytorch.py:93-328`):

- online network (backbone + projector + predictor) and a momentum
  ("target") encoder initialized as a copy of the online encoder
  (`byol_pytorch.py:131-138`);
- symmetric loss via the concat trick: both views go through the online
  net in one batch; the momentum branch sees the views in *reversed*
  order, so a single ``2 - 2·cos`` covers both pairings
  (`byol_pytorch.py:200-217`);
- EMA update of the momentum encoder after every step with a cosine
  momentum schedule base→1.0 (`byol_pytorch.py:253-263`);
- LARS + linear-warmup cosine LR, bias/BN excluded (`byol_pytorch.py:140-175`);
- linear probe on stop-gradient features, trained jointly with CE — the
  reference computes these logits but its probe loss is dead code
  (`byol_pytorch.py:218-221,250`); we wire it (weight ``probe_loss_weight``)
  so val top-1/top-5 (`byol_pytorch.py:298-317`) is meaningful;
- validation top-1/top-5 through the probe.

Design:
- The momentum encoder is a *second variable tree for the same Encoder
  module* — the EMA is a pure pytree lerp fused by XLA, no module copies.
- Everything (fwd, bwd, LARS, EMA) is one jitted step with donated state.
- With the two views sharded over the ``data`` mesh axis, XLA emits the
  gradient psum (DDP replacement) and global BN statistics
  (sync_batchnorm replacement) automatically.
- bf16 activations; f32 params, loss, and norms.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from medical_image_segmentation_tpu.core.struct import PyTreeNode

from medical_image_segmentation_tpu.models.byol import BYOLNet, Encoder
from medical_image_segmentation_tpu.ops.byol_loss import cosine_similarity_loss
from medical_image_segmentation_tpu.ops.lars import lars, make_lars_mask
from medical_image_segmentation_tpu.ops.schedules import cosine_ema_momentum, linear_warmup_cosine_annealing


class BYOLState(PyTreeNode):
    step: jax.Array
    params: Any          # BYOLNet params (encoder + predictor + probe)
    batch_stats: Any     # BYOLNet batch stats
    target_params: Any   # momentum Encoder params
    target_batch_stats: Any
    opt_state: Any


class BYOLTask:
    def __init__(
        self,
        arch: str = "resnet18",
        in_channels: int = 3,
        low_res: bool = False,
        hidden_dim: int = 4096,
        proj_dim: int = 256,
        num_classes: int = 10,
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 100,
        base_ema_momentum: float = 0.99,
        final_ema_momentum: float = 1.0,
        total_steps: int = 10000,
        steps_per_epoch: int = 1,
        probe_loss_weight: float = 1.0,
        dtype: Any = jnp.bfloat16,
        remat: bool = False,
        volumetric: bool = False,
        features3d=(32, 64, 128, 256),
    ):
        self.model = BYOLNet(
            arch=arch, in_channels=in_channels, low_res=low_res,
            hidden_dim=hidden_dim, proj_dim=proj_dim, num_classes=num_classes, dtype=dtype,
            remat=remat, volumetric=volumetric, features3d=tuple(features3d),
        )
        self.target_encoder = Encoder(
            arch=arch, in_channels=in_channels, low_res=low_res,
            hidden_dim=hidden_dim, proj_dim=proj_dim, dtype=dtype, remat=remat,
            volumetric=volumetric, features3d=tuple(features3d),
        )
        self.total_steps = total_steps
        self.probe_loss_weight = probe_loss_weight
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, steps_per_epoch=steps_per_epoch, interval="step"
        )
        self.ema_schedule = cosine_ema_momentum(base_ema_momentum, final_ema_momentum)
        self.tx = lars(self.schedule, weight_decay=weight_decay, momentum=momentum, mask=make_lars_mask)

    def init(self, rng: jax.Array, sample_shape: Tuple[int, ...]) -> BYOLState:
        variables = self.model.init(rng, jnp.zeros(sample_shape, jnp.float32), train=True)
        params, batch_stats = variables["params"], variables.get("batch_stats", {})
        # momentum encoder starts as an exact copy of the online encoder
        # (reference byol_pytorch.py:131-138)
        target_params = jax.tree.map(jnp.copy, params["encoder"])
        target_bs = jax.tree.map(jnp.copy, batch_stats["encoder"])
        return BYOLState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=batch_stats,
            target_params=target_params,
            target_batch_stats=target_bs,
            opt_state=self.tx.init(params),
        )

    @partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(
        self,
        state: BYOLState,
        view1: jax.Array,
        view2: jax.Array,
        labels: Optional[jax.Array] = None,
    ):
        """One BYOL step on a two-view batch (labels optional, for the probe)."""
        x_online = jnp.concatenate([view1, view2], axis=0)
        x_target = jnp.concatenate([view2, view1], axis=0)  # reversed pairing

        # target (momentum) branch — no gradients, own BN batch stats
        (z_tgt, _), tgt_mut = self.target_encoder.apply(
            {"params": state.target_params, "batch_stats": state.target_batch_stats},
            x_target,
            train=True,
            mutable=["batch_stats"],
        )
        z_tgt = jax.lax.stop_gradient(z_tgt)

        def loss_fn(params):
            (p, z, feats, probe_logits), mut = self.model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                x_online,
                train=True,
                mutable=["batch_stats"],
            )
            contrastive = cosine_similarity_loss(p, z_tgt)
            probe_loss = jnp.zeros((), jnp.float32)
            probe_acc = jnp.zeros((), jnp.float32)
            if labels is not None:
                y = jnp.concatenate([labels, labels], axis=0)
                probe_loss = optax.softmax_cross_entropy_with_integer_labels(
                    probe_logits.astype(jnp.float32), y
                ).mean()
                probe_acc = jnp.mean(jnp.argmax(probe_logits, axis=-1) == y)
            total = contrastive + self.probe_loss_weight * probe_loss
            aux = (mut["batch_stats"], contrastive, probe_loss, probe_acc)
            return total, aux

        (total, (new_bs, contrastive, probe_loss, probe_acc)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)

        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)

        # EMA: tau·target + (1-tau)·online_encoder over PARAMETERS only
        # (reference momentum_update iterates .parameters(),
        # byol_pytorch.py:292-296); the momentum encoder's BN running stats
        # evolve solely from its own train-mode forwards (tgt_mut above).
        # tau follows the cosine schedule (byol_pytorch.py:258-263).
        tau = self.ema_schedule(state.step, self.total_steps)
        new_target_params = jax.tree.map(
            lambda a, b: tau * a + (1.0 - tau) * b, state.target_params, new_params["encoder"]
        )
        new_target_bs = tgt_mut["batch_stats"]

        metrics = {
            "loss": contrastive,
            "probe_loss": probe_loss,
            "probe_acc": probe_acc,
            "lr": self.schedule(state.step),
            "momentum": tau,
        }
        new_state = BYOLState(
            step=state.step + 1,
            params=new_params,
            batch_stats=new_bs,
            target_params=new_target_params,
            target_batch_stats=new_target_bs,
            opt_state=new_opt,
        )
        return new_state, metrics

    @partial(jax.jit, static_argnums=0)
    def val_step(self, state: BYOLState, images: jax.Array, labels: jax.Array) -> Dict[str, jax.Array]:
        """Probe top-1/top-5 (reference `byol_pytorch.py:298-317`)."""
        logits = self.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            images,
            train=False,
            method=BYOLNet.classify,
        ).astype(jnp.float32)
        top1 = jnp.mean(jnp.argmax(logits, -1) == labels)
        k = min(5, logits.shape[-1])
        topk = jax.lax.top_k(logits, k)[1]
        top5 = jnp.mean(jnp.any(topk == labels[:, None], axis=-1))
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        return {"val/loss": loss, "val/acc@1": top1, "val/acc@5": top5}

    @partial(jax.jit, static_argnums=0)
    def embed_step(self, state: BYOLState, images: jax.Array) -> jax.Array:
        """Backbone features for the KNN feature bank (reference knn.py:91-106)."""
        return self.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            images,
            train=False,
            method=BYOLNet.embed,
        )
