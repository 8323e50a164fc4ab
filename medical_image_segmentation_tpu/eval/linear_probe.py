"""Online linear-probe evaluation on frozen features.

Parity with the reference `SSLLinearEval` callback
(`medical_image_segmentation/train/callback/linear_eval.py:16-169`): a
separate Flatten→Dropout→Linear head with its own Adam(1e-4), trained on
stop-gradient encoder features after each train step and scored on val.
The reference wraps the head in DDP to sync it (`linear_eval.py:54-67`);
here the head params are replicated and its grads are psum'd by XLA under
the sharded batch — same effect, no wrapper. The head state is a pytree, so
it checkpoints with everything else (reference `linear_eval.py:135-142`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax

from medical_image_segmentation_tpu.core.struct import PyTreeNode
from medical_image_segmentation_tpu.models import nn


class _Head(nn.Module):
    num_classes: int
    dropout: float = 0.0

    def __call__(self, x, train: bool = True):
        x = x.reshape((x.shape[0], -1))
        if self.dropout > 0:
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return nn.Dense(self.num_classes, param_dtype=jnp.float32)(x)


class ProbeState(PyTreeNode):
    params: Any
    opt_state: Any
    rng: jax.Array


class LinearProbe:
    def __init__(self, feature_dim: int, num_classes: int, dropout: float = 0.0, lr: float = 1e-4):
        self.head = _Head(num_classes=num_classes, dropout=dropout)
        self.tx = optax.adam(lr)
        self.feature_dim = feature_dim

    def init(self, rng: jax.Array) -> ProbeState:
        params = self.head.init(rng, jnp.zeros((1, self.feature_dim)), train=False)["params"]
        return ProbeState(params=params, opt_state=self.tx.init(params), rng=rng)

    @partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: ProbeState, feats: jax.Array, labels: jax.Array):
        feats = jax.lax.stop_gradient(feats.astype(jnp.float32))
        rng, step_rng = jax.random.split(state.rng)

        def loss_fn(params):
            logits = self.head.apply({"params": params}, feats, train=True, rngs={"dropout": step_rng})
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            acc = jnp.mean(jnp.argmax(logits, -1) == labels)
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return (
            ProbeState(params=new_params, opt_state=new_opt, rng=rng),
            {"online_train_loss": loss, "online_train_acc": acc},
        )

    @partial(jax.jit, static_argnums=0)
    def eval_step(self, state: ProbeState, feats: jax.Array, labels: jax.Array) -> Dict[str, jax.Array]:
        logits = self.head.apply({"params": state.params}, feats.astype(jnp.float32), train=False)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        acc = jnp.mean(jnp.argmax(logits, -1) == labels)
        return {"online_val_loss": loss, "online_val_acc": acc}
