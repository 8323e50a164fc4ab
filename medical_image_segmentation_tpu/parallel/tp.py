"""Tensor-parallel sharding rules for the BYOL MLP heads.

The reference has no tensor parallelism (its distributed stack is DDP-only,
`medical_image_segmentation/train/train_ssl.py:77-89`); this module adds it
the XLA way: no code changes in the model, only sharding annotations — XLA
GSPMD turns them into the Megatron pattern automatically:

- ``Dense_0`` (feat → 4096) kernel sharded on the OUTPUT dim
  (column-parallel): each model-shard computes its slice of the hidden
  activation, no communication;
- the 1-D BatchNorm over the hidden dim is sharded with it — its statistics
  reduce over the batch axis only, so each hidden shard owns its stats
  (numerically identical to the unsharded op);
- ``Dense_1`` (4096 → out) kernel sharded on the INPUT dim (row-parallel):
  each shard contracts its hidden slice and XLA inserts the single
  all-reduce (psum over the ``model`` axis) that completes the matmul.

Net cost: one all-reduce of the (batch, out_dim) activation per MLP — the
canonical trade for fitting a wide hidden layer across chips.

These rules apply by *path suffix*, so the same function covers
``params['encoder']['projector']``, ``params['predictor']``, the target
encoder's projector, the matching ``batch_stats`` subtrees, and every
params-shaped leaf inside the LARS optimizer state.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# MLP heads: flax auto-names the two Dense layers Dense_0/Dense_1 and the
# norm BatchNorm_0 (models/mlp.py). Only subtrees under these module names
# are sharded; everything else stays replicated.
_TP_MODULES = ("projector", "predictor")


def _leaf_spec(path) -> P:
    keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    keys = [k for k in keys if isinstance(k, str)]
    if not any(m in keys for m in _TP_MODULES):
        return P()
    tail = keys[-2:] if len(keys) >= 2 else keys
    if tail == ["Dense_0", "kernel"]:
        return P(None, "model")  # column-parallel: shard hidden outputs
    if tail == ["Dense_0", "bias"]:
        return P("model")
    if len(tail) == 2 and tail[0] == "BatchNorm_0":
        return P("model")  # scale/bias/mean/var live on the hidden dim
    if tail == ["Dense_1", "kernel"]:
        return P("model", None)  # row-parallel: shard hidden inputs
    return P()


def byol_tp_shardings(mesh: Mesh, state: Any, hidden_dim: int) -> Any:
    """Pytree of NamedShardings for a ``BYOLState`` (or any pytree whose MLP
    leaves sit under projector/predictor module names): MLP heads sharded
    over the mesh's ``model`` axis, everything else replicated.

    Raises if ``hidden_dim`` does not divide the model-axis size (GSPMD
    would fall back to padded shards)."""
    tp = mesh.shape.get("model", 1)
    if hidden_dim % tp != 0:
        raise ValueError(f"hidden_dim {hidden_dim} must divide model axis size {tp}")
    return jax.tree_util.tree_map_with_path(
        lambda path, _: NamedSharding(mesh, _leaf_spec(path)), state
    )
