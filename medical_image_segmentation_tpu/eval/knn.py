"""Weighted-KNN online evaluation.

Parity with the reference `KNNOnlineEvaluator`
(`medical_image_segmentation/train/callback/knn.py:11-144`), which the
reference left bit-rotted/unwired (it calls a `forward(return_embedding=…)`
the model doesn't accept — SURVEY §"known bugs"); here it is a working
evaluator:

- feature bank built from L2-normalized backbone features over the train
  loader (`knn.py:91-106`);
- in the reference the bank is NCCL-all_gathered across ranks
  (`knn.py:114-117,143-144`); here each host contributes its shard and the
  bank lives sharded on the mesh — the similarity matmul against it is a
  sharded contraction XLA resolves with ICI collectives;
- prediction: cosine similarity → top-k (k=200) → temperature-weighted
  soft vote (T=0.07) (`knn.py:38-70`).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _l2_normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), eps)


@partial(jax.jit, static_argnames=("num_classes", "k"))
def knn_predict(
    features: jax.Array,      # (B, D) query features (unnormalized ok)
    bank: jax.Array,          # (N, D) L2-normalized feature bank
    bank_labels: jax.Array,   # (N,) int labels
    num_classes: int,
    k: int = 200,
    temperature: float = 0.07,
) -> jax.Array:
    """Soft-voting weighted KNN class scores (B, num_classes)."""
    features = _l2_normalize(features.astype(jnp.float32))
    sim = features @ bank.T.astype(jnp.float32)            # (B, N)
    k = min(k, bank.shape[0])
    sim_k, idx_k = jax.lax.top_k(sim, k)                    # (B, k)
    weights = jnp.exp(sim_k / temperature)
    labels_k = bank_labels[idx_k]                           # (B, k)
    one_hot = jax.nn.one_hot(labels_k, num_classes, dtype=jnp.float32)
    return jnp.einsum("bk,bkc->bc", weights, one_hot)


@partial(jax.jit, static_argnames=("k",))
def _chunk_topk(features: jax.Array, bank_chunk: jax.Array, labels_chunk: jax.Array, k: int):
    """Top-k similarities of (B, D) queries against one bank chunk."""
    sim = features @ bank_chunk.T.astype(jnp.float32)       # (B, C)
    sim_k, idx_k = jax.lax.top_k(sim, min(k, bank_chunk.shape[0]))
    return sim_k, labels_chunk[idx_k]


@partial(jax.jit, static_argnames=("k",))
def _merge_topk(sim_a, lab_a, sim_b, lab_b, k: int):
    """Merge two (B, ≤k) candidate sets into the best ≤k."""
    sim = jnp.concatenate([sim_a, sim_b], axis=1)
    lab = jnp.concatenate([lab_a, lab_b], axis=1)
    sim_k, idx = jax.lax.top_k(sim, min(k, sim.shape[1]))
    return sim_k, jnp.take_along_axis(lab, idx, axis=1)


def knn_predict_chunked(
    features: jax.Array,
    bank: jax.Array,
    bank_labels: jax.Array,
    num_classes: int,
    k: int = 200,
    temperature: float = 0.07,
    chunk_size: int = 65536,
) -> jax.Array:
    """`knn_predict` streamed over the bank dimension: never materializes the
    (B, N) similarity matrix, so a 1M-row bank fits one chip. Exact — top-k by
    similarity is chunk-mergeable (exp(s/T) is monotone in s), so results are
    identical to the unchunked path (verified in tests/test_eval.py)."""
    features = _l2_normalize(features.astype(jnp.float32))
    n = bank.shape[0]
    sim_k = lab_k = None
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        c_sim, c_lab = _chunk_topk(features, bank[s:e], bank_labels[s:e], k)
        if sim_k is None:
            sim_k, lab_k = c_sim, c_lab
        else:
            sim_k, lab_k = _merge_topk(sim_k, lab_k, c_sim, c_lab, k)
    weights = jnp.exp(sim_k / temperature)
    one_hot = jax.nn.one_hot(lab_k, num_classes, dtype=jnp.float32)
    return jnp.einsum("bk,bkc->bc", weights, one_hot)


class KNNEvaluator:
    """Builds a feature bank with an ``embed_fn`` and scores a val loader.

    ``max_bank_size`` caps host+device memory: feature accumulation stops at
    the first N train samples (deterministic under the loader's seed; with a
    shuffled loader order — the trainer's default — the prefix of the epoch
    permutation is a uniform sample of the train set without replacement, so
    the cap does not bias the bank). At the
    canonical 1M-image store × 512-d f32 an unbounded bank is ~2 GB on top of
    the two-tower state; the cap plus ``bank_chunk_size`` keeps the probe
    runnable on one chip."""

    def __init__(
        self,
        num_classes: int,
        k: int = 200,
        temperature: float = 0.07,
        max_bank_size: int | None = None,
        bank_chunk_size: int | None = None,
    ):
        self.num_classes = num_classes
        self.k = k
        self.temperature = temperature
        self.max_bank_size = max_bank_size
        self.bank_chunk_size = bank_chunk_size

    def evaluate(
        self,
        embed_fn: Callable[[jax.Array], jax.Array],
        train_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        val_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    ) -> float:
        """Batches may be host numpy arrays (single-process) or GLOBAL jax
        arrays already placed on the mesh (multi-host — feed the loaders
        through ``device_put_sharded_batches``). With global inputs the bank
        is a device-sharded global array, the similarity matmul against it is
        a sharded contraction XLA resolves with ICI collectives (the
        reference's NCCL all_gather of the bank, `knn.py:114-117`, happens
        inside XLA instead of on the host), and the accuracy reduction yields
        a replicated scalar every host can read."""
        feats, labels = [], []
        n_banked = 0
        for x, y in train_batches:
            if self.max_bank_size is not None and n_banked >= self.max_bank_size:
                break
            f = _l2_normalize(embed_fn(jnp.asarray(x)).astype(jnp.float32))
            y = jnp.asarray(y)
            if self.max_bank_size is not None and n_banked + f.shape[0] > self.max_bank_size:
                keep = self.max_bank_size - n_banked
                f, y = f[:keep], y[:keep]
            feats.append(f)
            labels.append(y)
            n_banked += f.shape[0]
        bank = jnp.concatenate(feats)
        bank_labels = jnp.concatenate(labels)

        correct = total = 0
        for x, y in val_batches:
            if self.bank_chunk_size is not None and bank.shape[0] > self.bank_chunk_size:
                scores = knn_predict_chunked(
                    embed_fn(jnp.asarray(x)), bank, bank_labels, self.num_classes,
                    k=self.k, temperature=self.temperature,
                    chunk_size=self.bank_chunk_size,
                )
            else:
                scores = knn_predict(
                    embed_fn(jnp.asarray(x)), bank, bank_labels, self.num_classes,
                    k=self.k, temperature=self.temperature,
                )
            correct += int(jnp.sum(jnp.argmax(scores, -1) == jnp.asarray(y)))
            total += int(np.shape(y)[0])
        return correct / max(total, 1)
