"""Synthetic data pipeline (the container is offline; see DESIGN.md §7).

Two generators:

* ``TokenStream`` — deterministic synthetic LM token stream with Zipfian
  unigram statistics and a Markov bigram structure, so the LM loss has
  real signal (a model that learns beats the unigram entropy floor).
* ``classification_dataset`` — Gaussian-mixture classification standing in
  for MNIST / CIFAR-10 in the paper's experiments (same shapes: 784-dim /
  3072-dim inputs, 10 classes), with a train/test split.

Both are seeded and sliced per node: node i receives shard i of every
batch, matching the paper's "each node holds a local dataset D_i".

The port's own copy of ``repro/data/synthetic.py`` (numpy/math only): importing it
from the JAX package would run ``repro/core/__init__.py``, which
imports jax. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = ["TokenStream", "classification_dataset",
           "node_partitioned_batches"]


@dataclasses.dataclass
class TokenStream:
    """Deterministic LM batches: (tokens, labels) with labels = shift-left."""

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipf unigram + low-rank bigram transition for learnable structure.
        unigram = 1.0 / np.arange(1, v + 1) ** 1.1
        self._unigram = unigram / unigram.sum()
        rank = min(16, v)
        self._emb = rng.normal(size=(v, rank)).astype(np.float32)
        self._out = rng.normal(size=(rank, v)).astype(np.float32)

    def batches(self, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.choice(v, size=b, p=self._unigram)
        # historical warm-up draw: keeps the rng stream (and every
        # pinned batch downstream) identical across revisions
        _ = rng.random((b, s)).astype(np.float32)
        for t in range(s):
            logits = self._emb[toks[:, t]] @ self._out  # (b, v)
            logits = logits / 2.0 + np.log(self._unigram)[None, :]
            # Gumbel-max sampling, vectorized over batch
            g = -np.log(-np.log(
                rng.random((b, v)).astype(np.float32) + 1e-9) + 1e-9)
            toks[:, t + 1] = np.argmax(logits + g, axis=-1)
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def classification_dataset(n_features: int, n_classes: int, n_train: int,
                           n_test: int, seed: int = 0,
                           class_sep: float = 2.0):
    """Gaussian-mixture stand-in for MNIST (784) / CIFAR-10 (3072)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)).astype(np.float32)
    centers *= class_sep / np.linalg.norm(centers, axis=1, keepdims=True)

    def sample(n, s):
        r = np.random.default_rng((seed, s))
        ys = r.integers(0, n_classes, size=n)
        xs = centers[ys] + r.normal(size=(n, n_features)).astype(np.float32)
        return xs.astype(np.float32), ys.astype(np.int32)

    return sample(n_train, 1), sample(n_test, 2)


def node_partitioned_batches(xs: np.ndarray, ys: np.ndarray, n_nodes: int,
                             batch_per_node: int, seed: int = 0
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (n_nodes, batch, ...) stacks; node i only ever sees shard i.

    The dataset is split into n_nodes static shards (the paper's local
    datasets D_i with |D_i| = m); every step each node subsamples its own
    shard — the subsampling that drives Theorem 1's tau.
    """
    n = xs.shape[0] // n_nodes
    shards_x = xs[: n * n_nodes].reshape(n_nodes, n, *xs.shape[1:])
    shards_y = ys[: n * n_nodes].reshape(n_nodes, n)
    step = 0
    while True:
        r = np.random.default_rng((seed, step))
        idx = r.integers(0, n, size=(n_nodes, batch_per_node))
        bx = np.take_along_axis(
            shards_x, idx.reshape(n_nodes, -1, *([1] * (xs.ndim - 1))), axis=1)
        by = np.take_along_axis(shards_y, idx, axis=1)
        yield bx, by
        step += 1
