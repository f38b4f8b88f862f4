"""Synthetic token data pipeline: deterministic, shard-aware, infinite.

A copy of the JAX package's ``repro.training.data``, which is pure numpy:
the same config gives bitwise the same batches in both packages.

A "document LM" stream: tokens drawn from a Zipf-ish distribution with
per-document Markov structure so loss actually decreases during the e2e
training example (pure-uniform tokens give a flat loss — useless for
validating the optimizer path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -a
    return (p / p.sum()).astype(np.float64)


def batches(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Yields (global_batch, seq_len+1) int32 — inputs are [:, :-1],
    labels are [:, 1:]."""
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    # Markov bigram structure: each token biases the next towards
    # (token * 7 + 3) % vocab with prob q — learnable signal.
    q = 0.5
    while True:
        base = rng.choice(cfg.vocab_size, size=(cfg.global_batch,
                                                cfg.seq_len + 1), p=probs)
        follow = rng.random((cfg.global_batch, cfg.seq_len)) < q
        nxt = (base[:, :-1] * 7 + 3) % cfg.vocab_size
        base[:, 1:] = np.where(follow, nxt, base[:, 1:])
        yield base.astype(np.int32)
