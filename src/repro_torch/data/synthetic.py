"""Deterministic, restart-safe synthetic token pipeline.

``batch_for_step(cfg, shape, step, host_id, n_hosts)`` is a pure function of
its arguments — no iterator state to checkpoint, no epoch bookkeeping to
lose on failure, and elastic: changing ``n_hosts`` re-partitions the same
global stream.  Tokens follow a Zipf-ish marginal (more realistic softmax
load than uniform) with a repeating-ngram structure so a real LM loss
actually decreases.
"""
from __future__ import annotations

import numpy as np


def batch_for_step(vocab: int, batch: int, seq: int, step: int,
                   host_id: int = 0, n_hosts: int = 1, seed: int = 0):
    assert batch % n_hosts == 0
    local = batch // n_hosts
    rng = np.random.default_rng(
        np.uint64(seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(65_537) + np.uint64(host_id))
    # zipf-ish marginal over the vocab
    z = rng.zipf(1.3, size=(local, seq)).astype(np.int64)
    tokens = (z - 1) % vocab
    # inject short repeated n-grams (learnable structure)
    period = 64
    base = rng.integers(0, vocab, size=(local, period))
    mask = rng.random((local, seq)) < 0.5
    tiled = np.tile(base, (1, seq // period + 1))[:, :seq]
    tokens = np.where(mask, tiled, tokens)
    return tokens.astype(np.int32)
