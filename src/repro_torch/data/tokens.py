"""Synthetic LM data (port of `repro.data.tokens`, numpy, bit-identical).

Deterministic batch generators for the mesh trainer. The token stream has
learnable structure (an order-1 Markov chain over a Zipf vocabulary) so the
training loss decreases; worker shards draw from differently mixed corpora,
so per-worker losses differ (the signal the paper's consistency statistic
keys on).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _markov_tables(vocab: int, n_corpora: int, seed: int):
    rng = np.random.default_rng(seed)
    rng.zipf(1.3, size=vocab * 4)  # drawn (and unused) as the reference draws it
    # sparse successor tables: each token has a few likely successors
    return [rng.integers(0, vocab, size=(vocab, 4)) for _ in range(n_corpora)]


def synthetic_lm_batches(vocab: int, seq_len: int, global_batch: int, *, seed: int = 0,
                         n_corpora: int = 0, noise: float = 0.1) -> Iterator[dict]:
    """Yields {"tokens", "labels"} (int32, (global_batch, seq_len)) with labels
    the next-token shift; row b draws from corpus b % n_corpora."""
    n_corpora = n_corpora or max(1, global_batch // 8)
    tables = _markov_tables(vocab, n_corpora, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = np.empty((global_batch, seq_len + 1), np.int32)
        for b in range(global_batch):
            succ = tables[b % n_corpora]
            t = rng.integers(0, vocab)
            row = np.empty(seq_len + 1, np.int32)
            for s in range(seq_len + 1):
                row[s] = t
                if rng.random() < noise:
                    t = rng.integers(0, vocab)
                else:
                    t = succ[t, rng.integers(0, succ.shape[1])]
            toks[b] = row
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_for(cfg, seq_len: int, global_batch: int, seed: int = 0) -> dict:
    """One synthetic batch of uniform tokens and labels for a token arch (the
    reference's audio and VLM branches wait for their frontends' port)."""
    if cfg.audio_frontend or (cfg.arch_type == "vlm" and cfg.n_patches):
        raise NotImplementedError(f"{cfg.name}: audio/vlm batches are not yet ported")
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (global_batch, seq_len)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (global_batch, seq_len)).astype(np.int32),
    }
