"""Deterministic synthetic token pipeline for LM training examples.

Port of ``repro/data/lm_data.py`` (numpy in both packages: batches are
equal bit for bit).

Replayable by construction: batch(step) is a pure function of (seed, step),
which is what makes checkpoint-restart exact (the trainer replays the
iterator to the restored step with zero drift).  The generated stream is a
Zipf-distributed Markov chain — enough statistical structure that
cross-entropy demonstrably falls during the example runs.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, order: int = 2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse Markov transition: each context row concentrates on a few
        # successors — learnable structure
        self.n_ctx = min(4096, vocab_size ** min(order, 2))
        self.succ = rng.integers(0, vocab_size, (self.n_ctx, 4))
        self.zipf_p = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self.zipf_p /= self.zipf_p.sum()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq + 1), np.int64)
        toks[:, 0] = rng.choice(self.vocab, self.batch, p=self.zipf_p)
        noise = rng.random((self.batch, self.seq))
        pick = rng.integers(0, 4, (self.batch, self.seq))
        rand_toks = rng.choice(self.vocab, (self.batch, self.seq),
                               p=self.zipf_p)
        for t in range(self.seq):
            ctx = toks[:, t] % self.n_ctx
            nxt = self.succ[ctx, pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, nxt,
                                      rand_toks[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
