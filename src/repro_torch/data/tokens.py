"""Synthetic LM data pipeline: a numpy-only copy of `repro/data/tokens.py`.

Deterministic, seekable batch stream (batch i is a pure function of (seed,
i)). Tokens follow a zipf marginal with a first-order mixing structure so
a model can reduce loss; labels are the next tokens. The batches are bit
for bit the JAX package's for the same config, batch, length and seed.
Only the token families are copied: the audio and VLM stubs are not
ported (ROADMAP.md, queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass
class TokenStream:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        v = min(self.cfg.vocab_size, 32_768)
        rng = np.random.default_rng(self.seed)
        self._vocab = v
        # bigram mixing table: each token prefers a small successor set
        self._succ = rng.integers(0, v, size=(v, 4))
        p = (np.arange(1, v + 1)) ** -1.1
        self._p = p / p.sum()

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(self._vocab, size=b, p=self._p)
        follow = rng.random((b, s)) < 0.7
        fresh = rng.choice(self._vocab, size=(b, s), p=self._p)
        pick = rng.integers(0, 4, size=(b, s))
        for t in range(s):
            succ = self._succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], succ, fresh[:, t])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
