"""Synthetic LM data pipeline: a numpy-only copy of `repro/data/tokens.py`.

Deterministic, seekable batch stream (batch i is a pure function of (seed,
i)). Tokens follow a zipf marginal with a first-order mixing structure so
a model can reduce loss; labels are the next tokens. The batches are bit
for bit the JAX package's for the same config, batch, length and seed,
the audio and VLM stubs' too: an audio batch carries (B, encoder_seq,
d_model) frame embeddings, a VLM batch (B, n_patches, d_model) patch
embeddings, (B, 3, n_patches + S) positions (the same sequence on the
three M-RoPE channels) and labels of -1 over the patches.
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
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
        cfg = self.cfg
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        if cfg.family == "vlm":
            npch = cfg.n_patches
            batch["patch_embeds"] = rng.standard_normal((b, npch, cfg.d_model),
                                                        dtype=np.float32)
            full = npch + s
            batch["positions"] = np.broadcast_to(np.arange(full, dtype=np.int32),
                                                 (b, 3, full)).copy()
            batch["labels"] = np.concatenate(
                [np.full((b, npch), -1, np.int32), batch["labels"]], axis=1)
        return batch
