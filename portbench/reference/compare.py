"""The numbers a check compares.

`rel_err(got, want)`: the widest elementwise gap between an answer and
the reference's, over the reference's root mean square: 0 for the same
answer, of order 1e-7 for float32 rounding of well-conditioned work, and
infinite where the answer is not finite or has the wrong shape. Computed
in float64 a block of rows at a time.
"""
from __future__ import annotations

import math

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor, block: int = 1 << 16) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    if want.numel() == 0:
        return 0.0
    worst, sq = 0.0, 0.0
    g, w = got.reshape(got.shape[0] if got.dim() else 1, -1), want.reshape(
        want.shape[0] if want.dim() else 1, -1)
    for i in range(0, g.shape[0], block):
        a = g[i:i + block].to(w.device, torch.float64)
        b = w[i:i + block].to(torch.float64)
        if not bool(torch.isfinite(a).all()):
            return math.inf
        worst = max(worst, float((a - b).abs().max()))
        sq += float((b * b).sum())
    rms = math.sqrt(sq / want.numel())
    return worst / rms if rms > 0 else (0.0 if worst == 0 else math.inf)
