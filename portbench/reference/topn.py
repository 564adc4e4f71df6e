"""The plain posterior-mean top-N, from the raw draws.

The served score of user i and item j under S retained draws is the
posterior-predictive mean, (1/S) sum_s u_i^s . v_j^s, plus the global
mean; a user's list is the `topk` items of highest score. The reference
scores whole rows in the precision of an `Arith` (float64 for the
reference) and judges a served list by two numbers:

  score_err  the widest gap between a served score and the reference's
             score of the item served;
  rank_gap   the widest amount by which a served item's reference score
             lies below the reference's topk-th best: 0 where the served
             set is the reference's top-k, ties aside.

Imports nothing of the program.
"""
from __future__ import annotations

import torch

from portbench.reference.arith import Arith


def scores(u: torch.Tensor, v: torch.Tensor, users: torch.Tensor,
           global_mean: float, ar: Arith) -> torch.Tensor:
    """(B, N) posterior-mean scores of `users` from draws u (S, M, K) and
    v (S, N, K)."""
    s = u.shape[0]
    total = sum(ar.mm(u[d, users], v[d].T) for d in range(s))
    return total / s + global_mean


def topk(u, v, users, global_mean: float, topk: int, ar: Arith
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """A list served from this precision's scores: (values, ids)."""
    vals, ids = torch.topk(scores(u, v, users, global_mean, ar), topk, dim=1)
    return vals, ids


def malformed(vals: torch.Tensor, ids: torch.Tensor, n_items: int) -> torch.Tensor:
    """(B,) True where a list is not a list: an id out of range or
    repeated, a score not finite, or scores not in descending order."""
    bad = ~torch.isfinite(vals).all(1) | ((ids < 0) | (ids >= n_items)).any(1)
    srt = torch.sort(ids, dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (vals[:, 1:] > vals[:, :-1]).any(1)
    return bad


def judge(vals: torch.Tensor, ids: torch.Tensor, ref: torch.Tensor, topk: int
          ) -> tuple[float, float, int]:
    """(score_err, rank_gap, malformed lists) of served lists (B, topk)
    against the reference's scores (B, N) of the same users."""
    vals, ids = vals.to(ref.device, torch.float64), ids.to(ref.device, torch.int64)
    bad = malformed(vals, ids, ref.shape[1])
    ok = ~bad
    if not bool(ok.any()):
        return float("inf"), float("inf"), int(bad.sum())
    got = torch.gather(ref[ok], 1, ids[ok])
    score_err = float((vals[ok] - got).abs().max())
    kth = torch.topk(ref[ok], topk, dim=1).values[:, -1]
    rank_gap = float((kth - got.min(1).values).clamp(min=0).max())
    return score_err, rank_gap, int(bad.sum())
