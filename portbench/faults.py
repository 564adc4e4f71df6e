"""Faults planted under the timed path, for the tests and the readings
that set the limits: each must make a run's `correct` come out false.

  gibbs  unchanged   a sweep returns its state unchanged (step + 1 only)
         half_batch  every other rating of each bucket left out of the
                     statistics, the rest counted twice
         altered     one factor row of each sweep's U negated where it is
                     produced
  topn   half_batch  the first half of each batch scored, its lists
                     repeated for the second half
         half_draws  the scores' mean taken over the first half of the
                     draws only
         altered     one id of each batch's first list moved to the next item

`plant(driver, fault)` is a context manager that patches the port's class
or module and restores it on exit. The exchange between chips, the fourth
fault of the kind, does not exist in a one-chip cell.
"""
from __future__ import annotations

import contextlib

import torch


def _unchanged(orig):
    return lambda self, state, noise=None: state._replace(step=state.step + 1)


def _altered_sweep(orig):
    def sweep(self, state, noise=None):
        out = orig(self, state, noise)
        u = out.u.clone()
        u[0] = -u[0]
        return out._replace(u=u)
    return sweep


def _half_ratings(orig):
    def stats(counterpart, bucket, **kw):
        r, w = bucket.mask.shape
        keep = torch.arange(r * w, device=bucket.mask.device).view(r, w) % 2 == 0
        half = bucket._replace(mask=bucket.mask * keep, values=bucket.values * keep)
        prec, rhs = orig(counterpart, half, **kw)
        return 2 * prec, 2 * rhs
    return stats


def _half_batch(orig):
    def recommend(self, user_ids, topk, **kw):
        ids = list(user_ids)
        h = max(1, len(ids) // 2)
        vals, items = orig(self, ids[:h], topk, **kw)
        reps = -(-len(ids) // h)
        return (torch.as_tensor(vals).repeat(reps, 1)[:len(ids)].numpy(),
                torch.as_tensor(items).repeat(reps, 1)[:len(ids)].numpy())
    return recommend


def _half_draws(orig):
    def scoring_matrices(self):
        s, m, k = self.u.shape
        h = max(1, s // 2)
        return ((self.u[:h] / h).permute(1, 0, 2).reshape(m, h * k),
                self.v[:h].permute(1, 0, 2).reshape(self.n_items, h * k))
    return scoring_matrices


def _altered_list(orig):
    def recommend(self, user_ids, topk, **kw):
        vals, items = orig(self, user_ids, topk, **kw)
        items = items.copy()
        items[0, -1] = (items[0, -1] + 1) % self.hosts[-1].live.hi
        return vals, items
    return recommend


def _targets():
    """(driver, fault) -> (owner, attribute, patch)."""
    from repro_torch.core import gibbs
    from repro_torch.serve.ensemble import PosteriorEnsemble
    from repro_torch.serve.topn import TopNRecommender

    return {
        ("gibbs", "unchanged"): (gibbs.GibbsSampler, "sweep", _unchanged),
        ("gibbs", "half_batch"): (gibbs, "bucket_stats", _half_ratings),
        ("gibbs", "altered"): (gibbs.GibbsSampler, "sweep", _altered_sweep),
        ("topn", "half_batch"): (TopNRecommender, "recommend", _half_batch),
        ("topn", "half_draws"): (PosteriorEnsemble, "scoring_matrices", _half_draws),
        ("topn", "altered"): (TopNRecommender, "recommend", _altered_list),
    }


FAULTS = {"gibbs": ("unchanged", "half_batch", "altered"),
          "topn": ("half_batch", "half_draws", "altered")}


@contextlib.contextmanager
def plant(driver: str, fault: str):
    """The port with `fault` of a `driver`'s kind of work planted."""
    owner, name, patch = _targets()[(driver, fault)]
    own = name in vars(owner)   # else inherited: take the patch off again
    orig = getattr(owner, name)
    setattr(owner, name, patch(orig))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)
