"""Ensemble scorer over retained BPMF posterior samples.

The posterior-predictive rating of (i, j) under S retained Gibbs draws is

    p(r_ij | R) ~= 1/S sum_s N(r_ij ; u_i^s . v_j^s + mean, 1/alpha)

so the served score is the sample average of the per-draw dot products and
the predictive variance is epistemic (across draws) plus aleatoric
(1/alpha). The posterior-mean score is itself one product,

    1/S sum_s U_s V_s^T  =  U' V'^T,   U' = [U_1/S .. U_S/S],  V' = [V_1 .. V_S]

(concatenation along K); `scoring_matrices()` gives that (M, S*K) /
(N, S*K) pair, which the top-N kernel consumes, and `user_scoring_rows()`
the same rows for fold-in users' per-draw factors.

Draws arrive as host arrays (from a SampleStore or a PublicationChannel)
and are stacked and uploaded once per ensemble.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpoint.samples import RetainedSample, SampleStore
from repro_torch.device import resolve_device


def _host(x) -> np.ndarray:
    """A host float32 array of x (numpy, a torch tensor on any device, or
    anything np.asarray takes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class PosteriorEnsemble:
    """Stacked retained draws on one device, ready to score."""

    def __init__(self, samples: Sequence[RetainedSample], *, device="cuda"):
        if not samples:
            raise ValueError("ensemble needs at least one retained sample")
        shapes = {(np.shape(s.u), np.shape(s.v)) for s in samples}
        if len(shapes) != 1:
            raise ValueError(f"inconsistent sample shapes: {shapes}")
        self.device = resolve_device(device)

        def stack(name):
            a = np.stack([_host(getattr(s, name)) for s in samples])
            return torch.as_tensor(a).to(self.device)

        self.samples = tuple(samples)
        self.u = stack("u")                    # (S, M, K)
        self.v = stack("v")                    # (S, N, K)
        self.hyper_u_mu = stack("hyper_u_mu")  # (S, K)
        self.hyper_u_lam = stack("hyper_u_lam")  # (S, K, K)
        self.global_mean = float(samples[-1].global_mean)
        self.alpha = float(samples[-1].alpha)
        self.epoch = int(samples[-1].step)

    @classmethod
    def load(cls, root: str | Path, *, max_samples: int | None = None,
             device="cuda") -> "PosteriorEnsemble":
        """Load the retained draws under `root` (the newest `max_samples`)."""
        return cls(SampleStore(root).load_all(max_samples), device=device)

    @classmethod
    def from_arrays(cls, u, v, *, hyper_u_mu, hyper_u_lam, hyper_v_mu,
                    hyper_v_lam, global_mean: float, alpha: float,
                    steps: Sequence[int], device="cuda") -> "PosteriorEnsemble":
        """An ensemble from already-stacked arrays, numpy or torch: u (S, M,
        K), v (S, N, K), per-draw hypers ((S, K) means, (S, K, K)
        precisions) and the S Gibbs steps, ascending (the newest is the
        serving epoch). No disk."""
        u, v = _host(u), _host(v)
        s = u.shape[0]
        if len(steps) != s or v.shape[0] != s:
            raise ValueError(f"expected {s} steps/draws, got {len(steps)}/{v.shape[0]}")
        steps = [int(x) for x in steps]
        if steps != sorted(steps):
            raise ValueError(f"steps must be ascending (epoch = newest): {steps}")
        hu_mu, hu_lam = _host(hyper_u_mu), _host(hyper_u_lam)
        hv_mu, hv_lam = _host(hyper_v_mu), _host(hyper_v_lam)
        return cls(tuple(
            RetainedSample(
                step=steps[i], u=u[i], v=v[i],
                hyper_u_mu=hu_mu[i], hyper_u_lam=hu_lam[i],
                hyper_v_mu=hv_mu[i], hyper_v_lam=hv_lam[i],
                global_mean=float(global_mean), alpha=float(alpha),
            )
            for i in range(s)
        ), device=device)

    def shape_key(self) -> tuple[int, int, int, int]:
        """(S, M, N, K): equal keys mean a recommender's layout is reusable."""
        return (self.n_samples, self.n_users, self.n_items, self.k)

    @property
    def n_samples(self) -> int:
        return self.u.shape[0]

    @property
    def n_users(self) -> int:
        return self.u.shape[1]

    @property
    def n_items(self) -> int:
        return self.v.shape[1]

    @property
    def k(self) -> int:
        return self.u.shape[2]

    def score(self, users, items) -> tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and predictive variance for (user, item) pairs:
        (B,) ids -> (mean (B,), var (B,)). The epistemic part uses the
        unbiased estimator when S > 1."""
        return self._moments(self._pair_scores(users, items))

    def score_factors(self, u_draws: torch.Tensor, items
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Like score() for explicit per-draw user factors (S, B, K): the
        fold-in path, where the user has no row in U."""
        items = torch.as_tensor(np.asarray(items, np.int64)).to(self.device)
        per_draw = (u_draws.to(self.device) * self.v[:, items]).sum(-1) + self.global_mean
        return self._moments(per_draw)

    def mean_stderr(self, users, items) -> torch.Tensor:
        """Standard error of the served posterior-mean score (~1/sqrt(S))."""
        per_draw = self._pair_scores(users, items)
        s = per_draw.shape[0]
        var = torch.var(per_draw, dim=0, correction=1 if s > 1 else 0)
        return torch.sqrt(var / s)

    def _pair_scores(self, users, items) -> torch.Tensor:
        users = torch.as_tensor(np.asarray(users, np.int64)).to(self.device)
        items = torch.as_tensor(np.asarray(items, np.int64)).to(self.device)
        return (self.u[:, users] * self.v[:, items]).sum(-1) + self.global_mean

    def _moments(self, per_draw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = per_draw.shape[0]
        mean = per_draw.mean(0)
        epistemic = torch.var(per_draw, dim=0, correction=1 if s > 1 else 0)
        return mean, epistemic + 1.0 / self.alpha

    def scoring_matrices(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(U' (M, S*K), V' (N, S*K)) with U' V'^T = posterior-mean scores
        minus the global mean."""
        s, m, k = self.u.shape
        u_flat = (self.u / s).permute(1, 0, 2).reshape(m, s * k)
        v_flat = self.v.permute(1, 0, 2).reshape(self.n_items, s * k)
        return u_flat, v_flat

    def user_scoring_rows(self, u_draws: torch.Tensor) -> torch.Tensor:
        """Per-draw user factors (S, B, K) -> (B, S*K) rows against
        scoring_matrices()' V': fold-in users scored by the same kernel as
        trained users."""
        s, b, k = u_draws.shape
        return (u_draws.to(self.device) / s).permute(1, 0, 2).reshape(b, s * k)
