"""Batched top-N recommendation over the full item catalogue: the
colocated special case of the serving tier (serve/cluster.py), one shard a
device when a device list is given, with seen-item exclusion. Shard bounds, kernel scoring, the stable merge, the
power-of-two fetch and the exclusion live in the tier, once.

Users should not be recommended items they already rated. Rated sets are
tiny next to the catalogue, so the kernel fetches topk + the largest rated
count of the index candidates and the host drops the seen ones, which is
cheaper than a (B, N) mask the kernel would have to read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import SparseRatings, csr_from_coo
from repro_torch.serve.cluster import ClusterCoordinator, _merge_topk, shard_bounds
from repro_torch.serve.ensemble import PosteriorEnsemble

__all__ = ["SeenIndex", "TopNRecommender", "_merge_topk", "shard_bounds"]


class SeenIndex:
    """One-time CSR index over the training matrix: O(degree) lookup of a
    user's rated items.

    `shape` may be larger than the ratings matrix (users or items the
    ratings never saw get empty rows); smaller is rejected, since an index
    that dropped known ratings would under-exclude.
    """

    def __init__(self, ratings: SparseRatings, *,
                 shape: tuple[int, int] | None = None):
        self.ratings = ratings
        self.shape = tuple(ratings.shape) if shape is None else tuple(shape)
        if self.shape[0] < ratings.shape[0] or self.shape[1] < ratings.shape[1]:
            raise ValueError(
                f"seen-index shape {self.shape} cannot shrink below the "
                f"ratings matrix {tuple(ratings.shape)}: it would silently "
                "under-exclude"
            )
        self.indptr, self.cols, _ = csr_from_coo(
            ratings.rows, ratings.cols, ratings.vals, self.shape[0]
        )
        self.max_degree = int(np.diff(self.indptr).max(initial=0))

    def resized(self, shape: tuple[int, int]) -> "SeenIndex":
        return SeenIndex(self.ratings, shape=shape)

    def __getitem__(self, user: int) -> np.ndarray:
        return self.cols[self.indptr[user]: self.indptr[user + 1]]


class TopNRecommender(ClusterCoordinator):
    """Single-host top-N: every item shard in this process, on `device`
    ("cuda" by default), or one shard a device of `devices` (n_shards =
    len(devices); `device` then defaults to devices[0]). The serving API is
    the coordinator's; this class maps the `n_shards=` spelling onto its
    host axis and keeps the flat-array accessors."""

    # colocated shards share one U table and the coordinator gathers the
    # scoring rows once
    routed = False

    def __init__(self, ensemble: PosteriorEnsemble, *, n_shards: int = 1,
                 devices=None, device=None):
        super().__init__(ensemble, n_hosts=n_shards, devices=devices, device=device)

    def _layout_kwargs(self) -> dict:
        return dict(n_shards=self._layout_hosts, devices=self.devices,
                    device=self.device)

    @property
    def u_flat(self) -> torch.Tensor:
        """(M, S*K) trained-user scoring rows, the shared U table."""
        return self.hosts[0].live.u_replica

    @property
    def v_shards(self) -> list[torch.Tensor]:
        return [h.live.v_shard for h in self.hosts]

    @property
    def shard_bounds(self) -> np.ndarray:
        return np.asarray([self.hosts[0].live.lo] + [h.live.hi for h in self.hosts])

    @property
    def shard_offsets(self) -> np.ndarray:
        return np.asarray([h.live.lo for h in self.hosts])
