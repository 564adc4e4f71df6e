"""Top-N serving over item shards: the serving path of the reference's
multi-host tier (`repro.serve.cluster`), with every shard on one device.

Each ShardHost holds a resident row range of V' (its item shard) and the U
scoring table; the coordinator asks every shard for its candidate list
through the topn_scores kernel and merges them with `_merge_topk`. Shards
hold disjoint ascending index ranges and are concatenated in range order,
so a stable merge resolves ties to the lowest global item index, which is
what one unsharded top-k picks.

Not here yet (later slices of the port): publication-channel fan-out, the
quorum epoch barrier, replicas, health tracking and fault seams, and the
fold-in path (`recommend_factors`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.ensemble import PosteriorEnsemble


def shard_bounds(n_items: int, n_shards: int) -> np.ndarray:
    """n_shards + 1 ascending item-axis bounds, balanced to within one row."""
    return np.linspace(0, n_items, n_shards + 1).astype(int)


def _merge_topk(vals: torch.Tensor, idx: torch.Tensor, topk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidates (B, C), keeping the first of equal scores
    (a stable descending sort), so ties go to the lowest global index."""
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :topk], torch.gather(idx, 1, pos[:, :topk])


class _Binding(NamedTuple):
    """One host's immutable serving state for one epoch."""

    ensemble: PosteriorEnsemble
    u_replica: torch.Tensor   # (M, S*K) the U scoring table
    v_shard: torch.Tensor     # (hi-lo, S*K) resident item shard
    lo: int                   # global index of the shard's first item
    hi: int


class ShardHost:
    """One serving host: the binding of its item shard."""

    def __init__(self, host_id: int, ensemble: PosteriorEnsemble, lo: int,
                 hi: int, *, device, flats=None):
        self.host_id = host_id
        self.device = device
        self.live = self.build(ensemble, lo, hi, flats=flats)

    def build(self, ensemble: PosteriorEnsemble, lo: int, hi: int, *,
              flats=None) -> _Binding:
        """Resident V' rows [lo, hi) and the U table on this host's device;
        `flats` shares one scoring_matrices() result across hosts."""
        u_flat, v_flat = flats if flats is not None else ensemble.scoring_matrices()
        chunk = v_flat[lo:hi].to(self.device).contiguous()
        return _Binding(ensemble, u_flat.to(self.device), chunk, int(lo), int(hi))

    def candidates(self, binding: _Binding, fetch: int, *, rows: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """This host's (B, min(fetch, shard rows)) candidates against its
        shard, indices in the global item numbering."""
        k_eff = min(fetch, binding.hi - binding.lo)
        vals, idx = ops.topn_scores(rows, binding.v_shard, k_eff)
        return vals, idx + binding.lo


class ClusterCoordinator:
    """Scatter/gather top-N over ShardHosts on one device.

    `device` defaults to "cuda" and raises without a card unless the CPU is
    asked for.
    """

    def __init__(self, ensemble: PosteriorEnsemble, *, n_hosts: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self._n_shards = max(1, min(int(n_hosts), ensemble.n_items))
        bounds = shard_bounds(ensemble.n_items, self._n_shards)
        flats = ensemble.scoring_matrices()
        self.hosts = [
            ShardHost(i, ensemble, bounds[i], bounds[i + 1],
                      device=self.device, flats=flats)
            for i in range(self._n_shards)
        ]
        self.ensemble = ensemble
        self._epoch = ensemble.epoch

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def n_shards(self) -> int:
        return self._n_shards

    @property
    def epoch(self) -> int:
        return self._epoch

    def _layout_kwargs(self) -> dict:
        return dict(n_hosts=self._n_shards, device=self.device)

    def rebind(self, ensemble: PosteriorEnsemble):
        """A new coordinator serving `ensemble` on this one's layout (same
        shard bounds and device). Self stays servable. Raises ValueError
        when the ensemble's (S, M, N, K) changed."""
        if ensemble.shape_key() != self.ensemble.shape_key():
            raise ValueError(
                f"shape changed: {ensemble.shape_key()} vs "
                f"{self.ensemble.shape_key()}; rebuild, don't rebind"
            )
        return type(self)(ensemble, **self._layout_kwargs())

    def _snapshot(self) -> tuple[int, PosteriorEnsemble, list[tuple[ShardHost, _Binding]]]:
        """The epoch, ensemble and one (host, binding) per shard that one
        request scores against."""
        return self._epoch, self.ensemble, [(h, h.live) for h in self.hosts]

    def _gather_merge(self, picks, fetch: int, *, rows: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        vals, idx = [], []
        for host, binding in picks:
            v, i = host.candidates(binding, fetch, rows=rows)
            vals.append(v)
            idx.append(i)
        if len(vals) == 1:
            return vals[0], idx[0]
        return _merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), fetch)

    def _serve(self, topk: int, *, rows=None, user_ids=None,
               exclude: list[np.ndarray] | None = None,
               fetch_hint: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        _, ens, picks = self._snapshot()
        if user_ids is not None:
            ids = torch.as_tensor(np.asarray(user_ids, np.int64)).to(self.device)
            rows = picks[0][1].u_replica[ids]
        rows = rows.to(self.device)
        b = rows.shape[0]
        fetch = topk
        if exclude is not None:
            if len(exclude) != b:
                raise ValueError(f"{len(exclude)} exclusion lists for {b} rows")
            fetch = topk + max((len(e) for e in exclude), default=0)
        if fetch_hint is not None:
            fetch = max(fetch, fetch_hint)
        # a power of two: every caller folds onto O(log n_items) kernel shapes
        fetch = 1 << (fetch - 1).bit_length()
        fetch = min(fetch, ens.n_items)
        vals, idx = self._gather_merge(picks, fetch, rows=rows)
        vals = vals.cpu().numpy() + np.float32(ens.global_mean)
        idx = idx.cpu().numpy().astype(np.int32)
        if exclude is None:
            return vals[:, :topk], idx[:, :topk]
        out_v = np.full((b, topk), -np.inf, np.float32)
        out_i = np.full((b, topk), -1, np.int32)
        for r in range(b):
            keep = ~np.isin(idx[r], exclude[r])
            kept_v, kept_i = vals[r][keep][:topk], idx[r][keep][:topk]
            out_v[r, : len(kept_v)] = kept_v
            out_i[r, : len(kept_i)] = kept_i
        return out_v, out_i

    def recommend_rows(self, rows: torch.Tensor, topk: int, *,
                       exclude: list[np.ndarray] | None = None,
                       fetch_hint: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Top-N for explicit scoring rows (B, S*K). `exclude` drops items
        per row; `fetch_hint` pins the candidate count. Returns host arrays
        (values (B, topk), indices (B, topk)); rows with fewer than topk
        candidates left are padded with (-inf, -1)."""
        return self._serve(topk, rows=rows, exclude=exclude,
                           fetch_hint=fetch_hint)

    def recommend(self, user_ids, topk: int, *, seen=None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Top-N for trained users; `seen` (a SeenIndex, or SparseRatings
        indexed on each call) excludes each user's rated items."""
        from repro_torch.serve.topn import SeenIndex  # topn subclasses us

        user_ids = np.asarray(user_ids, np.int32)
        exclude = fetch_hint = None
        if seen is not None:
            if not isinstance(seen, SeenIndex):
                seen = SeenIndex(seen)
            exclude = [seen[int(u)] for u in user_ids]
            fetch_hint = topk + seen.max_degree
        return self._serve(topk, user_ids=user_ids, exclude=exclude,
                           fetch_hint=fetch_hint)
