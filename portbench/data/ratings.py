"""Synthetic rating matrices shaped like the paper's benchmarks, drawn on
the device from a seed.

Frozen from `src/repro_torch/data/datasets.py` at commit 3b55c50
(`synthetic_lowrank`, `chembl_like`, `movielens_like`, `train_test_split`)
and rewritten to draw with a `torch.Generator` on the device in a few large
calls: the same shapes, the same power-law profiles (item popularity
i^-item_exponent, user activity i^-user_exponent), the same oversample-and-
dedupe of (user, item) pairs, ratings u_i . v_j + N(0, noise), optionally
clipped, and the same 0.9 / 0.1 split.

Three things differ on purpose. The sparsity pattern and its split are
drawn from the configuration's fixed `structure_seed`; `--seed` draws
everything else: a permutation of the user ids and of the item ids, the
order of the ratings, the true factors and the noise. So every seed gives
the same multiset of degrees, and the same bucket plans up to a
relabelling: the same work in another order. The oversampling rounds go
on until the pattern holds exactly `nnz` pairs (the original stops after
8 rounds, a few pairs short at ml-20m's size). And where the
configuration sets `every_user_rated`, as the real ChEMBL set is, each
user left without a pair gets one, on an item drawn from the item
profile, in place of a pair drawn at random from the users with two or
more.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.data.seeds import generator


@dataclass
class Ratings:
    """COO ratings on one device: rows, cols int64, vals float32."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def degrees(self, axis: int) -> torch.Tensor:
        idx = self.rows if axis == 0 else self.cols
        return torch.bincount(idx, minlength=self.shape[axis])


@dataclass
class Split:
    train: Ratings
    test: Ratings


def _inverse_cdf(n: int, exponent: float, device) -> torch.Tensor:
    p = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** (-exponent)
    cdf = p.cumsum(0)
    return cdf / cdf[-1]


def _draw_pairs(m: int, user_cdf, item_cdf, n_items: int, gen) -> torch.Tensor:
    """m (user, item) keys user * n_items + item, each side drawn by the
    inverse CDF of its profile (numpy's `choice(p=...)`)."""
    dev = user_cdf.device
    r = torch.searchsorted(user_cdf, torch.rand(m, generator=gen, device=dev,
                                                dtype=torch.float64), right=True)
    c = torch.searchsorted(item_cdf, torch.rand(m, generator=gen, device=dev,
                                                dtype=torch.float64), right=True)
    r.clamp_(max=user_cdf.shape[0] - 1)
    c.clamp_(max=n_items - 1)
    return r * n_items + c


#: oversampling rounds before the pattern is taken as it is
MAX_ROUNDS = 64


def _rate_every_user(kept: torch.Tensor, n_users: int, n_items: int, item_cdf,
                     gen) -> torch.Tensor:
    """`kept` (sorted keys) with one pair for each user that has none, in
    place of as many pairs of users with two or more: never a user's first
    pair, so no user is left without one."""
    dev = kept.device
    rows = kept // n_items
    has = torch.zeros(n_users, dtype=torch.bool, device=dev)
    has[rows] = True
    missing = torch.nonzero(~has).squeeze(1)
    if missing.shape[0] == 0:
        return kept
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    spare = torch.nonzero(~first).squeeze(1)
    drop = spare[torch.randperm(spare.shape[0], generator=gen, device=dev)[:missing.shape[0]]]
    keep = torch.ones_like(first)
    keep[drop] = False
    c = torch.searchsorted(item_cdf, torch.rand(missing.shape[0], generator=gen, device=dev,
                                                 dtype=torch.float64), right=True)
    added = missing * n_items + c.clamp_(max=n_items - 1)
    return torch.sort(torch.cat([kept[keep], added])).values


def pattern(n_users: int, n_items: int, nnz: int, *, item_exponent: float,
            user_exponent: float, structure_seed: int, test_frac: float,
            device, every_user_rated: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixed sparsity pattern: (rows, cols) of the `nnz` distinct pairs
    (at most half the matrix) and a boolean mask of the test split. Pairs
    are oversampled 1.4x and deduplicated, round after round, until there
    are `nnz`; where a round brings more new pairs than are wanted, a
    random subset of them is kept. `every_user_rated`: see the module's
    head."""
    gen = generator(structure_seed, "pattern", device)
    user_cdf = _inverse_cdf(n_users, user_exponent, device)
    item_cdf = _inverse_cdf(n_items, item_exponent, device)
    target = min(nnz, n_users * n_items // 2)
    kept = torch.empty(0, dtype=torch.int64, device=device)   # sorted, unique
    for _ in range(MAX_ROUNDS):
        need = target - kept.shape[0]
        if need <= 0:
            break
        keys = torch.unique(_draw_pairs(int(need * 1.4) + 16, user_cdf, item_cdf,
                                        n_items, gen))
        at = torch.searchsorted(kept, keys).clamp_(max=max(kept.shape[0] - 1, 0))
        fresh = keys if kept.shape[0] == 0 else keys[kept[at] != keys]
        if fresh.shape[0] > need:
            fresh = fresh[torch.randperm(fresh.shape[0], generator=gen,
                                         device=device)[:need]]
        kept = torch.sort(torch.cat([kept, fresh])).values
    if every_user_rated:
        kept = _rate_every_user(kept, n_users, n_items, item_cdf, gen)
    keys = kept[torch.randperm(kept.shape[0], generator=gen, device=device)]
    n_test = int(keys.shape[0] * test_frac)
    is_test = torch.zeros(keys.shape[0], dtype=torch.bool, device=device)
    is_test[:n_test] = True
    return keys // n_items, keys % n_items, is_test


def ratings(cfg: dict, seed: int, device) -> Split:
    """The configuration's train and test ratings for `seed` on `device`.

    `cfg["data"]` holds n_users, n_items, nnz, k_true, noise,
    item_exponent, user_exponent, clip (null or [lo, hi]), test_frac and
    structure_seed, and optionally every_user_rated."""
    d = cfg["data"]
    m, n = int(d["n_users"]), int(d["n_items"])
    rows, cols, is_test = pattern(
        m, n, int(d["nnz"]), item_exponent=float(d["item_exponent"]),
        user_exponent=float(d["user_exponent"]),
        structure_seed=int(d["structure_seed"]), test_frac=float(d["test_frac"]),
        device=device, every_user_rated=bool(d.get("every_user_rated", False)))
    gen = generator(seed, "ratings", device)
    user_id = torch.randperm(m, generator=gen, device=device)
    item_id = torch.randperm(n, generator=gen, device=device)
    rows, cols = user_id[rows], item_id[cols]
    k_true = int(d["k_true"])
    scale = k_true ** -0.5
    u_true = scale * torch.randn((m, k_true), generator=gen, device=device)
    v_true = scale * torch.randn((n, k_true), generator=gen, device=device)
    vals = torch.empty(rows.shape[0], dtype=torch.float32, device=device)
    step = 1 << 20
    for i in range(0, rows.shape[0], step):
        r, c = rows[i:i + step], cols[i:i + step]
        vals[i:i + step] = (u_true[r] * v_true[c]).sum(-1)
    vals += float(d["noise"]) * torch.randn(vals.shape, generator=gen, device=device)
    if d.get("clip") is not None:
        vals.clamp_(float(d["clip"][0]), float(d["clip"][1]))

    def part(sel: torch.Tensor) -> Ratings:
        idx = torch.nonzero(sel).squeeze(1)
        idx = idx[torch.randperm(idx.shape[0], generator=gen, device=device)]
        return Ratings(rows[idx].contiguous(), cols[idx].contiguous(),
                       vals[idx].contiguous(), (m, n))

    return Split(train=part(~is_test), test=part(is_test))
