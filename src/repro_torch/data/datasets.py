"""Synthetic dataset generators shaped like the paper's benchmarks.

The paper evaluates on ChEMBL (1,023,952 ratings; 483,500 compounds x 5,775
targets; heavy power-law degree skew, Fig 2) and MovieLens ml-20m (20M
ratings; 138,493 users x 27,278 movies). No network access is available here,
so we generate synthetic matrices with matching shapes and degree statistics:
a ground-truth low-rank model plus observation noise, sampled with a power-law
popularity profile so the load-balancing machinery faces the same skew the
paper's Fig 2 shows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import SparseRatings, stable_argsort


def synthetic_lowrank(
    n_users: int,
    n_items: int,
    k_true: int,
    nnz: int,
    *,
    noise: float = 0.3,
    popularity_exponent: float = 1.1,
    seed: int = 0,
    clip: tuple[float, float] | None = None,
) -> tuple[SparseRatings, np.ndarray, np.ndarray]:
    """Low-rank + noise ratings with power-law item popularity.

    Returns (ratings, U_true, V_true). Ratings are r_ij = u_i . v_j + eps.
    """
    rng = np.random.default_rng(seed)
    u_true = rng.normal(0.0, 1.0 / np.sqrt(k_true), size=(n_users, k_true))
    v_true = rng.normal(0.0, 1.0 / np.sqrt(k_true), size=(n_items, k_true))

    # Power-law popularity over items, mild skew over users.
    item_p = (np.arange(1, n_items + 1, dtype=np.float64)) ** (-popularity_exponent)
    item_p /= item_p.sum()
    user_p = (np.arange(1, n_users + 1, dtype=np.float64)) ** (-0.6)
    user_p /= user_p.sum()

    # Oversample then dedupe (user, item) pairs to reach ~nnz unique ratings.
    # Cap at half density — beyond that rejection sampling stalls.
    target = min(nnz, n_users * n_items // 2)
    rows_list, cols_list = [], []
    seen = torch.empty(0, dtype=torch.int64)   # the keys kept so far, sorted
    attempts = 0
    while sum(len(r) for r in rows_list) < target and attempts < 8:
        m = int((target - sum(len(r) for r in rows_list)) * 1.4) + 16
        r = _choice(rng, n_users, m, user_p)
        c = _choice(rng, n_items, m, item_p)
        keys = r.astype(np.int64) * n_items + c
        fresh = ~_isin(keys, seen)
        keys_f = keys[fresh]
        # in-batch dedupe: the first of each key
        order = stable_argsort(keys_f)
        ordered = keys_f[order]
        first = order[np.append(True, ordered[1:] != ordered[:-1])]
        keep = np.zeros(len(keys_f), dtype=bool)
        keep[first] = True
        r2, c2 = r[fresh][keep], c[fresh][keep]
        seen = torch.sort(torch.cat([seen, torch.from_numpy(keys_f[keep])])).values
        rows_list.append(r2)
        cols_list.append(c2)
        attempts += 1
    rows = np.concatenate(rows_list)[:target].astype(np.int32)
    cols = np.concatenate(cols_list)[:target].astype(np.int32)

    # u_i . v_j a block of rows at a time (each row's sum as in one einsum),
    # not the (nnz, k) gathers at once: 2.6 GB each for movielens_like(1.0)
    step = 1 << 20
    dots = np.concatenate([np.einsum("nk,nk->n", u_true[rows[i:i + step]],
                                     v_true[cols[i:i + step]])
                           for i in range(0, len(rows), step)]) if len(rows) else \
        np.zeros(0)
    vals = dots + rng.normal(0.0, noise, size=rows.shape)
    if clip is not None:
        vals = np.clip(vals, *clip)
    ratings = SparseRatings(
        rows=rows,
        cols=cols,
        vals=vals.astype(np.float32),
        shape=(n_users, n_items),
    )
    ratings.validate()
    return ratings, u_true, v_true


def _choice(rng: np.random.Generator, n: int, size: int, p: np.ndarray) -> np.ndarray:
    """rng.choice(n, size=size, p=p), the same draws: numpy's inverse-CDF
    sampling (one rng.random(size), then the right-side search of its CDF),
    the search by torch's, which spreads over the host's threads."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    u = rng.random(size)
    return torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(u), right=True).numpy()


def _isin(keys: np.ndarray, ordered: torch.Tensor) -> np.ndarray:
    """np.isin(keys, ordered) for sorted unique `ordered`."""
    if not len(ordered):
        return np.zeros(len(keys), bool)
    k = torch.from_numpy(keys)
    at = torch.searchsorted(ordered, k).clamp_(max=len(ordered) - 1)
    return (ordered[at] == k).numpy()


def chembl_like(
    scale: float = 1.0, seed: int = 0
) -> tuple[SparseRatings, np.ndarray, np.ndarray]:
    """ChEMBL-shaped benchmark: 483,500 x 5,775 with ~1.02M ratings at scale=1.

    IC50-style activities modelled as low-rank (k=16) + noise. `scale` shrinks
    every dimension proportionally for CPU-sized runs.
    """
    n_users = max(32, int(483_500 * scale))
    n_items = max(16, int(5_775 * scale))
    nnz = max(64, int(1_023_952 * scale))
    return synthetic_lowrank(
        n_users, n_items, k_true=16, nnz=nnz, noise=0.4,
        popularity_exponent=1.2, seed=seed,
    )


def movielens_like(
    scale: float = 1.0, seed: int = 0
) -> tuple[SparseRatings, np.ndarray, np.ndarray]:
    """ml-20m-shaped benchmark: 138,493 x 27,278 with ~20M ratings at scale=1."""
    n_users = max(32, int(138_493 * scale))
    n_items = max(16, int(27_278 * scale))
    nnz = max(64, int(20_000_000 * scale))
    return synthetic_lowrank(
        n_users, n_items, k_true=16, nnz=nnz, noise=0.5,
        popularity_exponent=1.0, seed=seed, clip=(-2.5, 2.5),
    )


def train_test_split(
    ratings: SparseRatings, test_frac: float = 0.1, seed: int = 0
) -> tuple[SparseRatings, SparseRatings]:
    rng = np.random.default_rng(seed)
    nnz = ratings.nnz
    perm = rng.permutation(nnz)
    n_test = int(nnz * test_frac)
    test_idx, train_idx = perm[:n_test], perm[n_test:]

    def take(idx: np.ndarray) -> SparseRatings:
        return SparseRatings(
            rows=ratings.rows[idx],
            cols=ratings.cols[idx],
            vals=ratings.vals[idx],
            shape=ratings.shape,
        )

    return take(train_idx), take(test_idx)
