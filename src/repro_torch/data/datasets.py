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

from repro_torch.data.sparse import SparseRatings


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
    seen: set[int] = set()
    attempts = 0
    while sum(len(r) for r in rows_list) < target and attempts < 8:
        m = int((target - sum(len(r) for r in rows_list)) * 1.4) + 16
        r = rng.choice(n_users, size=m, p=user_p)
        c = rng.choice(n_items, size=m, p=item_p)
        keys = r.astype(np.int64) * n_items + c
        fresh = np.array([k not in seen for k in keys], dtype=bool)
        keys_f = keys[fresh]
        # in-batch dedupe
        _, first = np.unique(keys_f, return_index=True)
        keep = np.zeros(len(keys_f), dtype=bool)
        keep[first] = True
        r2, c2 = r[fresh][keep], c[fresh][keep]
        seen.update(keys_f[keep].tolist())
        rows_list.append(r2)
        cols_list.append(c2)
        attempts += 1
    rows = np.concatenate(rows_list)[:target].astype(np.int32)
    cols = np.concatenate(cols_list)[:target].astype(np.int32)

    vals = np.einsum("nk,nk->n", u_true[rows], v_true[cols]) + rng.normal(
        0.0, noise, size=rows.shape
    )
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
