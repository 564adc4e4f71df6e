"""Host-side P x P grid partitioning of R for the distributed sampler.

A copy of `repro.core.partition` (numpy only), kept here so that the port
imports nothing of the JAX package; the tests hold the two to array-equal
plans. The grid plan's per-rating loops are vectorised: the same rows, in
the same order, with the same contents.

The paper's Sec 4.2: U and V are row-sharded across nodes; R is reordered
into a P x P block grid so that shard p's item updates touch counterpart
block q only during ring step (p - q) mod P. Shard assignment is LPT
(longest-processing-time) bin packing under the paper's workload model
`cost = fixed + c * degree`, the static equivalent of TBB work stealing.
Every (p, q) block is padded to the global max row count: the padding
ratio is the residual load imbalance, reported in the stats.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.core.buckets import workload_model
from repro_torch.data.sparse import SparseRatings


@dataclass(frozen=True)
class EntityPartition:
    shard: np.ndarray        # (N,) shard id per entity
    local: np.ndarray        # (N,) local slot within its shard
    n_loc: int               # padded per-shard entity count
    ids: np.ndarray          # (P, n_loc) global entity id, -1 for padding


def partition_entities(degrees: np.ndarray, n_shards: int) -> EntityPartition:
    """LPT assignment via a min-heap of shard loads, O(N log P): entities in
    decreasing cost each go to the least-loaded shard, ties to the lowest
    shard id, each shard's load summed in assignment order."""
    n = len(degrees)
    cost = workload_model(degrees)
    order = np.argsort(-cost, kind="stable")
    count = [0] * n_shards
    shard = np.zeros(n, dtype=np.int32)
    local = np.zeros(n, dtype=np.int32)
    # (load, shard id) tuples: equal loads pop the lowest id first. Python
    # floats are IEEE doubles, so the loads are the reference's float64 sums.
    heap = [(0.0, p) for p in range(n_shards)]
    cost_of = cost.tolist()
    for e in order.tolist():
        load, p = heap[0]
        shard[e] = p
        local[e] = count[p]
        count[p] += 1
        heapq.heapreplace(heap, (load + cost_of[e], p))
    n_loc = max(count)
    ids = np.full((n_shards, n_loc), -1, dtype=np.int32)
    ids[shard, local] = np.arange(n, dtype=np.int32)
    return EntityPartition(shard=shard, local=local, n_loc=n_loc, ids=ids)


@dataclass(frozen=True)
class GridPlan:
    """Ring-sweep plan for updating one entity set from its counterpart.

    indices/values/mask: (P, P, R, W) — [p, q] holds the width-W padded rows
    of shard p's items whose ratings touch counterpart block q, with indices
    LOCAL to block q. seg: (P, P, R) local item slot each row feeds
    (n_loc = padding slot). R is the max row count over all (p, q). Rows in
    a block are sorted by local item slot (pad rows last), so `seg` is
    nondecreasing per block.

    seg_dense/seg_map support the fused gather-syrk engine's in-kernel
    segment reduction, which needs DENSE nondecreasing segment ids:
    seg_dense[p, q] renumbers a block's distinct seg values 0..d-1 in row
    order; seg_map[p, q, j] is the local item slot dense segment j feeds
    (n_loc for the pad segment and for unused trailing entries).
    """

    n_shards: int
    n_loc: int               # local item slots per shard
    n_counter_loc: int       # counterpart block size
    width: int
    indices: np.ndarray
    values: np.ndarray
    mask: np.ndarray
    seg: np.ndarray
    item_ids: np.ndarray     # (P, n_loc) global ids (-1 pad)
    nnz: int
    seg_dense: np.ndarray    # (P, P, R) dense per-block segment ids
    seg_map: np.ndarray      # (P, P, R) local item slot per dense segment

    @property
    def padded_lanes(self) -> int:
        return int(np.prod(self.indices.shape))

    def stats(self) -> dict:
        rows_used = int(self.mask.any(-1).sum())
        return {
            "shards": self.n_shards,
            "rows_per_block": int(self.indices.shape[2]),
            "width": self.width,
            "nnz": self.nnz,
            "lane_efficiency": round(self.nnz / max(self.padded_lanes, 1), 4),
            "row_fill": round(rows_used / max(np.prod(self.indices.shape[:3]), 1), 4),
        }


def _auto_width(lengths: np.ndarray, block: np.ndarray) -> int:
    """The padded-lane-minimising row width: every lane-rounded candidate w
    is scored by R_max(w) * w over the blocks that hold ratings, ties to
    the narrower width. lengths: ratings of each (block, item) group,
    block: its block id."""
    uniq = np.unique(lengths) if lengths.size else np.array([1], np.int64)
    cands = sorted({int(min(512, max(4, -(-int(n) // 4) * 4))) for n in uniq})

    def padded_lanes(w: int) -> int:
        rows = np.bincount(block, weights=-(-lengths // w)) if lengths.size else [1]
        return max(int(np.max(rows)), 1) * w

    return min(cands, key=lambda w: (padded_lanes(w), w))


def build_grid_plan(
    ratings: SparseRatings,
    item_part: EntityPartition,
    counter_part: EntityPartition,
    *,
    width: int | str = 32,
) -> GridPlan:
    """Plan updates of the ROW entities of `ratings` from its COLUMN entities.

    ``width="auto"`` picks the padded-lane-minimizing row width for this
    grid's degree profile (the distributed analogue of the balanced bucket
    planner): every candidate lane-rounded width w is scored by
    R_max(w) * w — the per-block padded footprint the sweep actually
    allocates — and ties go to the narrower width.
    """
    n_shards = item_part.ids.shape[0]
    n_loc = item_part.n_loc

    # ratings grouped by (p, q, local item), each group in (row, col) order
    order = np.lexsort((ratings.cols, ratings.rows))
    rows, cols = ratings.rows[order], ratings.cols[order]
    vals = ratings.vals[order]
    p = item_part.shard[rows].astype(np.int64)
    q = counter_part.shard[cols].astype(np.int64)
    litem = item_part.local[rows].astype(np.int64)
    group_order = np.lexsort((litem, q, p))      # stable: keeps (row, col) order
    p, q, litem = p[group_order], q[group_order], litem[group_order]
    lcol = counter_part.local[cols[group_order]]
    vals = vals[group_order]

    nnz = len(vals)
    new = np.ones(nnz, bool)
    new[1:] = (p[1:] != p[:-1]) | (q[1:] != q[:-1]) | (litem[1:] != litem[:-1])
    start = np.flatnonzero(new)                   # first rating of each group
    lengths = np.diff(np.append(start, nnz))
    g_block = p[start] * n_shards + q[start]

    if width == "auto":
        width = _auto_width(lengths, g_block)
    width = int(width)

    # rows after width-chunking: a group's chunks follow each other, groups
    # in local item order within their block
    chunks = -(-lengths // width)
    rows_per_block = np.bincount(g_block, weights=chunks, minlength=n_shards ** 2)
    r_max = max(int(rows_per_block.max()) if nnz else 1, 1)
    first_chunk = np.cumsum(chunks) - chunks      # global chunk number of each group
    block_first = np.zeros(n_shards ** 2, np.int64)
    if nnz:
        firsts = np.flatnonzero(np.append(True, g_block[1:] != g_block[:-1]))
        block_first[g_block[firsts]] = first_chunk[firsts]
    g_row = first_chunk - block_first[g_block]    # the group's first row in its block

    group = np.cumsum(new) - 1
    pos = np.arange(nnz) - start[group]
    r = g_row[group] + pos // width
    w = pos % width

    idx = np.zeros((n_shards, n_shards, r_max, width), np.int32)
    val = np.zeros((n_shards, n_shards, r_max, width), np.float32)
    msk = np.zeros((n_shards, n_shards, r_max, width), np.float32)
    seg = np.full((n_shards, n_shards, r_max), n_loc, np.int32)
    idx[p, q, r, w] = lcol
    val[p, q, r, w] = vals
    msk[p, q, r, w] = 1.0
    seg[p, q, r] = litem

    # dense per-block renumbering of the (sorted) seg values + the map back
    # to local item slots, for the fused engine's in-kernel reduction
    flat = seg.reshape(-1, r_max)
    change = np.ones(flat.shape, bool)
    change[:, 1:] = flat[:, 1:] != flat[:, :-1]
    dense = np.cumsum(change, axis=1) - 1
    seg_map = np.full(flat.shape, n_loc, np.int32)
    b, j = np.nonzero(change)
    seg_map[b, dense[b, j]] = flat[b, j]

    shape = (n_shards, n_shards, r_max)
    return GridPlan(
        n_shards=n_shards,
        n_loc=n_loc,
        n_counter_loc=counter_part.n_loc,
        width=width,
        indices=idx,
        values=val,
        mask=msk,
        seg=seg,
        item_ids=item_part.ids,
        nnz=ratings.nnz,
        seg_dense=dense.astype(np.int32).reshape(shape),
        seg_map=seg_map.reshape(shape),
    )
