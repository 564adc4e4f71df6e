"""Degree-bucketed update plans — the static analogue of the paper's work stealing.

A copy of `repro.core.buckets` (numpy only), kept here so that the port
imports nothing of the JAX package; the tests hold the two to array-equal
plans. The known `balanced_widths` overshoot of the reference (a
`max_buckets=1` budget can come back with two widths when some degree
exceeds `max_width`) is reproduced on purpose: sweep parity rests on plan
parity.

The paper (Sec 3.2, Fig 2-3) observes that item update cost is `fixed +
c * n_ratings` with a heavy power-law tail, and balances it with TBB work
stealing. A batched device sweep balances statically instead: items are
binned by degree into padded buckets, each a dense (rows, width) block:

    indices (rows, width) int32   -- counterpart item ids, padded
    values  (rows, width) f32     -- ratings, padded with 0
    mask    (rows, width) f32     -- 1 for real ratings
    item_ids (rows,)      int32   -- which item each row contributes to
    seg_ids  (rows,)      int32   -- dense segment id within the bucket

Items whose degree exceeds the widest bucket are *split* across several rows
of that bucket and recombined with a segment sum. Two planners share the
schema: a fixed ladder (`widths=(8, 32, 128, 512)` or any explicit tuple)
and the **balanced** planner (`widths="balanced"`), which fits the ladder to
the degree histogram by an exact interval-partition DP over distinct
degrees under the `workload_model` cost.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

DEFAULT_WIDTHS = (8, 32, 128, 512)

#: accepted by every `widths=` parameter that feeds `plan_buckets`
BALANCED = "balanced"

WidthsSpec = Union[str, Sequence[int]]


@dataclass(frozen=True)
class Bucket:
    width: int
    indices: np.ndarray  # (rows, width) int32
    values: np.ndarray   # (rows, width) f32
    mask: np.ndarray     # (rows, width) f32
    item_ids: np.ndarray  # (rows,) int32 — global item index this row feeds
    seg_ids: np.ndarray   # (rows,) int32 — dense segment id inside the bucket
    n_segments: int       # number of distinct items in the bucket
    seg_item_ids: np.ndarray  # (n_segments,) int32 — global item id per segment

    @property
    def rows(self) -> int:
        return int(self.indices.shape[0])


@dataclass(frozen=True)
class BucketPlan:
    n_items: int
    n_counterparts: int
    buckets: tuple[Bucket, ...]
    nnz: int
    padded: int
    empty_items: Optional[np.ndarray] = None  # items with no ratings
    widths: Optional[tuple[int, ...]] = None  # the resolved width ladder

    @property
    def padding_efficiency(self) -> float:
        """Fraction of padded lanes doing useful work (1.0 = perfect balance)."""
        return self.nnz / max(self.padded, 1)

    def stats(self) -> dict:
        return {
            "n_items": self.n_items,
            "nnz": self.nnz,
            "padded": self.padded,
            "padding_efficiency": round(self.padding_efficiency, 4),
            "widths": list(self.widths) if self.widths else None,
            "buckets": [
                {"width": b.width, "rows": b.rows, "segments": b.n_segments}
                for b in self.buckets
            ],
        }


def balanced_widths(
    degrees: np.ndarray,
    *,
    max_buckets: int = 8,
    lane: int = 1,
    max_width: int = 512,
    fixed_cost: float = 1.0,
    per_rating: float = 0.02,
) -> tuple[int, ...]:
    """Degree-aware width ladder: the static equivalent of work stealing.

    The paper's scheduler balances `cost = fixed + c * n_ratings` across
    cores at run time; the static analogue is choosing bucket widths so the
    *padded* plan carries as little dead cost as possible. Every item of
    degree d placed in a width-w bucket costs one row of
    `workload_model(w)`, so for a candidate ladder the total padded cost is

        sum_items workload_model(width(item))  (+ split rows, see below)

    and the row count is fixed (one row per unsplit item) — minimizing the
    cost is exactly minimizing padded lanes, with `fixed_cost` only acting
    through the split items' chunk count. The optimal ladder under a bucket
    budget is an interval partition of the distinct-degree axis, found
    exactly by DP (O(D^2 * max_buckets) on D <= max_width distinct values —
    microseconds, done once at plan time).

    Items with degree > max_width are split across rows of a forced
    `max_width` bucket (chunking keeps their per-row fill near 1, and the
    DP's remaining buckets fit the small-degree mass). `lane` rounds widths
    up (lane=8 keeps every bucket 8-lane aligned for the fused kernel;
    the default lane=1 maximizes lane efficiency for the einsum engines —
    `kernels/ops.py` re-pads to 8-lane tiles on the kernel path either way).
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    degrees = np.asarray(degrees)
    d = degrees[(degrees > 0) & (degrees <= max_width)]
    oversize = degrees[degrees > max_width]

    def lane_up(w: int) -> int:
        return -(-int(w) // lane) * lane

    if d.size == 0:
        return (lane_up(max_width if oversize.size else lane),)

    ds, cs = np.unique(d, return_counts=True)
    m = len(ds)
    budget = max_buckets - (1 if oversize.size else 0)
    budget = max(budget, 1)
    row_cost = fixed_cost + per_rating * np.array(
        [lane_up(x) for x in ds], np.float64
    )
    csum = np.concatenate([[0], np.cumsum(cs)])      # csum[i] = count of ds[:i]

    if m <= budget:
        cuts = list(range(1, m + 1))
    else:
        # f[b, i] = min cost covering ds[:i] with b+1 buckets, the last
        # bucket ending exactly at ds[i-1] (its width); arg[b, i] = best j
        inf = np.inf
        f = np.full((budget, m + 1), inf)
        arg = np.zeros((budget, m + 1), np.int64)
        f[0, 1:] = csum[1:] * row_cost                # one bucket up to ds[i-1]
        for b in range(1, budget):
            for i in range(b + 1, m + 1):
                # last bucket spans ds[j..i-1]; vectorized over j
                j = np.arange(b, i)
                cand = f[b - 1, j] + (csum[i] - csum[j]) * row_cost[i - 1]
                best = int(np.argmin(cand))
                f[b, i] = cand[best]
                arg[b, i] = j[best]
        b_best = int(np.argmin(f[:, m]))
        cuts = [m]
        b, i = b_best, m
        while b > 0:
            i = int(arg[b, i])
            cuts.append(i)
            b -= 1
        cuts = sorted(cuts)
    widths = {lane_up(ds[i - 1]) for i in cuts}
    if oversize.size:
        widths.add(lane_up(max_width))
    return tuple(sorted(widths))


def resolve_widths(
    widths: WidthsSpec,
    degrees: np.ndarray,
    **balanced_kwargs,
) -> tuple[int, ...]:
    """An explicit ladder passes through sorted; `"balanced"` is resolved
    from the degree distribution via `balanced_widths`."""
    if isinstance(widths, str):
        if widths != BALANCED:
            raise ValueError(
                f"widths must be a tuple of ints or {BALANCED!r}, got {widths!r}"
            )
        return balanced_widths(degrees, **balanced_kwargs)
    return tuple(sorted(int(w) for w in widths))


def plan_buckets(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    n_items: int,
    n_counterparts: int,
    widths: WidthsSpec = DEFAULT_WIDTHS,
) -> BucketPlan:
    """Build a bucketed plan from CSR (indptr over items).

    widths: an explicit ladder, or `"balanced"` to fit the ladder to this
    CSR's degree histogram (`balanced_widths`).
    """
    degrees = np.diff(indptr)
    assert len(degrees) == n_items
    widths = resolve_widths(widths, degrees)

    buckets: list[Bucket] = []
    nnz_total = int(degrees.sum())
    padded_total = 0

    max_w = widths[-1]
    # Assign each item to the smallest width that fits; oversize items go to
    # the widest bucket, split into ceil(deg / max_w) rows.
    fits = np.searchsorted(np.asarray(widths), degrees, side="left")
    fits = np.clip(fits, 0, len(widths) - 1)

    for wi, w in enumerate(widths):
        if wi < len(widths) - 1:
            sel = np.where((fits == wi) & (degrees > 0))[0]
            n_rows_per_item = np.ones(len(sel), dtype=np.int64)
        else:
            sel = np.where((fits == wi) & (degrees > 0))[0]
            n_rows_per_item = np.maximum(1, -(-degrees[sel] // w))
        if len(sel) == 0:
            continue
        total_rows = int(n_rows_per_item.sum())
        idx = np.zeros((total_rows, w), dtype=np.int32)
        val = np.zeros((total_rows, w), dtype=np.float32)
        msk = np.zeros((total_rows, w), dtype=np.float32)
        row_item = np.zeros(total_rows, dtype=np.int32)
        row_seg = np.zeros(total_rows, dtype=np.int32)

        r = 0
        for seg, item in enumerate(sel):
            start, end = indptr[item], indptr[item + 1]
            deg = end - start
            for chunk0 in range(0, max(deg, 1), w):
                chunk = indices[start + chunk0 : min(start + chunk0 + w, end)]
                cvals = values[start + chunk0 : min(start + chunk0 + w, end)]
                idx[r, : len(chunk)] = chunk
                val[r, : len(chunk)] = cvals
                msk[r, : len(chunk)] = 1.0
                row_item[r] = item
                row_seg[r] = seg
                r += 1
        assert r == total_rows
        buckets.append(
            Bucket(
                width=w,
                indices=idx,
                values=val,
                mask=msk,
                item_ids=row_item,
                seg_ids=row_seg,
                n_segments=len(sel),
                seg_item_ids=sel.astype(np.int32),
            )
        )
        padded_total += total_rows * w

    empty = np.where(degrees == 0)[0].astype(np.int32)
    return BucketPlan(
        n_items=n_items,
        n_counterparts=n_counterparts,
        buckets=tuple(buckets),
        nnz=nnz_total,
        padded=padded_total,
        empty_items=empty,
        widths=widths,
    )


def pad_bucket(bucket: Bucket, rows: int, segments: int) -> Bucket:
    """Pad a bucket to (rows, segments) — mask-zero rows and zero-sum
    segments, so the padded plan computes identical statistics.

    Pad rows carry mask 0 (their gathered factors are zeroed before the
    syrk) and point at the LAST padded segment / item 0, contributing exact
    zeros while keeping `seg_ids` nondecreasing — the invariant the fused
    gather-syrk kernel's in-kernel segment reduction relies on. Pad
    segments receive only zero contributions and scatter them into item 0.
    This is how the fold-in plan cache maps every batch with a similar
    rating-count profile onto one quantized set of array shapes, so the
    compiled executables are reused across batches.
    """
    if rows < bucket.rows or segments < bucket.n_segments:
        raise ValueError(
            f"cannot pad bucket of ({bucket.rows} rows, {bucket.n_segments} "
            f"segments) down to ({rows}, {segments})"
        )
    pr = rows - bucket.rows
    ps = segments - bucket.n_segments
    if pr == 0 and ps == 0:
        return bucket
    w = bucket.width
    return Bucket(
        width=w,
        indices=np.concatenate([bucket.indices, np.zeros((pr, w), np.int32)]),
        values=np.concatenate([bucket.values, np.zeros((pr, w), np.float32)]),
        mask=np.concatenate([bucket.mask, np.zeros((pr, w), np.float32)]),
        item_ids=np.concatenate([bucket.item_ids, np.zeros(pr, np.int32)]),
        seg_ids=np.concatenate(
            [bucket.seg_ids, np.full(pr, segments - 1, np.int32)]
        ),
        n_segments=segments,
        seg_item_ids=np.concatenate(
            [bucket.seg_item_ids, np.zeros(ps, np.int32)]
        ),
    )


def workload_model(degrees: np.ndarray, fixed_cost: float = 1.0, per_rating: float = 0.02):
    """The paper's Sec 4.2 workload model: cost = fixed + c * n_ratings.

    Used by the LPT partitioner to balance shards. Constants follow the shape
    of Fig 3 (small items dominated by the K^3 Cholesky fixed cost, large
    items by the per-rating syrk cost).
    """
    return fixed_cost + per_rating * degrees.astype(np.float64)
