"""Cold-start fold-in: batched conditional posteriors for unseen users
(`repro.serve.foldin`, ported).

A user who arrives after training has no row in any retained U_s, but the
model defines their conditional posterior given each draw's item factors
and user hyperparameters:

    Lambda_b^s = Lambda_u^s + alpha * sum_j v_j^s v_j^s^T   (j rated by b)
    rhs_b^s    = Lambda_u^s mu_u^s + alpha * sum_j r_bj v_j^s
    u_b^s      ~ N((Lambda_b^s)^-1 rhs_b^s, (Lambda_b^s)^-1)

which is the per-item update of the training sweep. The bucket plan of a
batch does not depend on the draw, so one launch a bucket covers all S
draws (`gather_syrk_seg` with its stacked-draw axis under engine "fused",
`masked_syrk` with S folded into rows under "kernel"), and the S*B systems
are solved in one call over an (S, B, K, K) stack (`chol_solve_sample`
under "kernel", the library's Cholesky and substitution otherwise, as the
reference chooses). `fold_in_loop` keeps the per-draw loop as the
reference implementation.

The noise is explicit: `fold_in(generator, ..., z=...)` takes (S, B, K)
standard normals, or draws them from `generator`; the posterior mean
(sample=False) is the z = 0 limb of the same solve.

`FoldInPlanCache` quantizes a batch's rating-count profile (each bucket's
rows and segments, and the batch size, rounded up to powers of two), so
batches of similar profile share one set of padded shapes. The port has
no jit: `trace_count()` counts the caches' schema misses, and a schema hit
is what keeps it flat. Padding is exact: mask-zero rows and zero-sum
segments add nothing, and padded batch rows solve the prior.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.buckets import (
    DEFAULT_WIDTHS,
    balanced_widths,
    pad_bucket,
    plan_buckets,
)
from repro_torch.core.gibbs import (
    bucket_stats,
    device_plan,
    resolve_engine,
    sample_mvn_precision,
)
from repro_torch.data.sparse import SparseRatings, csr_from_coo
from repro_torch.kernels import ops
from repro_torch.serve.ensemble import PosteriorEnsemble

_misses = 0
_misses_lock = threading.Lock()


def trace_count() -> int:
    """Schema misses of every FoldInPlanCache so far: the port's stand-in
    for the reference's trace counter (a miss is a new set of padded
    shapes, where the reference compiles). Flat across batches means the
    cache mapped them onto shapes it had seen."""
    with _misses_lock:
        return _misses


class FoldInPlanCache:
    """Quantized plan schemas for cold-start batches, keyed on rating counts.

    A batch's rating-count profile (per-bucket rows and segments, and the
    batch size) is rounded up to powers of two, floored at `quantum`;
    batches that land on one quantized schema share one set of padded
    shapes. An entry is the schema itself (the contents are rebuilt each
    request); entries are LRU-bounded, and the cache is thread-safe. Only
    the item axis ties it to an ensemble, so a frontend clears it only when
    the ensemble's shapes change.
    """

    def __init__(self, widths: tuple[int, ...] = DEFAULT_WIDTHS, *,
                 max_entries: int = 64, quantum: int = 8):
        self.widths = tuple(sorted(widths))
        self.quantum = int(quantum)
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict[tuple, None] = OrderedDict()
        self._lock = threading.Lock()

    @classmethod
    def balanced(cls, degrees: np.ndarray, *, max_buckets: int = 8, lane: int = 1,
                 max_width: int = 512, max_entries: int = 64,
                 quantum: int = 8) -> "FoldInPlanCache":
        """A cache whose width ladder is fit once to a reference degree
        profile (typically the training users') by the balanced planner and
        then frozen: refitting per batch would make the width axis of the
        schema depend on the data."""
        widths = balanced_widths(np.asarray(degrees), max_buckets=max_buckets,
                                 lane=lane, max_width=max_width)
        return cls(widths, max_entries=max_entries, quantum=quantum)

    @staticmethod
    def _quantize(n: int, quantum: int) -> int:
        """Smallest power of two >= n, floored at `quantum`."""
        return max(quantum, 1 << (max(int(n), 1) - 1).bit_length())

    def schema(self, profile: tuple[tuple[int, int, int], ...], n_new: int,
               n_items: int) -> tuple[int, tuple[tuple[int, int, int], ...]]:
        """Quantized (padded_batch, ((width, rows, segments), ...)) for a
        batch whose exact plan shape is `profile`, in bucket order. Records
        a hit or a miss."""
        global _misses
        q = self.quantum
        padded_batch = self._quantize(n_new, q)
        buckets = tuple((w, self._quantize(rows, q), self._quantize(segs, q))
                        for w, rows, segs in profile)
        key = (n_items, padded_batch, buckets)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self._entries[key] = None
                self.misses += 1
                with _misses_lock:
                    _misses += 1
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
        return padded_batch, buckets

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}


def _check_args(generator, z, ratings: SparseRatings, ensemble: PosteriorEnsemble,
                sample: bool) -> None:
    if sample and generator is None and z is None:
        raise ValueError(
            "fold_in(sample=True) draws conditional samples and needs a "
            "torch.Generator or the noise z; pass one, or sample=False for "
            "the deterministic posterior mean"
        )
    if ratings.shape[1] != ensemble.n_items:
        raise ValueError(f"ratings cover {ratings.shape[1]} items, ensemble has "
                         f"{ensemble.n_items}")
    # an out-of-range item id would gather another item's factors
    ratings.validate()


def _noise(generator, z, sample: bool, ensemble: PosteriorEnsemble,
           n_new: int) -> torch.Tensor:
    """(S, n_new, K) noise on the ensemble's device: z as given, drawn from
    the generator, or zeros for the posterior mean."""
    shape = (ensemble.n_samples, n_new, ensemble.k)
    if not sample:
        return torch.zeros(shape, device=ensemble.device)
    if z is None:
        z = torch.randn(shape, generator=generator, device=generator.device)
    elif not isinstance(z, torch.Tensor):
        z = torch.tensor(np.asarray(z, np.float32))
    z = z.to(device=ensemble.device, dtype=torch.float32)
    if tuple(z.shape) != shape:
        raise ValueError(f"z must be {shape}, got {tuple(z.shape)}")
    return z


def _plan(ratings: SparseRatings, ensemble: PosteriorEnsemble, widths):
    """The bucket plan of a batch's centred ratings."""
    n_new = ratings.shape[0]
    centered = (ratings.vals - ensemble.global_mean).astype(np.float32)
    indptr, idx, vals = csr_from_coo(ratings.rows, ratings.cols, centered, n_new)
    return plan_buckets(indptr, idx, vals, n_new, ensemble.n_items, widths)


def _kernel_operand(v: torch.Tensor, engine: str) -> torch.Tensor:
    """v padded once to the kernels' rank where the kernels run, as the
    sweep does (core/gibbs.py::posterior_systems)."""
    k = v.shape[-1]
    if engine in ("kernel", "fused") and v.is_cuda and k <= ops.KERNEL_RANKS[-1]:
        return ops.pad_rank(v, ops.kernel_rank(k))
    return v


def fold_in(
    generator: torch.Generator | None,
    ratings: SparseRatings,
    ensemble: PosteriorEnsemble,
    *,
    sample: bool = True,
    z: torch.Tensor | np.ndarray | None = None,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    engine: str | None = None,
    plan_cache: FoldInPlanCache | None = None,
) -> torch.Tensor:
    """Factor posteriors of a batch of new users from their ratings alone.

    ratings: (n_new, n_items) sparse, row b holding new user b's ratings on
    the training item index space and rating scale (the global mean is
    subtracted here). Returns (S, n_new, K) per-draw factors on the
    ensemble's device: conditional draws when sample=True (noise z (S,
    n_new, K), or drawn from `generator`), conditional posterior means when
    False. A user with no ratings gets the hyper-prior posterior.

    One batched assembly and one solve over the (S, n_new) systems. engine
    (core.gibbs.ENGINES, default "einsum") picks the bucket statistics and
    the solver: "fused" the stacked-draw gather_syrk_seg kernel, "kernel"
    masked_syrk and chol_solve_sample; the others solve with the library
    (solver "subst"). plan_cache quantizes the plan's shapes (and takes
    `widths` from the cache); without one the plan has exact shapes.
    """
    engine = resolve_engine(engine)
    _check_args(generator, z, ratings, ensemble, sample)
    n_new = ratings.shape[0]
    s, k = ensemble.n_samples, ensemble.k
    z = _noise(generator, z, sample, ensemble, n_new)

    buckets, n_real = (), ()
    if ratings.nnz == 0:
        # nothing to plan: the prior-only solve below, the batch axis still
        # quantized under a cache
        padded_batch = (plan_cache._quantize(n_new, plan_cache.quantum)
                        if plan_cache is not None else n_new)
    else:
        if plan_cache is not None:
            widths = plan_cache.widths
        buckets = _plan(ratings, ensemble, widths).buckets
        n_real = tuple(b.n_segments for b in buckets)
        padded_batch = n_new
        if plan_cache is not None:
            padded_batch, targets = plan_cache.schema(
                tuple((b.width, b.rows, b.n_segments) for b in buckets),
                n_new, ensemble.n_items)
            buckets = tuple(pad_bucket(b, rows, segs)
                            for b, (_, rows, segs) in zip(buckets, targets))

    v = _kernel_operand(ensemble.v, engine)
    dev = ensemble.device
    prec = torch.zeros((s, padded_batch, k, k), device=dev)
    rhs = torch.zeros((s, padded_batch, k), device=dev)
    for b, real in zip(device_plan(buckets, dev), n_real):
        p, r = bucket_stats(v, b, engine=engine)   # (S, segments, ...)
        # pad segments add zeros and all point at user 0: only the real
        # ones are scattered, so every user slot takes one addition
        ids = b.seg_item_ids[:real]
        prec[:, ids] += p[:, :real, :k, :k]
        rhs[:, ids] += r[:, :real, :k]
        del p, r
    lam, mu = ensemble.hyper_u_lam, ensemble.hyper_u_mu
    prec = lam[:, None] + ensemble.alpha * prec
    rhs = torch.einsum("skl,sl->sk", lam, mu)[:, None] + ensemble.alpha * rhs
    if padded_batch != n_new:
        z = torch.cat([z, z.new_zeros((s, padded_batch - n_new, k))], dim=1)
    solver = "kernel" if engine == "kernel" else "subst"
    out = sample_mvn_precision(prec, rhs, z=z, solver=solver)
    return out[:, :n_new]  # padded rows solved the prior


def fold_in_loop(
    generator: torch.Generator | None,
    ratings: SparseRatings,
    ensemble: PosteriorEnsemble,
    *,
    sample: bool = True,
    z: torch.Tensor | np.ndarray | None = None,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    engine: str | None = None,
) -> torch.Tensor:
    """The per-draw fold-in: S separate assemblies and solves. Kept as the
    reference `fold_in` is held against; not the serving path."""
    engine = resolve_engine(engine)
    _check_args(generator, z, ratings, ensemble, sample)
    n_new, k = ratings.shape[0], ensemble.k
    z = _noise(generator, z, sample, ensemble, n_new)
    dev = ensemble.device
    buckets = device_plan(_plan(ratings, ensemble, widths), dev)
    solver = "kernel" if engine == "kernel" else "subst"
    out = []
    for s in range(ensemble.n_samples):
        v = _kernel_operand(ensemble.v[s], engine)
        prec = torch.zeros((n_new, k, k), device=dev)
        rhs = torch.zeros((n_new, k), device=dev)
        for b in buckets:
            p, r = bucket_stats(v, b, engine=engine)
            prec[b.seg_item_ids] += p[..., :k, :k]
            rhs[b.seg_item_ids] += r[..., :k]
        lam, mu = ensemble.hyper_u_lam[s], ensemble.hyper_u_mu[s]
        prec = lam[None] + ensemble.alpha * prec
        rhs = (lam @ mu)[None] + ensemble.alpha * rhs
        out.append(sample_mvn_precision(prec, rhs, z=z[s], solver=solver))
    return torch.stack(out)  # (S, n_new, K)
