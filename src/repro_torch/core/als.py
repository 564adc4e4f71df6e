"""ALS baseline (Zhou et al. 2008) over the same bucketed plans
(`repro/core/als.py`).

The paper sets BPMF against ALS (Sec 5.2). ALS solves, per item,

    (lambda * n_i * I + sum_j v_j v_j^T) u_i = sum_j r_ij v_j

from the same sufficient statistics as the BPMF conditional, without
sampling. The statistics come from `bucket_stats` with the einsum engine,
the reference's default, so its segment sums are the order-fixed ones of
`core/gibbs.py::segment_reduce_rows`; the solve is the library route, a
Cholesky factor and two triangular solves, as the reference's is.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.buckets import plan_buckets
from repro_torch.core.gibbs import DeviceBucket, bucket_stats, device_plan
from repro_torch.core.hyper import cholesky_or_nan
from repro_torch.data.sparse import SparseRatings, csr_from_coo
from repro_torch.device import resolve_device

__all__ = ["ALS", "ALSState", "als_state_from_numpy"]


class ALSState(NamedTuple):
    u: torch.Tensor   # (M, K)
    v: torch.Tensor   # (N, K)
    step: int


def als_state_from_numpy(*, u, v, step: int = 0, device="cuda") -> ALSState:
    """The port's state from the reference's ALSState fields as numpy
    arrays: the carried-over state of a parity test."""
    device = resolve_device(device)

    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return ALSState(u=put(u), v=put(v), step=int(step))


def _solve_factors(counterpart: torch.Tensor, buckets: Sequence[DeviceBucket],
                   n_items: int, lam_reg: float, counts: torch.Tensor) -> torch.Tensor:
    """Every item's ALS-WR solve given the counterpart factors."""
    k = counterpart.shape[-1]
    dtype, device = counterpart.dtype, counterpart.device
    prec_all = torch.zeros((n_items, k, k), dtype=dtype, device=device)
    rhs_all = torch.zeros((n_items, k), dtype=dtype, device=device)
    for b in buckets:
        prec, rhs = bucket_stats(counterpart, b, engine="einsum")
        # the plan partitions the items: each slot takes one addition
        prec_all[b.seg_item_ids] += prec
        rhs_all[b.seg_item_ids] += rhs
        del prec, rhs
    # weighted-lambda regularisation (ALS-WR): lambda * n_i * I
    reg = lam_reg * torch.clamp(counts, min=1.0)
    prec_all.diagonal(dim1=-2, dim2=-1).add_(reg[:, None])
    chol = cholesky_or_nan(prec_all)
    del prec_all
    y = torch.linalg.solve_triangular(chol, rhs_all[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]


class ALS:
    """Alternating least squares over bucketed plans, one item solve and
    one user solve a sweep. `device` defaults to "cuda" and raises when
    there is no card; the CPU runs only when asked for."""

    def __init__(
        self,
        ratings: SparseRatings,
        test: SparseRatings | None = None,
        *,
        k: int = 64,
        lam_reg: float = 0.05,
        widths=(8, 32, 128, 512),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.m, self.n = ratings.shape
        self.k = k
        self.lam_reg = lam_reg
        self.global_mean = ratings.mean()
        centered = ratings.centered()
        uptr, uidx, uval = csr_from_coo(centered.rows, centered.cols, centered.vals, self.m)
        self.user_buckets = device_plan(
            plan_buckets(uptr, uidx, uval, self.m, self.n, widths), self.device)
        t = centered.transpose()
        vptr, vidx, vval = csr_from_coo(t.rows, t.cols, t.vals, self.n)
        self.item_buckets = device_plan(
            plan_buckets(vptr, vidx, vval, self.n, self.m, widths), self.device)
        # each entity's number of ratings: the ALS-WR regulariser's n_i
        self.user_counts = torch.as_tensor(
            ratings.degrees(0).astype(np.float32)).to(self.device)
        self.item_counts = torch.as_tensor(
            ratings.degrees(1).astype(np.float32)).to(self.device)
        if test is None:
            test = SparseRatings(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), ratings.shape)
        self.test_rows = torch.as_tensor(test.rows.astype(np.int64)).to(self.device)
        self.test_cols = torch.as_tensor(test.cols.astype(np.int64)).to(self.device)
        self.test_vals = torch.as_tensor(test.vals.astype(np.float32)).to(self.device)
        self.generator = torch.Generator(device=self.device)

    def init(self, seed: int = 0) -> ALSState:
        """Reseed the generator and draw the initial factors, 0.1 N(0, 1)."""
        self.generator.manual_seed(seed)
        kw = dict(generator=self.generator, device=self.device)
        return ALSState(u=0.1 * torch.randn((self.m, self.k), **kw),
                        v=0.1 * torch.randn((self.n, self.k), **kw), step=0)

    def sweep(self, state: ALSState) -> ALSState:
        v_new = _solve_factors(state.u, self.item_buckets, self.n, self.lam_reg,
                               self.item_counts)
        u_new = _solve_factors(v_new, self.user_buckets, self.m, self.lam_reg,
                               self.user_counts)
        return ALSState(u=u_new, v=v_new, step=state.step + 1)

    def rmse(self, state: ALSState) -> float:
        if self.test_vals.shape[0] == 0:
            return float("nan")
        pred = (state.u[self.test_rows] * state.v[self.test_cols]).sum(-1) + self.global_mean
        return float(torch.sqrt(torch.mean((pred - self.test_vals) ** 2)))

    def run(self, n_sweeps: int, seed: int = 0) -> ALSState:
        state = self.init(seed)
        for _ in range(n_sweeps):
            state = self.sweep(state)
        return state
