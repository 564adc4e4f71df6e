"""Single-device BPMF Gibbs sampler over bucketed plans (PyTorch).

Algorithm 1 of the paper: per sweep, sample movie hyperparameters from V,
update every movie from (R, U); sample user hyperparameters from U, update
every user from (R, V); then predict the test points. The per-item update is

    Lambda_i = Lambda_hyper + alpha * sum_j v_j v_j^T     (j in ratings of i)
    b_i      = Lambda_hyper mu_hyper + alpha * sum_j r_ij v_j
    u_i      ~ N(Lambda_i^-1 b_i, Lambda_i^-1)

computed bucket by bucket, as `repro.core.gibbs` does. Every random draw is
explicit: a `SweepNoise` carries the Wishart draws and the z of each factor
solve, drawn from the sampler's torch.Generator unless the caller passes
them (the tests pass the reference's own jax.random draws).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.buckets import Bucket, BucketPlan, WidthsSpec, plan_buckets
from repro_torch.core.hyper import (
    HyperParams,
    WishartNoise,
    cholesky_or_nan,
    default_prior,
    draw_wishart_noise,
    init_hyper,
    sample_normal_wishart,
)
from repro_torch.data.sparse import SparseRatings, csr_from_coo
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.spans import span

# Sweep engines, as in the reference:
#   reference  seed data flow: einsum row stats, per-bucket segment sums and
#              full-size scatter-adds, three triangular solves.
#   einsum     restructured flow: same einsum statistics, per-segment outputs
#              added once into their item slots, one Cholesky + substitution.
#   kernel     restructured flow through the masked_syrk and
#              chol_solve_sample kernels.
#   fused      restructured flow through the fused gather_syrk_seg kernel
#              (V gathered in the kernel, optional bf16 gather), solved by
#              the chol_solve_sample kernel with NaN for a system that is
#              not positive definite, as the reference's substitution gives.
ENGINES = ("reference", "einsum", "kernel", "fused")

__all__ = [
    "ENGINES", "BPMFState", "DeviceBucket", "FactorStats", "GibbsSampler",
    "SweepNoise", "bucket_stats", "chol_subst_solve", "device_plan", "draw_sweep_noise",
    "factor_stats", "posterior_systems", "resolve_engine", "sample_mvn_precision",
    "segment_reduce_rows", "state_from_numpy", "state_from_sample",
    "sum_rows_by_id", "update_factors",
]


def resolve_engine(engine: str | None) -> str:
    """The ENGINES name of `engine`; None is the default, "einsum"."""
    if engine is None:
        return "einsum"
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return engine


class FactorStats(NamedTuple):
    """Sufficient statistics of a factor matrix."""

    sum_x: torch.Tensor    # (K,)
    sum_xxt: torch.Tensor  # (K, K)
    n: int


class BPMFState(NamedTuple):
    u: torch.Tensor           # (M, K)
    v: torch.Tensor           # (N, K)
    hyper_u: HyperParams
    hyper_v: HyperParams
    step: int
    # posterior-predictive accumulators over test points (after burn-in)
    pred_sum: torch.Tensor    # (n_test,)
    pred_count: int


class SweepNoise(NamedTuple):
    """Every random draw of one sweep, in the order the sweep uses them."""

    hyper_v: WishartNoise
    z_v: torch.Tensor          # (N, K)
    hyper_u: WishartNoise
    z_u: torch.Tensor          # (M, K)


def draw_sweep_noise(prior, m: int, n: int, generator: torch.Generator) -> SweepNoise:
    """One sweep's noise for m users and n items, in the order the sweep
    uses it, from `generator` on the prior's device."""
    k, device = prior.mu0.shape[0], prior.mu0.device
    hyper_v = draw_wishart_noise(prior, n, generator)
    z_v = torch.randn((n, k), generator=generator, device=device)
    hyper_u = draw_wishart_noise(prior, m, generator)
    z_u = torch.randn((m, k), generator=generator, device=device)
    return SweepNoise(hyper_v=hyper_v, z_v=z_v, hyper_u=hyper_u, z_u=z_u)


class DeviceBucket(NamedTuple):
    """Device copy of a host Bucket."""

    width: int
    indices: torch.Tensor
    values: torch.Tensor
    mask: torch.Tensor
    seg_ids: torch.Tensor
    n_segments: int
    seg_item_ids: torch.Tensor
    # (n_segments + 1,) row offsets of the segments, computed on the host
    seg_ptr: torch.Tensor
    # host-verified: seg_ids == arange(rows), every row its own segment
    identity_segments: bool = False


def device_plan(plan: BucketPlan | Sequence[Bucket], device) -> tuple[DeviceBucket, ...]:
    """Move a host plan (or a bare bucket sequence) onto `device`."""
    if isinstance(plan, BucketPlan):
        plan = plan.buckets

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return tuple(
        DeviceBucket(
            width=b.width,
            indices=put(b.indices),
            values=put(b.values),
            mask=put(b.mask),
            seg_ids=put(b.seg_ids),
            n_segments=b.n_segments,
            seg_item_ids=put(b.seg_item_ids.astype(np.int64)),
            seg_ptr=put(kops.segment_offsets(b.seg_ids, b.n_segments)),
            identity_segments=bool(
                b.indices.shape[0] == b.n_segments
                and np.array_equal(b.seg_ids, np.arange(b.n_segments))
            ),
        )
        for b in plan
    )


def segment_reduce_rows(
    rows: torch.Tensor, offsets: torch.Tensor, *,
    stacked: bool = False, identity: bool = False,
) -> torch.Tensor:
    """Row-level statistics -> per-segment sums, each segment's rows added
    in row order from zero: the same bits on every run, on the card as on
    the CPU (`index_add_` would be atomic on the card), and the order the
    CPU's `index_add_` takes. The segments are contiguous runs of rows:
    `offsets` holds their n_segments + 1 row offsets (a plan's `seg_ptr`;
    rows whose segment ids are not nondecreasing are sorted stably first,
    `sum_rows_by_id`). `identity` skips the reduction (every row its own
    segment); `stacked` means a leading draw axis precedes the row axis.

    torch.segment_reduce sums each output element in one thread, the
    segment's rows in order, for rows of two or more axes; a single axis
    would take a tree reduction on the card, so it is refused there."""
    if identity:
        return rows
    if rows.is_cuda and rows.dim() < 2:
        raise ValueError("segment_reduce_rows adds in row order only for rows of "
                         "two or more axes on the card")
    axis = 1 if stacked else 0
    if stacked:
        offsets = offsets.expand(rows.shape[0], -1).contiguous()
    return torch.segment_reduce(rows, "sum", offsets=offsets, axis=axis, unsafe=True)


def sum_rows_by_id(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of rows (R, ...) by their ids in [0, n), duplicates in
    any order: the rows sorted stably by id, then `segment_reduce_rows`, so
    an id's rows are added in the order they came, from zero. The
    order-fixed scatter-add (`.at[ids].add` into zeros) of the SGLD
    gradients; the offsets come from the sorted ids on their device, with
    no host sync."""
    ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(n + 1, device=ids.device, dtype=ids.dtype)
    return segment_reduce_rows(rows[order], torch.searchsorted(ids, bounds))


def bucket_stats(
    counterpart: torch.Tensor, bucket: DeviceBucket, *,
    engine: str = "einsum", bf16_gather: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum v v^T, sum r v) for one bucket.

    counterpart is one factor matrix (N, K) or a stack of S draws (S, N, K);
    the outputs carry the leading draw axis iff it does.
    """
    engine = resolve_engine(engine)
    if engine == "fused":
        return kops.gather_syrk_seg(
            bucket.indices, bucket.values, bucket.mask, bucket.seg_ids,
            bucket.n_segments, counterpart, bf16_gather=bf16_gather,
            identity_segments=bucket.identity_segments, seg_ptr=bucket.seg_ptr,
        )
    skip_reduce = engine == "einsum" and bucket.identity_segments
    stacked = counterpart.dim() == 3
    idx = bucket.indices.long()
    rv = bucket.values * bucket.mask
    vg = counterpart[:, idx] if stacked else counterpart[idx]   # (..., R, W, K)
    vm = vg * bucket.mask[..., None]
    if engine == "kernel":
        prec_rows, rhs_rows = kops.masked_syrk(vm, rv.expand(vm.shape[:-1]))
    else:
        prec_rows = torch.einsum("...rwk,...rwl->...rkl", vm, vm)
        rhs_rows = torch.einsum("...rwk,...rw->...rk", vm, rv.expand(vm.shape[:-1]))

    def reduce(rows):
        return segment_reduce_rows(rows, bucket.seg_ptr, stacked=stacked,
                                   identity=skip_reduce)

    return reduce(prec_rows), reduce(rhs_rows)


def chol_subst_solve(chol: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor
                     ) -> torch.Tensor:
    """x = L^-T (L^-1 rhs + z): the mean and noise solves share one back
    substitution. Works for any leading batch axes."""
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(
        chol.transpose(-1, -2), y + z[..., None], upper=True
    )[..., 0]


def sample_mvn_precision(
    prec: torch.Tensor, rhs: torch.Tensor, *, z: torch.Tensor,
    solver: str = "subst",
) -> torch.Tensor:
    """x ~ N(prec^-1 rhs, prec^-1), batched over any leading axes, with the
    noise z given (z = 0 gives the posterior mean).

    solver: "subst" (Cholesky + one forward and one merged back solve),
    "lapack" (the seed's three triangular solves, for the reference engine),
    "kernel" (the chol_solve_sample kernel, its diagonal clamped as the
    Pallas kernel's) or "kernel_nan" (the same kernel, for the fused
    engine). A system that is not positive definite gives NaN under
    "subst", "lapack" and "kernel_nan", as jnp.linalg.cholesky does, and the
    clamp's values under "kernel"; nothing raises.
    """
    if solver in ("kernel", "kernel_nan"):
        return kops.chol_solve_sample(
            prec, rhs, z, indefinite="nan" if solver == "kernel_nan" else "clamp")
    chol = cholesky_or_nan(prec)
    if solver == "subst":
        return chol_subst_solve(chol, rhs, z)
    if solver != "lapack":
        raise ValueError(f"unknown solver {solver!r}")
    lt = chol.transpose(-1, -2)
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    mean = torch.linalg.solve_triangular(lt, y, upper=True)
    noise = torch.linalg.solve_triangular(lt, z[..., None], upper=True)
    return (mean + noise)[..., 0]


def factor_stats(x: torch.Tensor) -> FactorStats:
    return FactorStats(sum_x=x.sum(0), sum_xxt=x.T @ x, n=x.shape[0])


def posterior_systems(
    counterpart: torch.Tensor,
    buckets: Sequence[DeviceBucket],
    n_items: int,
    hyper: HyperParams,
    alpha: float,
    *,
    engine: str = "einsum",
    bf16_gather: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every item's posterior precision (n_items, K, K) and rhs (n_items, K)
    given the counterpart matrix: the systems one half-sweep solves.

    The plan partitions the items, so each item slot receives one addition
    and the sums take no atomics and no order; items without ratings keep
    the prior. The restructured flow (every engine but "reference") starts
    the buffers at the hyper-prior and adds alpha times each bucket's
    per-segment statistics; the reference flow sums the statistics first
    and scales them after, as the seed did.
    """
    engine = resolve_engine(engine)
    k = counterpart.shape[-1]
    dtype, device = counterpart.dtype, counterpart.device
    prior_rhs = hyper.lam @ hyper.mu
    if engine == "reference":
        prec_all = torch.zeros((n_items, k, k), dtype=dtype, device=device)
        rhs_all = torch.zeros((n_items, k), dtype=dtype, device=device)
        for b in buckets:
            prec, rhs = bucket_stats(counterpart, b, engine="reference")
            prec_all[b.seg_item_ids] += prec
            rhs_all[b.seg_item_ids] += rhs
        return hyper.lam[None] + alpha * prec_all, prior_rhs[None] + alpha * rhs_all
    prec_all = hyper.lam.to(dtype).expand(n_items, k, k).clone()
    rhs_all = prior_rhs.to(dtype).expand(n_items, k).clone()
    if (engine in ("kernel", "fused") and counterpart.is_cuda
            and k <= kops.KERNEL_RANKS[-1]):
        # the kernels' rank: zero columns once a half-sweep, not a bucket;
        # each bucket's statistics keep the true K x K block (the plain
        # versions that CPU tensors take need no padding)
        counterpart = kops.pad_rank(counterpart, kops.kernel_rank(k))
    for b in buckets:
        prec, rhs = bucket_stats(counterpart, b, engine=engine,
                                 bf16_gather=bf16_gather)
        prec_all[b.seg_item_ids] += alpha * prec[..., :k, :k]
        rhs_all[b.seg_item_ids] += alpha * rhs[..., :k]
        del prec, rhs
    return prec_all, rhs_all


def update_factors(
    counterpart: torch.Tensor,
    buckets: Sequence[DeviceBucket],
    n_items: int,
    hyper: HyperParams,
    alpha: float,
    *,
    z: torch.Tensor,
    engine: str = "einsum",
    bf16_gather: bool = False,
) -> tuple[torch.Tensor, FactorStats]:
    """One half-sweep: resample every item factor given the counterpart
    matrix, with the solve noise z (n_items, K) given. Also returns the
    sufficient statistics of the new factor matrix.

    The engine picks the solver: the seed's three triangular solves for
    "reference", Cholesky and substitution for "einsum", the
    chol_solve_sample kernel for "kernel" (clamped) and "fused" (NaN for a
    system that is not positive definite, as "einsum" gives)."""
    engine = resolve_engine(engine)
    with span("gibbs.assemble", counterpart.device):
        prec_all, rhs_all = posterior_systems(
            counterpart, buckets, n_items, hyper, alpha, engine=engine,
            bf16_gather=bf16_gather,
        )
    solver = {"reference": "lapack", "kernel": "kernel",
              "fused": "kernel_nan"}.get(engine, "subst")
    with span("gibbs.solve", counterpart.device):
        new = sample_mvn_precision(prec_all, rhs_all, z=z, solver=solver)
    return new, factor_stats(new)


def _f32(a, device) -> torch.Tensor:
    """A float32 copy of a host array (numpy or anything np.asarray takes)
    on `device`."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _hyper_tensors(pair, device) -> HyperParams:
    mu, lam = pair
    return HyperParams(mu=_f32(mu, device), lam=_f32(lam, device))


def state_from_numpy(
    *, u, v, hyper_u, hyper_v, step=0, pred_sum=None, pred_count=0,
    device="cuda",
) -> BPMFState:
    """The port's state from the reference's BPMFState fields as numpy
    arrays. hyper_u and hyper_v are (mu, lam) pairs (a jax HyperParams
    converts field by field); the JAX PRNG key is not carried."""
    device = resolve_device(device)
    if pred_sum is None:
        pred_sum = np.zeros((0,), np.float32)
    return BPMFState(
        u=_f32(u, device),
        v=_f32(v, device),
        hyper_u=_hyper_tensors(hyper_u, device),
        hyper_v=_hyper_tensors(hyper_v, device),
        step=int(step),
        pred_sum=_f32(pred_sum, device),
        pred_count=int(pred_count),
    )


def state_from_sample(sample: dict, *, step: int = 0, n_test: int = 0,
                      device="cuda") -> BPMFState:
    """The port's state from one retained draw in the SAMPLE_KEYS schema,
    with empty posterior-predictive accumulators."""
    return state_from_numpy(
        u=sample["u"], v=sample["v"],
        hyper_u=(sample["hyper_u_mu"], sample["hyper_u_lam"]),
        hyper_v=(sample["hyper_v_mu"], sample["hyper_v_lam"]),
        step=step, pred_sum=np.zeros((n_test,), np.float32), pred_count=0,
        device=device,
    )


class GibbsSampler:
    """Single-device BPMF sampler over bucketed plans.

    `engine` selects the sweep implementation (see ENGINES): "einsum" by
    default, "fused" for the gather_syrk_seg and chol_solve_sample kernels,
    "kernel" for the masked_syrk + chol_solve_sample kernels, "reference"
    for the seed flow. `bf16_gather` (fused engine) gathers the
    counterpart factors at bf16 with fp32 accumulation. `widths` picks the
    bucket planner ("balanced" or an explicit ladder).

    `device` defaults to "cuda" and raises when there is no card; the CPU
    runs only when asked for.
    """

    def __init__(
        self,
        ratings: SparseRatings,
        test: SparseRatings | None = None,
        *,
        k: int = 64,
        alpha: float = 1.5,
        burn_in: int = 8,
        widths: WidthsSpec = "balanced",
        engine: str | None = None,
        bf16_gather: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.m, self.n = ratings.shape
        self.k = k
        self.alpha = alpha
        self.burn_in = burn_in
        self.engine = resolve_engine(engine)
        self.bf16_gather = bf16_gather
        self.global_mean = ratings.mean()
        centered = ratings.centered()

        uptr, uidx, uval = csr_from_coo(
            centered.rows, centered.cols, centered.vals, self.m
        )
        self.user_plan_host = plan_buckets(uptr, uidx, uval, self.m, self.n, widths)
        t = centered.transpose()
        vptr, vidx, vval = csr_from_coo(t.rows, t.cols, t.vals, self.n)
        self.item_plan_host = plan_buckets(vptr, vidx, vval, self.n, self.m, widths)
        self.user_buckets = device_plan(self.user_plan_host, self.device)
        self.item_buckets = device_plan(self.item_plan_host, self.device)

        def put(a, dt):
            return torch.as_tensor(np.asarray(a, dt)).to(self.device)

        if test is None:
            test = SparseRatings(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), ratings.shape)
        self.test_rows = put(test.rows, np.int64)
        self.test_cols = put(test.cols, np.int64)
        self.test_vals = put(test.vals, np.float32)
        self.prior = default_prior(k, device=self.device)
        self.generator = torch.Generator(device=self.device)

    def init(self, seed: int = 0) -> BPMFState:
        """Reseed the sampler's generator and draw the initial factors."""
        self.generator.manual_seed(seed)
        kw = dict(generator=self.generator, device=self.device)
        return BPMFState(
            u=0.1 * torch.randn((self.m, self.k), **kw),
            v=0.1 * torch.randn((self.n, self.k), **kw),
            hyper_u=init_hyper(self.k, device=self.device),
            hyper_v=init_hyper(self.k, device=self.device),
            step=0,
            pred_sum=torch.zeros_like(self.test_vals),
            pred_count=0,
        )

    def draw_noise(self) -> SweepNoise:
        """One sweep's noise from the sampler's generator."""
        return draw_sweep_noise(self.prior, self.m, self.n, self.generator)

    def sweep(self, state: BPMFState, noise: SweepNoise | None = None) -> BPMFState:
        """One full Gibbs sweep (Algorithm 1 body)."""
        with span("gibbs.sweep", self.device):
            if noise is None:
                noise = self.draw_noise()
            kw = dict(engine=self.engine, bf16_gather=self.bf16_gather)

            # movies: hyper from V stats, then update V given U
            sv = factor_stats(state.v)
            hyper_v = sample_normal_wishart(sv.sum_x, sv.sum_xxt, sv.n, self.prior,
                                            noise.hyper_v)
            v_new, _ = update_factors(state.u, self.item_buckets, self.n, hyper_v,
                                      self.alpha, z=noise.z_v, **kw)

            # users: hyper from U stats, then update U given the new V
            su = factor_stats(state.u)
            hyper_u = sample_normal_wishart(su.sum_x, su.sum_xxt, su.n, self.prior,
                                            noise.hyper_u)
            u_new, _ = update_factors(v_new, self.user_buckets, self.m, hyper_u,
                                      self.alpha, z=noise.z_u, **kw)

            pred_sum, pred_count = state.pred_sum, state.pred_count
            if state.step >= self.burn_in:
                pred_sum = pred_sum + self._predict(u_new, v_new)
                pred_count += 1
            return BPMFState(u=u_new, v=v_new, hyper_u=hyper_u, hyper_v=hyper_v,
                             step=state.step + 1, pred_sum=pred_sum,
                             pred_count=pred_count)

    def _predict(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return (u[self.test_rows] * v[self.test_cols]).sum(-1) + self.global_mean

    def _rmse(self, pred: torch.Tensor) -> float:
        if self.test_vals.shape[0] == 0:
            return float("nan")
        return float(torch.sqrt(torch.mean((pred - self.test_vals) ** 2)))

    def rmse(self, state: BPMFState) -> float:
        """Posterior-mean RMSE over the test set (the paper's accuracy metric)."""
        return self._rmse(state.pred_sum / max(state.pred_count, 1))

    def sample_rmse(self, state: BPMFState) -> float:
        """RMSE of the current single draw (no posterior averaging)."""
        return self._rmse(self._predict(state.u, state.v))

    def sample_dict(self, state: BPMFState) -> dict:
        """The current draw as host arrays in the flat SAMPLE_KEYS schema."""
        def host(x):
            return x.detach().cpu().numpy()

        return {
            "u": host(state.u),
            "v": host(state.v),
            "hyper_u_mu": host(state.hyper_u.mu),
            "hyper_u_lam": host(state.hyper_u.lam),
            "hyper_v_mu": host(state.hyper_v.mu),
            "hyper_v_lam": host(state.hyper_v.lam),
            "global_mean": np.asarray(self.global_mean, np.float32),
            "alpha": np.asarray(self.alpha, np.float32),
        }

    def retain_sample(self, state: BPMFState, store) -> None:
        """Persist the current draw into a checkpoint.SampleStore."""
        store.retain(state.step, self.sample_dict(state))

    def run(self, n_sweeps: int, seed: int = 0, *, store=None, publish=None,
            thin: int = 1, state: BPMFState | None = None) -> BPMFState:
        """Run the chain from init(seed), or on from `state` (the
        generator then goes on where it is); every `thin`-th post-burn-in
        draw is handed to serving on up to two paths:

        * `store` (a checkpoint.SampleStore): the durable write, which
          overlaps the next sweep;
        * `publish` (a serve.publish.PublicationChannel): the in-memory push
          to a co-running server, as host arrays. The channel is left open;
          the caller closes it when the server should see the end of the
          stream.
        """
        if thin < 1:
            raise ValueError(f"thin must be >= 1, got {thin}")
        if state is None:
            state = self.init(seed)
        for i in range(n_sweeps):
            state = self.sweep(state)
            if i >= self.burn_in and (i - self.burn_in) % thin == 0:
                if store is not None or publish is not None:
                    sample = self.sample_dict(state)  # one copy off the card
                if store is not None:
                    store.retain(state.step, sample)
                if publish is not None:
                    publish.publish(state.step, sample)
        if store is not None:
            store.wait()
        return state
