"""Minibatch SGLD samplers: a step's cost set by the minibatch, not the data
(`repro/core/sgld.py`).

Exact Gibbs touches every rating in every sweep. Stochastic gradient
Langevin dynamics (Welling & Teh 2011; for distributed matrix factorization
Ahn et al., arXiv 1503.01596) replaces the exact conditional draw with a
noisy, preconditioned gradient step

    x <- x + (eps/2) G grad log p(x | rest) + sqrt(eps G T) z,   z ~ N(0, I)

whose likelihood gradient is estimated from rows sampled uniformly with
replacement from the same bucketed plans (`core/buckets.py`) and grid plans
(`core/partition.py`) the Gibbs engines sweep, scaled by the inverse
inclusion probability. The preconditioner G_i = 1 / (lam_bar + alpha d_i
sig2_bar) takes its shape from the degree profile and its two amplitudes
from the current hyper precision and counterpart factors. The hyperparameters
keep their exact Normal-Wishart draw (Ahn et al.'s mixed scheme).

As everywhere in the port, the randomness is explicit: an `SGLDNoise` holds
one step's Wishart draws, sampled row ids and Langevin noise, drawn from the
sampler's torch.Generator unless the caller passes it (the tests pass the
reference's own jax.random draws). The step is a host-side int, so the
step size, the temperature and the thinning of the hyper draw and of the
posterior-predictive sum are host decisions: a thinned step launches
nothing for them.

A sampled minibatch holds an entity's rows several times, in random order.
Their gradients are added into the entity by `core/gibbs.py::sum_rows_by_id`
(a stable sort by entity, then the order-fixed segment sum), never by an
atomic scatter-add: two chains from one seed are equal bit for bit on the
card.

`SGLDSampler` subclasses `GibbsSampler` (plans, posterior-predictive sum,
retention and publication through `run(store=, publish=)`);
`DistributedSGLD` subclasses `DistributedBPMF` (P shards in one process or
one a rank of a mesh, the ring, all-gather and stale-by-one async exchanges
of `core/exchange.py`).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.distributed import (
    DistributedBPMF,
    DistState,
    _rows_by_slot,
    _Side,
    _stats,
)
from repro_torch.core.gibbs import (
    BPMFState,
    DeviceBucket,
    GibbsSampler,
    factor_stats,
    segment_reduce_rows,
    sum_rows_by_id,
)
from repro_torch.core.hyper import (
    HyperParams,
    WishartNoise,
    draw_wishart_noise,
    sample_normal_wishart,
)
from repro_torch.data.sparse import SparseRatings
from repro_torch.optim.schedule import sgld_step_schedule

__all__ = [
    "DistributedSGLD", "SGLDConfig", "SGLDNoise", "SGLDSampler", "alloc_minibatch",
    "data_init_scale", "effective_temperature", "langevin_update",
    "minibatch_likelihood_grad", "precond_gain", "row_grads",
]


# ---------------------------------------------------------------------------
# shared numerics
# ---------------------------------------------------------------------------
def row_grads(factors: torch.Tensor, counterpart: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor, msk: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Per-row likelihood gradients for the rows' owning entities.

    For plan rows (idx (s, w) counterpart ids, val and msk (s, w)) owned by
    entities `items` (s,), the (s, K) rows
        g_row = sum_w msk * (r - u_item . v_j) * v_j,
    d/du of -0.5 sum (r - u.v)^2 over the row's ratings."""
    vg = counterpart[idx.long()]                          # (s, w, K)
    ug = factors[items.long()]                            # (s, K)
    pred = torch.einsum("sk,swk->sw", ug, vg)
    resid = (val - pred) * msk
    return torch.einsum("sw,swk->sk", resid, vg)


def minibatch_likelihood_grad(
    factors: torch.Tensor,
    counterpart: torch.Tensor,
    buckets: Sequence[DeviceBucket],
    n_rows: Sequence[int],
    scales: Sequence[float],
    rows: Sequence[torch.Tensor | None],
) -> torch.Tensor:
    """Unbiased minibatch estimate of the full-plan likelihood gradient.

    Bucket b contributes its sampled rows `rows[b]` (n_rows[b] row ids,
    drawn uniformly with replacement), their gradients scaled by
    scales[b] = rows_b / n_rows[b]; a bucket whose quota covers every row
    takes all of them in order (its entry of `rows` is None), so a large
    enough minibatch is the exact full gradient. An entity's rows lie in
    one bucket; all buckets' rows are added into their entities in one
    order-fixed sum."""
    grads, ids = [], []
    for bucket, s_b, scale, sel in zip(buckets, n_rows, scales, rows, strict=True):
        arrays = (bucket.indices, bucket.values, bucket.mask, bucket.seg_ids)
        if s_b < bucket.indices.shape[0]:
            if sel is None:
                raise ValueError("a sampled bucket needs its row ids")
            arrays = tuple(a[sel] for a in arrays)
        idx, val, msk, seg = arrays
        items = bucket.seg_item_ids[seg.long()]
        grads.append(scale * row_grads(factors, counterpart, idx, val, msk, items))
        ids.append(items)
    return sum_rows_by_id(torch.cat(grads), torch.cat(ids), factors.shape[0])


def precond_gain(degrees, alpha: float, lam_bar, sig2_bar):
    """Per-entity SGLD gain G_i = 1 / (lam_bar + alpha * d_i * sig2_bar):
    an estimate of the inverse per-coordinate posterior precision, so the
    effective step eps G_i P_i stays near eps across the degree spectrum."""
    return 1.0 / (lam_bar + alpha * degrees * sig2_bar)


def langevin_update(factors: torch.Tensor, grad: torch.Tensor, gain: torch.Tensor, eps,
                    temperature, *, z: torch.Tensor, clip: float | None = 3.0
                    ) -> torch.Tensor:
    """x + (eps/2) G grad + sqrt(eps G T) z, with the gain per entity and
    the noise z given.

    The drift is clipped elementwise to `clip` times the T = 1 noise scale
    sqrt(eps G), a scale-free trust region: rare wide-row draws, scaled by
    their inverse inclusion probability, would otherwise kick popular
    entities far enough to run away. At equilibrium the drift is about
    sqrt(eps) noise scales, far inside the clip. clip=None disables it."""
    step = eps * gain[:, None]
    drift = 0.5 * step * grad
    if clip is not None:
        # the T = 1 noise scale, not the tempered one: a cooled chain keeps
        # its drift
        lim = clip * torch.sqrt(step)
        drift = torch.clamp(drift, min=-lim, max=lim)
    return factors + drift + torch.sqrt(step * temperature) * z


def _lam_bar(hyper: HyperParams) -> torch.Tensor:
    return torch.trace(hyper.lam) / hyper.lam.shape[-1]


def effective_temperature(step: int, temperature: float, temp_warmup: int) -> float:
    """The annealed temperature: a linear ramp from 0 to `temperature` over
    the first `temp_warmup` steps (0: constant). During the ramp the chain
    is preconditioned minibatch SGD with damped noise, which reaches the
    posterior's bulk far sooner; those steps fall inside burn-in."""
    if temp_warmup <= 0:
        return temperature
    return temperature * min(1.0, step / temp_warmup)


def data_init_scale(vals: np.ndarray, k: int) -> float:
    """Initial factor std matched to the data, k s^4 ~= var(ratings), so that
    u.v starts at the ratings' scale; floored at Gibbs' 0.1. SGLD, unlike an
    exact sweep, would otherwise spend hundreds of steps growing small
    factors (small factors -> large hyper precision -> small gain)."""
    var = float(np.var(vals)) if len(vals) else 0.0
    return max(0.1, (max(var, 1e-8) / k) ** 0.25)


def alloc_minibatch(plan_host, lanes_budget: int) -> tuple[tuple[int, ...], tuple[float, ...]]:
    """Split a padded-lane budget over a plan's buckets in proportion to
    each bucket's share of the lanes (rows * width): wide buckets get fewer
    rows, so every bucket costs about the same. Returns (rows per bucket,
    inverse inclusion scales); a bucket capped at its own row count gets
    scale 1.0 (exact)."""
    rows = np.array([b.indices.shape[0] for b in plan_host.buckets], np.float64)
    lanes = rows * np.array([b.width for b in plan_host.buckets], np.float64)
    total = lanes.sum()
    n_rows, scales = [], []
    for b, r, lane in zip(plan_host.buckets, rows, lanes):
        s = int(min(r, max(1.0, round(lanes_budget * lane / total / b.width))))
        n_rows.append(s)
        scales.append(float(r) / s)
    return tuple(n_rows), tuple(scales)


class SGLDNoise(NamedTuple):
    """Every random draw of one SGLD step, in the order the step uses them.

    `hyper_v` and `hyper_u` are None on a step that keeps its hypers
    (`hyper_every`). The row ids: for `SGLDSampler` one (n_rows[b],) tensor
    a bucket, None where the quota covers the bucket; for
    `DistributedSGLD` [i][s] the ids into block (p, (p - s) mod P) that
    shard p, the i-th this process holds, reads at ring step s (ring,
    async) or [i] the ids into shard p's flattened plan (allgather), each
    on its shard's device. z is (entities, K) in global id order."""

    hyper_v: WishartNoise | None
    hyper_u: WishartNoise | None
    rows_v: tuple
    rows_u: tuple
    z_v: torch.Tensor
    z_u: torch.Tensor


# ---------------------------------------------------------------------------
# single-device sampler
# ---------------------------------------------------------------------------
class SGLDSampler(GibbsSampler):
    """Single-device minibatch SGLD over the same bucketed plans as Gibbs.

    `minibatch` is a padded-lane budget a half-step: bucket b samples about
    minibatch * lane share / width rows (`alloc_minibatch`). `burn_in` is in
    steps; `hyper_every` and `accum_every` thin the exact hyper draw
    (O(entities K^2)) and the posterior-predictive sum (O(|test| K)),
    whose costs the minibatch does not bound. Retention and publication
    (`run(store=, publish=, thin=)`) are GibbsSampler's.
    """

    def __init__(
        self,
        ratings: SparseRatings,
        test: SparseRatings | None = None,
        *,
        k: int = 64,
        alpha: float = 1.5,
        burn_in: int = 200,
        widths="balanced",
        minibatch: int = 4096,
        step_size: float = 0.3,
        step_decay: float = 0.33,
        step_t0: float = 100.0,
        temperature: float = 1.0,
        temp_warmup: int = 0,
        precondition: bool = True,
        clip: float | None = 3.0,
        hyper_every: int = 1,
        accum_every: int = 1,
        device="cuda",
    ):
        self.minibatch = int(minibatch)
        self.step_size = float(step_size)
        self.step_decay = float(step_decay)
        self.step_t0 = float(step_t0)
        self.temperature = float(temperature)
        self.temp_warmup = int(temp_warmup)
        self.precondition = bool(precondition)
        self.clip = None if clip is None else float(clip)
        self.hyper_every = int(hyper_every)
        self.accum_every = int(accum_every)
        super().__init__(ratings, test, k=k, alpha=alpha, burn_in=burn_in, widths=widths,
                         engine="einsum", device=device)
        self.user_rows, self.user_scales = alloc_minibatch(self.user_plan_host,
                                                           self.minibatch)
        self.item_rows, self.item_scales = alloc_minibatch(self.item_plan_host,
                                                           self.minibatch)
        # the planner's degree profile, the preconditioner's shape
        self.deg_u = torch.as_tensor(ratings.degrees(0).astype(np.float32)).to(self.device)
        self.deg_v = torch.as_tensor(ratings.degrees(1).astype(np.float32)).to(self.device)
        self.init_scale = data_init_scale(ratings.vals, self.k)

    def init(self, seed: int = 0) -> BPMFState:
        state = super().init(seed)
        s = self.init_scale / 0.1
        return state._replace(u=state.u * s, v=state.v * s)

    def _draw_rows(self, buckets, n_rows) -> tuple:
        return tuple(
            None if s_b >= b.indices.shape[0] else
            torch.randint(b.indices.shape[0], (s_b,), generator=self.generator,
                          device=self.device)
            for b, s_b in zip(buckets, n_rows))

    def draw_noise(self, step: int = 0) -> SGLDNoise:
        """Step `step`'s noise from the sampler's generator."""
        g, k = self.generator, self.k
        hyper = step % self.hyper_every == 0
        hyper_v = draw_wishart_noise(self.prior, self.n, g) if hyper else None
        hyper_u = draw_wishart_noise(self.prior, self.m, g) if hyper else None
        rows_v = self._draw_rows(self.item_buckets, self.item_rows)
        rows_u = self._draw_rows(self.user_buckets, self.user_rows)
        z_v = torch.randn((self.n, k), generator=g, device=self.device)
        z_u = torch.randn((self.m, k), generator=g, device=self.device)
        return SGLDNoise(hyper_v=hyper_v, hyper_u=hyper_u, rows_v=rows_v, rows_u=rows_u,
                         z_v=z_v, z_u=z_u)

    def _gain(self, degrees, hyper, counterpart):
        if not self.precondition:
            return torch.ones_like(degrees)
        # the counterpart's per-coordinate second moment, O(n K)
        sig2 = torch.mean(counterpart * counterpart)
        return precond_gain(degrees, self.alpha, _lam_bar(hyper), sig2)

    def sweep(self, state: BPMFState, noise: SGLDNoise | None = None) -> BPMFState:
        """One SGLD step: two preconditioned Langevin half-steps."""
        step = state.step
        if noise is None:
            noise = self.draw_noise(step)
        eps = sgld_step_schedule(step, peak=self.step_size, decay=self.step_decay,
                                 t0=self.step_t0)
        temp = effective_temperature(step, self.temperature, self.temp_warmup)

        # exact Normal-Wishart draws from the previous factors, thinned
        hyper_v, hyper_u = state.hyper_v, state.hyper_u
        if step % self.hyper_every == 0:
            if noise.hyper_v is None or noise.hyper_u is None:
                raise ValueError(f"step {step} draws hypers and needs their noise")
            sv, su = factor_stats(state.v), factor_stats(state.u)
            hyper_v = sample_normal_wishart(sv.sum_x, sv.sum_xxt, sv.n, self.prior,
                                            noise.hyper_v)
            hyper_u = sample_normal_wishart(su.sum_x, su.sum_xxt, su.n, self.prior,
                                            noise.hyper_u)

        # movies: minibatch gradient of V given U
        g_lik = minibatch_likelihood_grad(state.v, state.u, self.item_buckets,
                                          self.item_rows, self.item_scales, noise.rows_v)
        grad_v = self.alpha * g_lik - (state.v - hyper_v.mu) @ hyper_v.lam
        v_new = langevin_update(state.v, grad_v, self._gain(self.deg_v, hyper_v, state.u),
                                eps, temp, z=noise.z_v, clip=self.clip)

        # users: minibatch gradient of U given the new V
        g_lik = minibatch_likelihood_grad(state.u, v_new, self.user_buckets,
                                          self.user_rows, self.user_scales, noise.rows_u)
        grad_u = self.alpha * g_lik - (state.u - hyper_u.mu) @ hyper_u.lam
        u_new = langevin_update(state.u, grad_u, self._gain(self.deg_u, hyper_u, v_new),
                                eps, temp, z=noise.z_u, clip=self.clip)

        # the posterior-predictive sum, thinned
        pred_sum, pred_count = state.pred_sum, state.pred_count
        if step >= self.burn_in and (step - self.burn_in) % self.accum_every == 0:
            pred_sum = pred_sum + self._predict(u_new, v_new)
            pred_count += 1
        return BPMFState(u=u_new, v=v_new, hyper_u=hyper_u, hyper_v=hyper_v,
                         step=step + 1, pred_sum=pred_sum, pred_count=pred_count)


# ---------------------------------------------------------------------------
# distributed sampler: the grid partition and exchange modes of Gibbs
# ---------------------------------------------------------------------------
class SGLDConfig(NamedTuple):
    step_size: float
    step_decay: float
    step_t0: float
    temperature: float
    temp_warmup: int
    u_rows: int          # sampled rows a (shard, block) in the user phase
    v_rows: int
    precondition: bool
    clip: float | None


def _pad_slot(factors: torch.Tensor) -> torch.Tensor:
    """The local factor block with a zero row appended: plan padding (seg
    == n_loc) reads it."""
    return torch.cat([factors, factors.new_zeros((1, factors.shape[-1]))])


def _sgld_grad_block(factors_pad: torch.Tensor, counter_blk: torch.Tensor, plan,
                     n_loc: int, rows: torch.Tensor | None, s_rows: int) -> torch.Tensor:
    """Scaled minibatch gradient (n_loc, K) of a shard's items against one
    counterpart block (or the gathered counterpart): `rows` sampled from
    the plan's R rows when s_rows < R, else every row. Padding rows (seg ==
    n_loc) have mask 0 and land in the dropped slot n_loc."""
    r_total = plan.indices.shape[0]
    if s_rows < r_total:
        if rows is None:
            raise ValueError("a sampled block needs its row ids")
        idx, val, msk, seg = (a[rows] for a in (plan.indices, plan.values, plan.mask,
                                                plan.seg))
        g = sum_rows_by_id(row_grads(factors_pad, counter_blk, idx, val, msk, seg),
                           seg, n_loc + 1)
        return (r_total / s_rows) * g[:n_loc]
    idx, val, msk, seg = _rows_by_slot(plan)
    sums = segment_reduce_rows(row_grads(factors_pad, counter_blk, idx, val, msk, seg),
                               plan.slot_off)
    g = sums.new_zeros((n_loc, sums.shape[-1]))
    return g.index_copy_(0, plan.slots, sums[:plan.slots.shape[0]])


def _sgld_phase_ring(counter, factors, side: _Side, rows, s_rows: int, ex) -> list:
    """The minibatch likelihood gradient of every shard held over the P ring
    steps: at step s shard p reads block (p - s) mod P through plan slice
    [p, (p - s) mod P] with its rows [i][s], while the forwards of the
    blocks run beside it; the blocks' gradients are added in step order."""
    n, n_loc = ex.n, side.n_loc
    pads = [_pad_slot(f) for f in factors]
    grads = [torch.zeros_like(f) for f in factors]
    ring = ex.ring(counter)
    for s in range(n):
        last = s == n - 1
        if not last:
            ring.forward()
        for i, p in enumerate(ex.shards):
            dg = _sgld_grad_block(pads[i], ring.held(i), side.plans[i][(p - s) % n], n_loc,
                                  rows[i][s], s_rows)
            ring.done(i)
            grads[i] = grads[i] + dg
        if not last:
            ring.advance()
    return grads


def _sgld_phase_async(u_blocks, v_blocks, v_side: _Side, u_side: _Side, rows_v, rows_u,
                      v_rows: int, u_rows: int, ex) -> tuple[list, list]:
    """Both half-steps' gradients in ONE ring: each step issues the
    forwards of the u and v blocks before either gradient reads its held
    block; the user gradient reads the previous step's v."""
    n = ex.n
    vp, up = [_pad_slot(f) for f in v_blocks], [_pad_slot(f) for f in u_blocks]
    gv, gu = [torch.zeros_like(f) for f in v_blocks], [torch.zeros_like(f) for f in u_blocks]
    ring_u = ex.ring(u_blocks)
    ring_v = ex.ring(v_blocks)
    for s in range(n):
        last = s == n - 1
        if not last:
            ring_u.forward()
            ring_v.forward()
        for i, p in enumerate(ex.shards):
            src = (p - s) % n
            dgv = _sgld_grad_block(vp[i], ring_u.held(i), v_side.plans[i][src], v_side.n_loc,
                                   rows_v[i][s], v_rows)
            ring_u.done(i)
            dgu = _sgld_grad_block(up[i], ring_v.held(i), u_side.plans[i][src], u_side.n_loc,
                                   rows_u[i][s], u_rows)
            ring_v.done(i)
            gv[i] = gv[i] + dgv
            gu[i] = gu[i] + dgu
        if not last:
            ring_u.advance()
            ring_v.advance()
    return gv, gu


def _sgld_phase_allgather(counter, factors, side: _Side, rows, s_rows: int, ex) -> list:
    """Sync baseline: gather the whole counterpart onto each shard, then one
    draw of P * s_rows rows from its flattened plan."""
    out = []
    for i, f in enumerate(factors):
        full = ex.all_gather(counter, f.device)
        out.append(_sgld_grad_block(_pad_slot(f), full, side.plans[i], side.n_loc, rows[i],
                                    ex.n * s_rows))
        del full
    return out


def _sgld_finish(factors: torch.Tensor, g_lik: torch.Tensor, z: torch.Tensor,
                 valid: torch.Tensor, hyper: HyperParams, alpha: float, gain: torch.Tensor,
                 eps, temperature, clip: float | None) -> torch.Tensor:
    """Gradient + prior + the items' noise -> one shard's Langevin step,
    padding slots 0. z holds the shard's slots' rows of the global noise,
    so the update does not depend on the layout."""
    grad = alpha * g_lik - (factors - hyper.mu) @ hyper.lam
    new = langevin_update(factors, grad, gain, eps, temperature, z=z, clip=clip)
    return torch.where(valid[:, None], new, 0.0)


class DistributedSGLD(DistributedBPMF):
    """Minibatch SGLD over the Gibbs grid partition, P shards in one process
    (`devices`) or one a rank (`mesh`), as DistributedBPMF.

    The plans, the LPT entity sharding and the exchange modes are
    DistributedBPMF's; a block's work is a sampled gradient instead of a
    syrk, and the finish a preconditioned Langevin step instead of a
    Cholesky draw. `minibatch` is the padded-lane budget a shard a
    half-step, split evenly over the P blocks a shard reads (ring, async)
    or drawn at once from its flattened plan (allgather). Async keeps the
    stale-by-one `v_eval`.
    """

    verbose_every = 50

    def __init__(
        self,
        ratings: SparseRatings,
        test: SparseRatings | None = None,
        *,
        devices: Sequence[torch.device] | None = None,
        mesh=None,
        k: int = 32,
        alpha: float = 1.5,
        width: int | str = 32,
        mode: str = "ring",
        minibatch: int = 4096,
        step_size: float = 0.3,
        step_decay: float = 0.33,
        step_t0: float = 100.0,
        temperature: float = 1.0,
        temp_warmup: int = 0,
        precondition: bool = True,
        clip: float | None = 3.0,
    ):
        self.minibatch = int(minibatch)
        self.init_scale = data_init_scale(ratings.vals, k)
        super().__init__(ratings, test, devices=devices, mesh=mesh, k=k, alpha=alpha,
                         width=width, mode=mode, engine="einsum")
        self.u_deg = self._shard_degrees(ratings.degrees(0), self.u_part)
        self.v_deg = self._shard_degrees(ratings.degrees(1), self.v_part)
        self.cfg = SGLDConfig(
            step_size=float(step_size), step_decay=float(step_decay),
            step_t0=float(step_t0), temperature=float(temperature),
            temp_warmup=int(temp_warmup), u_rows=self._rows_per_block(self.u_plan),
            v_rows=self._rows_per_block(self.v_plan), precondition=bool(precondition),
            clip=None if clip is None else float(clip))

    def _rows_per_block(self, plan) -> int:
        _, _, r, w = plan.indices.shape
        return int(min(r, max(1, round(self.minibatch / (self.n_shards * w)))))

    def _shard_degrees(self, degrees, part) -> tuple[torch.Tensor, ...]:
        """Each held shard's slots' degrees on the shard's device; padding
        slots get 0 (a finite gain, 1 / lam_bar, zeroed by the finish)."""
        degrees = np.asarray(degrees, np.float32)
        return tuple(
            torch.as_tensor(np.where(part.ids[p] >= 0, degrees[np.maximum(part.ids[p], 0)],
                                     0.0).astype(np.float32)).to(d)
            for p, d in zip(self.shards, self.devices))

    def init(self, seed: int = 0) -> DistState:
        state = super().init(seed)
        s = self.init_scale / 0.1
        u = tuple(x * s for x in state.u)
        v = tuple(x * s for x in state.v)
        return state._replace(u=u, v=v, v_eval=v if self.mode == "async" else None)

    def _draw_rows(self, plan, s_rows: int) -> tuple:
        """Every shard's row ids, drawn in (shard, ring step) order whatever
        the layout (so every rank's generator stays in step), each held
        shard's on its device."""
        p_n, _, r, _ = plan.indices.shape
        dev0, g = self.devices[0], self.generator

        def draw(count, total):
            if count >= total:
                return None
            return torch.randint(total, (count,), generator=g, device=dev0)

        def put(x, dev):
            return None if x is None else x.to(dev)

        if self.mode == "allgather":
            rows = [draw(p_n * s_rows, p_n * r) for _ in range(p_n)]
            return tuple(put(rows[p], d) for p, d in zip(self.shards, self.devices))
        rows = [[draw(s_rows, r) for _ in range(p_n)] for _ in range(p_n)]
        return tuple(tuple(put(x, d) for x in rows[p]) for p, d in zip(self.shards, self.devices))

    def draw_noise(self) -> SGLDNoise:
        """One step's noise from the generator: the row ids in (shard, ring
        step) order, z in global id order."""
        g, dev0, k = self.generator, self.devices[0], self.k
        hyper_v = draw_wishart_noise(self.prior, self.n, g)
        hyper_u = draw_wishart_noise(self.prior, self.m, g)
        rows_v = self._draw_rows(self.v_plan, self.cfg.v_rows)
        rows_u = self._draw_rows(self.u_plan, self.cfg.u_rows)
        z_v = torch.randn((self.n, k), generator=g, device=dev0)
        z_u = torch.randn((self.m, k), generator=g, device=dev0)
        return SGLDNoise(hyper_v=hyper_v, hyper_u=hyper_u, rows_v=rows_v, rows_u=rows_u,
                         z_v=z_v, z_u=z_u)

    def _gains(self, degrees, hyper: HyperParams, counter_stats) -> tuple:
        if not self.cfg.precondition:
            return tuple(torch.ones_like(d) for d in degrees)
        _, sum_xxt, n = counter_stats
        sig2 = torch.trace(sum_xxt) / (n * self.k)
        lam_bar = _lam_bar(hyper)
        return tuple(precond_gain(d, self.alpha, lam_bar.to(d.device), sig2.to(d.device))
                     for d in degrees)

    def _finish(self, factors, g_lik, side: _Side, hyper: HyperParams, gains, eps, temp,
                z_global: torch.Tensor) -> tuple[torch.Tensor, ...]:
        out = []
        for p, (f, g) in enumerate(zip(factors, g_lik)):
            dev = f.device
            z = z_global[side.ids[p].to(z_global.device)].to(dev)
            h = HyperParams(mu=hyper.mu.to(dev), lam=hyper.lam.to(dev))
            out.append(_sgld_finish(f, g, z, side.valid[p], h, self.alpha, gains[p], eps,
                                    temp, self.cfg.clip))
        return tuple(out)

    def _grad_phase(self, counter, factors, side: _Side, rows, s_rows: int) -> list:
        if self.mode == "ring":
            return _sgld_phase_ring(counter, factors, side, rows, s_rows, self.exchange)
        return _sgld_phase_allgather(counter, factors, side, rows, s_rows, self.exchange)

    def sweep(self, state: DistState, noise: SGLDNoise | None = None) -> DistState:
        """One SGLD step over the P shards, under `noise` (drawn from the
        generator when None)."""
        if noise is None:
            noise = self.draw_noise()
        cfg = self.cfg
        eps = sgld_step_schedule(state.step, peak=cfg.step_size, decay=cfg.step_decay,
                                 t0=cfg.step_t0)
        temp = effective_temperature(state.step, cfg.temperature, cfg.temp_warmup)
        # exact hyper draws from the psum'd statistics of the previous factors
        sv = _stats(state.v, self._v.valid, self.n, self.exchange)
        hyper_v = sample_normal_wishart(*sv, self.prior, noise.hyper_v)
        su = _stats(state.u, self._u.valid, self.m, self.exchange)
        hyper_u = sample_normal_wishart(*su, self.prior, noise.hyper_u)
        gain_v = self._gains(self.v_deg, hyper_v, su)
        gain_u = self._gains(self.u_deg, hyper_u, sv)

        if self.mode == "async":
            glv, glu = _sgld_phase_async(state.u, state.v, self._v, self._u, noise.rows_v,
                                         noise.rows_u, cfg.v_rows, cfg.u_rows, self.exchange)
            v_new = self._finish(state.v, glv, self._v, hyper_v, gain_v, eps, temp, noise.z_v)
            u_new = self._finish(state.u, glu, self._u, hyper_u, gain_u, eps, temp, noise.z_u)
            # u_new's gradient read this v
            return DistState(u=u_new, v=v_new, hyper_u=hyper_u, hyper_v=hyper_v,
                             step=state.step + 1, v_eval=state.v)

        glv = self._grad_phase(state.u, state.v, self._v, noise.rows_v, cfg.v_rows)
        v_new = self._finish(state.v, glv, self._v, hyper_v, gain_v, eps, temp, noise.z_v)
        glu = self._grad_phase(v_new, state.u, self._u, noise.rows_u, cfg.u_rows)
        u_new = self._finish(state.u, glu, self._u, hyper_u, gain_u, eps, temp, noise.z_u)
        return DistState(u=u_new, v=v_new, hyper_u=hyper_u, hyper_v=hyper_v,
                         step=state.step + 1)
