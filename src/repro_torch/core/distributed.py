"""Distributed BPMF: ring-pipelined, all-gather and stale-by-one samplers.

The paper's central result (Sec 4.3, Fig 5-6) is that one-sided
asynchronous communication hides most of the exchange behind computation
while bulk-synchronous exchange hides none. `repro.core.distributed` runs
the three exchange modes as one program over a mesh. This port runs them
in one of two layouts (`core/exchange.py`):

  devices=  one process holds the P shards, shard p's factor rows and
            plans on devices[p] (all on one card, or round-robin over
            several: `shard_devices`), the collectives copies between them;
  mesh=     one process a shard: rank r of a 1-D DeviceMesh over "items"
            (the JAX `AXIS`) holds shard r, and the collectives are
            torch.distributed messages (isend/irecv, all-gather). Every
            rank builds the same partitions and plans on the host and
            keeps its own row of them; the hyperparameter draws and the
            sweep's noise are drawn whole on every rank from a generator
            seeded alike, so every rank holds the same hyperparameters,
            and each takes its own rows of the noise.

A shard's work is the same in both: rank r's sweep gives shard r of the
one-process sweep bit for bit (same blocks in the same order, the same
rank-order sums). The modes:

  "allgather"  gather the whole counterpart onto each shard, then sweep:
               all communication up front, none overlapped.
  "ring"       the counterpart stays sharded; at each of P steps shard p
               accumulates against the block it holds while the copies
               that forward every block to shard p + 1 run on a copy
               stream. Phases stay sequential: the user phase waits for
               the full v draw.
  "async"      both phases ride one ring: each step issues the forwards of
               the u and v blocks before either accumulate, then
               accumulates movie statistics against the held u block and
               user statistics against the held v block. The user update
               reads the PREVIOUS sweep's v: stale by exactly one draw,
               the bounded staleness Gibbs tolerates (arXiv 2004.02561,
               1503.01596). `v_eval` is the v that u was conditioned on.

Every mode shares plans and noise, and the noise of an item depends only on
its global id (`SweepNoise` holds z in global order; each shard gathers the
rows of its items), never on the layout. So an async sweep's v draw is bit
for bit the ring sweep's from the same state: the movie phase consumes the
same inputs in the same order.

Per-block statistics go through `_accumulate_block`: the einsum reference
or the fused gather_syrk_seg kernel (DIST_ENGINES). The kernel's segments
are scattered into each shard's accumulator with unique indices, one block
after the other, no atomics. The solve is the library Cholesky and
`chol_subst_solve`, as in the JAX package.

With the shards on several cards, what crosses between cards inside a
sweep goes on the exchange's copy streams (`core/exchange.py`): the ring's
blocks, and each side's hyperparameters and the shard's rows of the noise,
sent from shard 0's card as soon as the side's draws are issued and waited
on only by that shard's solve. The psum of the factor statistics, which
every shard's draws need, is the one place the cards meet. Nothing in a
sweep waits on the host. Spans (`repro_torch/spans.py`, recorded only
while a profiler records): `dist.sweep` on shard 0's card; `dist.stats`,
each side's statistics and Normal-Wishart draw, there too; on each shard's
card `dist.accumulate` (a block's statistics), `dist.solve` (a shard's
half-sweep solve) and, from the exchange, `dist.wait` and `dist.exchange`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.exchange import LocalExchange, RankExchange, mesh_shard
from repro_torch.core.gibbs import (
    SweepNoise,
    chol_subst_solve,
    draw_sweep_noise,
    segment_reduce_rows,
)
from repro_torch.core.hyper import (
    HyperParams,
    cholesky_or_nan,
    default_prior,
    init_hyper,
    sample_normal_wishart,
)
from repro_torch.core.partition import GridPlan, build_grid_plan, partition_entities
from repro_torch.data.sparse import SparseRatings
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.spans import span

# stats engines the distributed sweep supports: the einsum reference and the
# fused gather-syrk kernel (core.gibbs.ENGINES documents the family)
DIST_ENGINES = ("einsum", "fused")

# exchange modes: see the module docstring
DIST_MODES = ("ring", "allgather", "async")

__all__ = [
    "DIST_ENGINES", "DIST_MODES", "BlockPlan", "DistState", "DistributedBPMF",
    "dist_state_from_numpy", "shard_devices",
]


class DistState(NamedTuple):
    # the shards this process holds (all P, or a rank's one), in the
    # sampler's `shards` order, each on its device
    u: tuple[torch.Tensor, ...]     # (m_loc, K) user factor shards
    v: tuple[torch.Tensor, ...]     # (n_loc, K)
    hyper_u: HyperParams            # on devices[0], the same on every rank
    hyper_v: HyperParams
    step: int
    # async mode only (None otherwise): the v the u draw was conditioned
    # on, one sweep stale. The stale-by-one sweep interleaves two valid
    # Gibbs chains, so predictions pair u with v_eval.
    v_eval: tuple[torch.Tensor, ...] | None = None


class BlockPlan(NamedTuple):
    """One shard's rows against one counterpart block (ring, async) or
    against the gathered counterpart (allgather), on the shard's device."""

    indices: torch.Tensor     # (R, W) int32, into the counterpart rows
    values: torch.Tensor      # (R, W) f32
    mask: torch.Tensor        # (R, W) f32
    seg: torch.Tensor         # (R,) int64 local item slot of each row, n_loc for padding
    seg_dense: torch.Tensor   # (R,) int32 dense nondecreasing segment ids
    seg_ptr: torch.Tensor     # (n_segments + 1,) int32 row offsets of the segments
    n_segments: int
    # the real segments of each counterpart block, in block order: (first
    # dense segment, local item slots); the pad segment is left out
    targets: tuple[tuple[int, torch.Tensor], ...]
    # the order-fixed segment sums of the einsum engine and of SGLD, by
    # local slot: the rows sorted stably by `seg` (None where seg is
    # nondecreasing already, as in every ring block; the allgather plan's
    # blocks follow each other), the real slots that have rows, ascending,
    # and the row offsets of their runs in the sorted rows, then of the
    # padding rows' run (slot n_loc, last, dropped)
    seg_order: torch.Tensor | None
    slots: torch.Tensor        # (n_slots,) int64
    slot_off: torch.Tensor     # (n_slots + 2,) int32


def shard_devices(n_shards: int | None = None, device="cuda") -> list[torch.device]:
    """Devices for n_shards shards: round-robin over the visible cards (all
    on cuda:0 with one card; None is one shard a card), or all on the CPU
    for device="cpu" (None is one shard). Raises without a card unless the
    CPU is asked for."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * (n_shards or 1)
    count = torch.cuda.device_count()
    return [torch.device("cuda", p % count) for p in range(n_shards or count)]


def _block_plan(idx, val, msk, seg, seg_dense, seg_map, n_dense, n_loc, device
                ) -> BlockPlan:
    """A BlockPlan from host arrays: rows (R, W) and (R,), their dense
    segment ids and map, and each counterpart block's dense segment count
    (the rows of block q follow those of block q - 1)."""
    targets, first = [], 0
    for d in n_dense:
        slots = seg_map[first:first + d]
        real = int((slots < n_loc).sum())   # the pad segment, if any, is last
        targets.append((first, torch.as_tensor(slots[:real].astype(np.int64)).to(device)))
        first += d

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    seg = seg.astype(np.int64)
    order = None if np.all(np.diff(seg) >= 0) else np.argsort(seg, kind="stable")
    ordered = seg if order is None else seg[order]
    slots = np.unique(ordered[ordered < n_loc])
    slot_off = np.concatenate([np.searchsorted(ordered, slots),
                               [np.searchsorted(ordered, n_loc), len(ordered)]])
    return BlockPlan(
        indices=put(idx), values=put(val), mask=put(msk), seg=put(seg),
        seg_dense=put(seg_dense), seg_ptr=put(kops.segment_offsets(seg_dense, first)),
        n_segments=first, targets=tuple(targets),
        seg_order=None if order is None else put(order),
        slots=put(slots), slot_off=put(slot_off.astype(np.int32)),
    )


def _ring_plans(plan: GridPlan, devices, shards=None) -> tuple[tuple[BlockPlan, ...], ...]:
    """[i][q]: shard shards[i]'s rows against counterpart block q, on
    devices[i] (shards: every shard, one a device, by default)."""
    n_dense = plan.seg_dense[:, :, -1] + 1
    shards = range(len(devices)) if shards is None else shards
    return tuple(
        tuple(_block_plan(plan.indices[p, q], plan.values[p, q], plan.mask[p, q],
                          plan.seg[p, q], plan.seg_dense[p, q], plan.seg_map[p, q],
                          [int(n_dense[p, q])], plan.n_loc, dev)
              for q in range(plan.n_shards))
        for p, dev in zip(shards, devices))


def _flat_plans(plan: GridPlan, devices, shards=None) -> tuple[BlockPlan, ...]:
    """Per-shard flattened plan against the FULL counterpart (allgather),
    [i] for shard shards[i] on devices[i].

    Block-local indices are rebased to gathered offsets q * n_counter_loc
    + i, and the per-block dense segment ids by the segment counts of the
    blocks before, so the flattened ids stay dense and nondecreasing, the
    fused engine's invariant."""
    p_n, _, r, w = plan.indices.shape
    n_dense = plan.seg_dense[:, :, -1] + 1
    offs = (np.arange(p_n) * plan.n_counter_loc).astype(np.int32)[:, None, None]
    shards = range(len(devices)) if shards is None else shards
    out = []
    for p, dev in zip(shards, devices):
        base = np.concatenate([[0], np.cumsum(n_dense[p])[:-1]]).astype(np.int32)
        seg_map = np.concatenate([plan.seg_map[p, q, :n_dense[p, q]] for q in range(p_n)])
        out.append(_block_plan(
            (plan.indices[p] + offs).reshape(p_n * r, w),
            plan.values[p].reshape(p_n * r, w), plan.mask[p].reshape(p_n * r, w),
            plan.seg[p].reshape(p_n * r), (plan.seg_dense[p] + base[:, None]).reshape(-1),
            seg_map, [int(d) for d in n_dense[p]], plan.n_loc, dev))
    return tuple(out)


def _accumulate_block(prec: torch.Tensor, rhs: torch.Tensor, counter_blk: torch.Tensor,
                      plan: BlockPlan, *, engine: str = "einsum") -> None:
    """Add one block's (sum v v^T, sum r v) into each local item's prec
    (n_loc, K, K) and rhs (n_loc, K).

    einsum: gathered block, row-level einsums and the order-fixed segment
    sum of each slot's rows, added into the slots the block has rows for
    (the padding rows' sum is dropped). fused:
    `ops.gather_syrk_seg` over the block's dense segments, whose real
    segments are then added into their items' slots, block by block (an
    item's slots are unique within a block), in place of the reference's
    scatter-add into zeros: the same additions in the same order."""
    with span("dist.accumulate", prec.device):
        if engine == "fused":
            prec_seg, rhs_seg = kops.gather_syrk_seg(
                plan.indices, plan.values, plan.mask, plan.seg_dense, plan.n_segments,
                counter_blk, seg_ptr=plan.seg_ptr)
            for first, slots in plan.targets:
                d = slots.shape[0]
                prec[slots] += prec_seg[first:first + d]
                rhs[slots] += rhs_seg[first:first + d]
            return
        idx, val, msk, _ = _rows_by_slot(plan)
        vm = counter_blk[idx.long()] * msk[..., None]    # (R, W, K)
        prec_rows = torch.einsum("rwk,rwl->rkl", vm, vm)
        rhs_rows = torch.einsum("rwk,rw->rk", vm, val * msk)
        n = plan.slots.shape[0]
        prec[plan.slots] += segment_reduce_rows(prec_rows, plan.slot_off)[:n]
        rhs[plan.slots] += segment_reduce_rows(rhs_rows, plan.slot_off)[:n]


def _rows_by_slot(plan: BlockPlan) -> tuple[torch.Tensor, ...]:
    """The plan's (indices, values, mask, seg) in the order of
    `plan.seg_order`: each slot's rows contiguous, in the plan's order
    (`plan.slot_off` delimits the runs)."""
    rows = (plan.indices, plan.values, plan.mask, plan.seg)
    if plan.seg_order is None:
        return rows
    return tuple(a[plan.seg_order] for a in rows)


class _Side(NamedTuple):
    """One half-sweep's items: per shard held, the slots' global ids
    (clamped at 0: the noise rows a padding slot reads), on the device the
    noise is drawn on, which slots are real, on the shard's device, and the
    plans (ring: [i][q]; allgather: [i])."""

    n_loc: int
    ids: tuple[torch.Tensor, ...]
    valid: tuple[torch.Tensor, ...]
    plans: tuple


def _zeros(side: _Side, k: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(torch.zeros((side.n_loc, k, k), device=d.device),
             torch.zeros((side.n_loc, k), device=d.device)) for d in side.valid]


def _phase_ring(counter, side: _Side, engine, ex, k: int) -> list:
    """One ring half-sweep's raw statistics: at step s shard p holds
    counterpart block (p - s) mod P and accumulates it through plan slice
    [p, (p - s) mod P]; the partials are summed in step order. `ex` is the
    exchange (`core/exchange.py`); the shards are the ones it holds."""
    n = ex.n
    acc = _zeros(side, k)
    ring = ex.ring(counter)
    for s in range(n):
        last = s == n - 1
        if not last:
            ring.forward()          # step s + 1's blocks, beside this step's sums
        for i, p in enumerate(ex.shards):
            _accumulate_block(*acc[i], ring.held(i), side.plans[i][(p - s) % n],
                              engine=engine)
            ring.done(i)
        if not last:
            ring.advance()
    return acc


def _phase_ring_async(u_blocks, v_blocks, v_side: _Side, u_side: _Side, engine,
                      ex, k: int) -> tuple[list, list]:
    """Both phases' raw statistics in ONE ring: each step issues the
    forwards of the u and v blocks before either accumulate, then adds the
    movie statistics against the held u block and the user statistics
    against the held v block (the previous sweep's v)."""
    n = ex.n
    acc_v, acc_u = _zeros(v_side, k), _zeros(u_side, k)
    ring_u = ex.ring(u_blocks)
    ring_v = ex.ring(v_blocks)
    for s in range(n):
        last = s == n - 1
        if not last:
            ring_u.forward()
            ring_v.forward()
        for i, p in enumerate(ex.shards):
            src = (p - s) % n
            _accumulate_block(*acc_v[i], ring_u.held(i), v_side.plans[i][src], engine=engine)
            ring_u.done(i)
            _accumulate_block(*acc_u[i], ring_v.held(i), u_side.plans[i][src], engine=engine)
            ring_v.done(i)
        if not last:
            ring_u.advance()
            ring_v.advance()
    return acc_v, acc_u


def _phase_allgather(counter, side: _Side, engine, ex, k: int) -> list:
    """Sync baseline: gather the whole counterpart onto each shard, then
    accumulate its flattened plan in one call."""
    acc = _zeros(side, k)
    for i, (prec, rhs) in enumerate(acc):
        full = ex.all_gather(counter, prec.device)
        _accumulate_block(prec, rhs, full, side.plans[i], engine=engine)
        del full
    return acc


def _chol_sample(prec, rhs, z):
    return chol_subst_solve(cholesky_or_nan(prec), rhs, z)


def _deliver(side: _Side, hyper: HyperParams, z_global: torch.Tensor, ex) -> list:
    """What each shard's solve reads from the device of the draws: (lam,
    mu, its slots' rows of z) on the shard's device, and the event its
    stream waits on before reading them (`ex.deliver`)."""
    out = []
    for p, valid in enumerate(side.valid):
        z = z_global[side.ids[p].to(z_global.device)]
        out.append(ex.deliver([hyper.lam, hyper.mu, z], valid.device))
    return out


def _finish_phase(acc: list, side: _Side, placed: list, alpha: float
                  ) -> tuple[torch.Tensor, ...]:
    """Raw accumulated statistics -> each shard's posterior draw, given
    what `_deliver` placed on its device; padding slots are 0. The
    accumulators are consumed (scaled in place)."""
    out = []
    for p in range(len(acc)):
        prec, rhs = acc[p]
        acc[p] = None                       # a shard's systems are gigabytes
        dev = prec.device
        (lam, mu, z), arrived = placed[p]
        if arrived is not None:
            torch.cuda.current_stream(dev).wait_event(arrived)
        with span("dist.solve", dev):
            prec.mul_(alpha).add_(lam)      # lam + alpha * prec
            rhs.mul_(alpha).add_(lam @ mu)
            new = _chol_sample(prec, rhs, z)
            del prec, rhs
            out.append(torch.where(side.valid[p][:, None], new, 0.0))
    return tuple(out)


def _stats(x: Sequence[torch.Tensor], valid: Sequence[torch.Tensor], n: int, ex):
    """(sum x, sum x x^T, n) over the real rows of every shard: psum in
    shard order (`ex.psum`), on shard 0's device or on every rank."""
    xm = [torch.where(ok[:, None], xs, 0.0) for xs, ok in zip(x, valid)]
    return ex.psum([a.sum(0) for a in xm]), ex.psum([a.T @ a for a in xm]), n


def dist_state_from_numpy(*, u, v, hyper_u, hyper_v, devices=None, mesh=None, step=0,
                          v_eval=None) -> DistState:
    """The port's DistState from the reference's fields as numpy arrays: u
    and v (P, n_loc, K) by shard, hyper_u and hyper_v (mu, lam) pairs (a
    jax HyperParams converts field by field), v_eval (P, n_loc, K) or None.
    With `devices` shard p goes to devices[p]; with `mesh` (a 1-D "items"
    DeviceMesh) this rank's row r goes to its device: the JAX package's
    state carried over to the ranks. The JAX PRNG key is not carried: the
    port's noise is explicit."""
    if (devices is None) == (mesh is None):
        raise ValueError("pass devices= (the P shards here) or mesh= (this rank's shard)")
    if mesh is None:
        shard_ids = range(len(devices))
    else:
        rank, device = mesh_shard(mesh)
        shard_ids, devices = (rank,), [device]

    def shards(a):
        a = np.asarray(a, np.float32)
        return tuple(torch.tensor(a[p], device=d) for p, d in zip(shard_ids, devices))

    def hyper(pair):
        mu, lam = pair
        return HyperParams(mu=torch.tensor(np.asarray(mu, np.float32), device=devices[0]),
                           lam=torch.tensor(np.asarray(lam, np.float32), device=devices[0]))

    return DistState(u=shards(u), v=shards(v), hyper_u=hyper(hyper_u),
                     hyper_v=hyper(hyper_v), step=int(step),
                     v_eval=None if v_eval is None else shards(v_eval))


class DistributedBPMF:
    """BPMF over P item shards, paper Sec 4: all P in this process
    (`devices`), or this rank's one (`mesh`).

    `devices` holds each shard's device; the default is one shard a
    visible card (`shard_devices()`), and without a card it raises unless
    the caller passes CPU devices. One card takes several shards:
    `devices=shard_devices(4)` puts four on cuda:0. `mesh` is a 1-D
    DeviceMesh over the dim "items" (`launch/mesh.py::make_item_mesh`):
    P is its size and this process holds shard r, its rank, on the
    current card (a "cuda" mesh) or the CPU (a "cpu" mesh). Every rank
    constructs the sampler and calls every method in the same order: each
    sweep, `gather_factors` and `rmse` are collectives.
    """

    def __init__(
        self,
        ratings: SparseRatings,
        test: SparseRatings | None = None,
        *,
        devices: Sequence[torch.device] | None = None,
        mesh=None,
        k: int = 32,
        alpha: float = 1.5,
        width: int | str = 32,       # "auto": degree-aware grid width
        mode: str = "ring",          # ring | allgather | async (DIST_MODES)
        engine: str = "einsum",      # einsum | fused (DIST_ENGINES)
    ):
        if mode not in DIST_MODES:
            raise ValueError(f"mode must be one of {DIST_MODES}, got {mode!r}")
        if engine not in DIST_ENGINES:
            raise ValueError(f"engine must be one of {DIST_ENGINES}, got {engine!r}")
        if mesh is not None and devices is not None:
            raise ValueError("pass devices= (P shards in this process) or mesh= (one "
                             "shard a rank), not both")
        if mesh is not None:
            self.exchange = RankExchange(mesh)
            devices = [self.exchange.device]
        else:
            if devices is None:
                devices = shard_devices()
            # a card with its index: the copy streams are keyed by the tensors' devices
            devices = [torch.empty(0, device=resolve_device(d)).device for d in devices]
            # two streams a card: the copies out of it, and the landing
            # that fences the copies into it (core/exchange.py)
            cards = {d for d in devices if d.type == "cuda"}
            self.exchange = LocalExchange(len(devices),
                                          {d: torch.cuda.Stream(d) for d in cards},
                                          {d: torch.cuda.Stream(d) for d in cards})
        self.devices = devices
        self.shards = self.exchange.shards
        self.n_shards = self.exchange.n
        self.k = k
        self.alpha = alpha
        self.mode = mode
        self.engine = engine
        self.global_mean = ratings.mean()
        self.test = test
        centered = ratings.centered()

        p = self.n_shards
        self.u_part = partition_entities(centered.degrees(0), p)
        self.v_part = partition_entities(centered.degrees(1), p)
        # user-update plan: rows = users, counterpart = movies
        self.u_plan = build_grid_plan(centered, self.u_part, self.v_part, width=width)
        self.v_plan = build_grid_plan(centered.transpose(), self.v_part, self.u_part,
                                      width=width)
        self.prior = default_prior(k, device=devices[0])
        self.generator = torch.Generator(device=devices[0])
        self.m, self.n = ratings.shape
        self._u = self._side(self.u_part, self.u_plan)
        self._v = self._side(self.v_part, self.v_plan)

    def _side(self, part, plan: GridPlan) -> _Side:
        plans = (_flat_plans(plan, self.devices, self.shards) if self.mode == "allgather"
                 else _ring_plans(plan, self.devices, self.shards))
        ids = tuple(torch.as_tensor(np.maximum(part.ids[p], 0).astype(np.int64)
                                    ).to(self.devices[0]) for p in self.shards)
        valid = tuple(torch.as_tensor(part.ids[p] >= 0).to(d)
                      for p, d in zip(self.shards, self.devices))
        return _Side(n_loc=part.n_loc, ids=ids, valid=valid, plans=plans)

    @classmethod
    def from_sides(cls, m: int, n: int, u_side: _Side, v_side: _Side, *, k: int,
                   alpha: float = 1.5, mode: str = "ring", engine: str = "einsum"
                   ) -> "DistributedBPMF":
        """A sampler over sides given as they are, with no ratings and no
        planner: the dry-run's plans of the right shapes on the meta device
        (`launch/bpmf_dryrun.py`). Its noise is drawn without a generator
        (the meta device has none); it has no test split."""
        self = cls.__new__(cls)
        self.devices = [valid.device for valid in u_side.valid]
        self.exchange = LocalExchange(len(self.devices), {})
        self.shards = self.exchange.shards
        self.n_shards = self.exchange.n
        self.k, self.alpha, self.mode, self.engine = k, alpha, mode, engine
        self.global_mean, self.test = 0.0, None
        self.m, self.n = m, n
        self._u, self._v = u_side, v_side
        self.prior = default_prior(k, device=self.devices[0])
        self.generator = None
        return self

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> DistState:
        """Reseed the generator and draw the initial factors, 0.1 N(0, 1)
        in every (shard, slot), as the reference does; each process keeps
        the shards it holds."""
        self.generator.manual_seed(seed)
        dev0, g = self.devices[0], self.generator

        def draw(n_loc):
            x = 0.1 * torch.randn((self.n_shards, n_loc, self.k), generator=g, device=dev0)
            return tuple(x[p].to(d) for p, d in zip(self.shards, self.devices))

        u = draw(self._u.n_loc)
        v = draw(self._v.n_loc)
        return DistState(u=u, v=v, hyper_u=init_hyper(self.k, device=dev0),
                         hyper_v=init_hyper(self.k, device=dev0), step=0,
                         v_eval=v if self.mode == "async" else None)

    def draw_noise(self) -> SweepNoise:
        """One sweep's noise from the generator, z in global id order (whole
        on every rank: each takes its own rows)."""
        return draw_sweep_noise(self.prior, self.m, self.n, self.generator)

    def sweep(self, state: DistState, noise: SweepNoise | None = None) -> DistState:
        """One full Gibbs sweep, both phases and both hyper draws, under
        `noise` (drawn from the generator when None)."""
        with span("dist.sweep", self.devices[0]):
            if noise is None:
                noise = self.draw_noise()
            k, alpha, engine, ex = self.k, self.alpha, self.engine, self.exchange
            # both hyper draws read the PREVIOUS sweep's factors in every mode
            hyper_v, to_v = self._hyper(state.v, self._v, self.n, noise.hyper_v, noise.z_v)
            if self.mode == "async":
                hyper_u, to_u = self._hyper(state.u, self._u, self.m, noise.hyper_u,
                                            noise.z_u)
                acc_v, acc_u = _phase_ring_async(state.u, state.v, self._v, self._u, engine,
                                                 ex, k)
                v_new = _finish_phase(acc_v, self._v, to_v, alpha)
                u_new = _finish_phase(acc_u, self._u, to_u, alpha)
            else:
                v_new = _finish_phase(self._phase(state.u, self._v), self._v, to_v, alpha)
                hyper_u, to_u = self._hyper(state.u, self._u, self.m, noise.hyper_u,
                                            noise.z_u)
                u_new = _finish_phase(self._phase(v_new, self._u), self._u, to_u, alpha)
            # done everywhere once done on shard 0's device
            ex.join(self.devices[0])
        return DistState(u=u_new, v=v_new, hyper_u=hyper_u, hyper_v=hyper_v,
                         step=state.step + 1, v_eval=state.v if self.mode == "async" else None)

    def _hyper(self, x, side: _Side, n: int, wishart, z_global) -> tuple[HyperParams, list]:
        """One side's (mu, Lambda) from the previous factors `x`, drawn on
        shard 0's device (the span `dist.stats`), and each shard's copy of
        what its solve reads (`_deliver`)."""
        with span("dist.stats", self.devices[0]):
            hyper = sample_normal_wishart(*_stats(x, side.valid, n, self.exchange),
                                          self.prior, wishart)
        return hyper, _deliver(side, hyper, z_global, self.exchange)

    def _phase(self, counter, side: _Side) -> list:
        if self.mode == "ring":
            return _phase_ring(counter, side, self.engine, self.exchange, self.k)
        return _phase_allgather(counter, side, self.engine, self.exchange, self.k)

    def gather_factors(self, state: DistState, *, coupled: bool = True
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(M, K), (N, K) in global entity order (host-side, for eval), on
        every rank.

        In async mode the u draw conditioned on the PREVIOUS sweep's v, so
        the jointly-coupled sample, the one predictions must use, is
        (u, v_eval). The fresh-but-uncoupled v (what the next sweep
        consumes, and what ring's first sweep matches bit for bit) is
        returned with coupled=False.
        """
        v_src = state.v if (state.v_eval is None or not coupled) else state.v_eval
        host = torch.device("cpu")

        def place(shards, part, n):
            x = self.exchange.all_gather(shards, host).numpy()
            out = np.zeros((n, self.k), np.float32)
            real = part.ids >= 0
            out[part.ids[real]] = x[real.reshape(-1)]
            return out

        return place(state.u, self.u_part, self.m), place(v_src, self.v_part, self.n)

    def rmse(self, state: DistState) -> float:
        if self.test is None:
            return float("nan")
        u, v = self.gather_factors(state)
        pred = np.einsum("nk,nk->n", u[self.test.rows], v[self.test.cols]) + self.global_mean
        return float(np.sqrt(np.mean((pred - self.test.vals) ** 2)))

    verbose_every = 5

    def run(self, n_sweeps: int, seed: int = 0, verbose: bool = False) -> DistState:
        """n_sweeps from `init(seed)`; with `verbose` the test RMSE every
        `verbose_every` sweeps (a collective: every rank computes it), printed
        by the process that holds shard 0."""
        state = self.init(seed)
        for i in range(n_sweeps):
            state = self.sweep(state)
            if verbose and (i % self.verbose_every == 0 or i == n_sweeps - 1):
                rmse = self.rmse(state)
                if 0 in self.shards:
                    print(f"sweep {i:3d} rmse {rmse:.4f}")
        return state
