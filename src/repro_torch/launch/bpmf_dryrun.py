"""BPMF dry-run of the port: one sweep of `core/distributed.py::DistributedBPMF`
at the paper's full scales on the meta device under the cost counter, the
counterpart of `repro/launch/bpmf_dryrun.py`.

The JAX dry-run feeds the planner's shapes as ShapeDtypeStructs, with no
plan arrays made. So does this one: `estimated_sides` builds each shard's
block plans on the meta device from `plan_shape`'s estimate (no planner
over 20 M ratings), and `DistributedBPMF.from_sides` runs a sweep over them
under `launch/cost.py::CostCounter`, for the ring and the all-gather
exchange, P shards on one card (4 by default; 256 and 512 as the JAX
CLI's meshes, reported per shard and in total).

    python -m repro_torch.launch.bpmf_dryrun [--dataset chembl|ml20m|both]
        [--mode ring|allgather|both] [--shards 4] [--engine einsum|fused]
    python -m repro_torch.launch.bpmf_dryrun --dataset ml20m --mode ring \\
        --engine fused --run                        # on the card instead

`--run` makes the data (`movielens_like(1.0)` or `chembl_like(1.0)`) and
the real plans (width "auto"), counts the sweep on the meta device at their
exact shapes, and runs it on the card (`measure`). Records go to
artifacts/dryrun_torch/bpmf-<dataset>-<mode>__K<k>__P<shards>[__<engine>][__run].json.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import numpy as np
import torch

from repro_torch.core.distributed import BlockPlan, DistributedBPMF, DistState, _Side
from repro_torch.core.hyper import init_hyper
from repro_torch.launch.cost import CostCounter, compute_s_by_pipe, roofline_terms
from repro_torch.launch.dryrun import ART_DIR, META, storage_bytes, tensors_of
from repro_torch.launch.mesh import BF16_TENSOR_FLOPS, HBM_BYTES, HBM_BYTES_PER_S, \
    NVLINK_BYTES_PER_S

DATASETS = {
    # (n_users, n_items, nnz) at full paper scale
    "chembl": (483_500, 5_775, 1_023_952),
    "ml20m": (138_493, 27_278, 20_000_000),
}


def plan_shape(m: int, n: int, nnz: int, p: int, width: int) -> tuple[int, int, int]:
    """(m_loc, n_loc, rows) estimate for the (P,P) grid plan of the U update.

    rows per block ~ items-with-ratings-in-block + chunk splits; we provision
    the max block at 3x the mean (power-law skew headroom; the host planner
    reports the true max at run time).
    """
    m_loc = -(-m // p)
    n_loc = -(-n // p)
    mean_rows = max(1.0, nnz / (p * p) / 1.0)  # ~1 row per (item, block) touch
    rows = int(np.ceil(3.0 * mean_rows)) + 4
    return m_loc, n_loc, rows


def model_flops(m: int, n: int, nnz: int, k: int) -> float:
    """The JAX dry-run's analytic useful flops of a sweep: 2 nnz K^2 (the
    outer products) + (M + N)(2/3 K^3 + 4 K^2) (Cholesky and solves)."""
    return 2.0 * nnz * k * k + (m + n) * (2 / 3 * k**3 + 4 * k * k)


# ---------------------------------------------------------------------------
# Plans on the meta device
# ---------------------------------------------------------------------------
def _empty(*shape: int, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def meta_plan(rows: int, width: int, segments: list[int], n_loc: int, *,
              ordered: bool = True) -> BlockPlan:
    """A BlockPlan of `rows` rows of `width` on the meta device whose
    counterpart blocks have `segments[q]` real segments each (the fused
    engine's targets) and as many slots with rows (the einsum engine's);
    `ordered` False gives it the seg_order of a flattened plan."""
    targets, first = [], 0
    for d in segments:
        targets.append((first, _empty(d, dtype=torch.int64)))
        first += d
    n_slots = min(n_loc, first)
    i32, i64 = torch.int32, torch.int64
    return BlockPlan(
        indices=_empty(rows, width, dtype=i32), values=_empty(rows, width),
        mask=_empty(rows, width), seg=_empty(rows, dtype=i64),
        seg_dense=_empty(rows, dtype=i32), seg_ptr=_empty(first + 1, dtype=i32),
        n_segments=first, targets=tuple(targets),
        seg_order=None if ordered else _empty(rows, dtype=i64),
        slots=_empty(n_slots, dtype=i64), slot_off=_empty(n_slots + 2, dtype=i32))


def meta_like(plan: BlockPlan) -> BlockPlan:
    """A plan's twin on the meta device: the same shapes, no data."""
    def twin(t):
        return None if t is None else torch.empty(t.shape, dtype=t.dtype, device=META)

    return plan._replace(**{f: twin(getattr(plan, f)) for f in (
        "indices", "values", "mask", "seg", "seg_dense", "seg_ptr", "seg_order", "slots",
        "slot_off")}, targets=tuple((first, twin(s)) for first, s in plan.targets))


def _side(n_loc: int, plans: tuple) -> _Side:
    p = len(plans)
    return _Side(n_loc=n_loc, ids=tuple(_empty(n_loc, dtype=torch.int64) for _ in range(p)),
                 valid=tuple(_empty(n_loc, dtype=torch.bool) for _ in range(p)), plans=plans)


def estimated_sides(m: int, n: int, nnz: int, p: int, width: int, mode: str
                    ) -> tuple[_Side, _Side, dict]:
    """Both sides' plans on the meta device at `plan_shape`'s estimate: a
    block of R rows holds min(R, n_loc) items (every row a segment until
    the shard's items run out). Ring and async: [p][q] blocks; all-gather:
    one flattened plan a shard, P R rows."""
    m_loc, n_loc, ru = plan_shape(m, n, nnz, p, width)
    _, _, rv = plan_shape(n, m, nnz, p, width)

    def plans(loc: int, rows: int):
        seg = min(rows, loc)
        if mode == "allgather":
            return tuple(meta_plan(p * rows, width, [seg] * p, loc, ordered=False)
                         for _ in range(p))
        return tuple(tuple(meta_plan(rows, width, [seg], loc) for _ in range(p))
                     for _ in range(p))

    shapes = {"width": width, "rows_u": ru, "rows_v": rv, "m_loc": m_loc, "n_loc": n_loc}
    return _side(m_loc, plans(m_loc, ru)), _side(n_loc, plans(n_loc, rv)), shapes


def sides_of(sampler: DistributedBPMF) -> tuple[_Side, _Side]:
    """A real sampler's sides on the meta device, at their exact shapes."""
    def twin(side: _Side) -> _Side:
        plans = tuple(meta_like(row) if isinstance(row, BlockPlan)
                      else tuple(meta_like(b) for b in row) for row in side.plans)
        return _side(side.n_loc, plans)

    return twin(sampler._u), twin(sampler._v)


def meta_state(sampler: DistributedBPMF) -> DistState:
    """A sweep's input state on the sampler's (meta) devices."""
    k = sampler.k
    u = tuple(_empty(sampler._u.n_loc, k) for _ in range(sampler.n_shards))
    v = tuple(_empty(sampler._v.n_loc, k) for _ in range(sampler.n_shards))
    return DistState(u=u, v=v, hyper_u=init_hyper(k, device=META),
                     hyper_v=init_hyper(k, device=META), step=0,
                     v_eval=v if sampler.mode == "async" else None)


def count_sweep(sampler: DistributedBPMF) -> CostCounter:
    """One sweep of a sampler on the meta device under a CostCounter, its
    state, plans and ids live from the start."""
    state = meta_state(sampler)
    args = tensors_of(list(state)) + tensors_of(_side_tensors(sampler._u)) \
        + tensors_of(_side_tensors(sampler._v))
    with CostCounter(args) as counter:
        sampler.sweep(state)
    return counter


def _side_tensors(side: _Side) -> list:
    plans = [b for row in side.plans for b in ((row,) if isinstance(row, BlockPlan) else row)]
    out = list(side.ids) + list(side.valid)
    for b in {id(b): b for b in plans}.values():
        out += [t for t in (b.indices, b.values, b.mask, b.seg, b.seg_dense, b.seg_ptr,
                            b.seg_order, b.slots, b.slot_off) if t is not None]
        out += [s for _, s in b.targets]
    return out


def sweep_record(m: int, n: int, nnz: int, k: int, p: int, counter: CostCounter) -> dict:
    """The counter's totals of one sweep over P shards on one card, in
    total and per shard (a shard a chip, the JAX dry-run's layout), with
    the rooflines of both."""
    sm = counter.summary()
    mf = model_flops(m, n, nnz, k)

    def roof(scale: int, devices: int) -> dict:
        return roofline_terms(
            flops=sm["flops"] / scale, hbm_bytes=sm["hbm_bytes"] / scale,
            collective_bytes_per_device=sm["exchange_bytes"] / scale, n_devices=devices,
            peak_flops=BF16_TENSOR_FLOPS, hbm_bw=HBM_BYTES_PER_S, ici_bw=NVLINK_BYTES_PER_S)

    return dict(
        memory=dict(argument_bytes=sm["argument_bytes"], peak_bytes=sm["peak_bytes"],
                    peak_at=sm["peak_at"]),
        fits_one_card=sm["peak_bytes"] <= HBM_BYTES,
        flops=sm["flops"], fp32_flops=sm["fp32_flops"], hbm_bytes=sm["hbm_bytes"],
        exchange_bytes=sm["exchange_bytes"], ops=sm["ops"],
        per_shard_flops=sm["flops"] / p, per_shard_hbm_bytes=sm["hbm_bytes"] / p,
        per_shard_exchange_bytes=sm["exchange_bytes"] / p,
        model_flops=mf, useful_flops_ratio=mf / max(sm["flops"], 1.0),
        roofline=roof(1, 1), roofline_per_shard=roof(p, p),
        compute_s_by_pipe=compute_s_by_pipe(sm["tensor_flops"], sm["fp32_flops"]),
        top_flops=counter.top("flops"), top_bytes=counter.top("bytes"))


def run_cell(dataset: str, mode: str, shards: int = 4, k: int = 64, width: int = 32, *,
             engine: str = "einsum", dims: tuple[int, int, int] | None = None,
             save: bool = True) -> dict:
    """One sweep at the dataset's full scale (`dims` (M, N, nnz) in place of
    DATASETS[dataset] where given) on the meta device: the record (ok, or
    the error and its traceback)."""
    m, n, nnz = dims or DATASETS[dataset]
    p = shards
    rec: dict = {"arch": f"bpmf-{dataset}-{mode}", "shape": f"K{k}_sweep", "kind": "bpmf",
                 "engine": engine, "device": "h100 (meta)", "n_shards": p, "ok": False}
    t0 = time.perf_counter()
    try:
        u_side, v_side, shapes = estimated_sides(m, n, nnz, p, width, mode)
        sampler = DistributedBPMF.from_sides(m, n, u_side, v_side, k=k, alpha=1.5,
                                             mode=mode, engine=engine)
        rec.update(ok=True, plan=shapes,
                   **sweep_record(m, n, nnz, k, p, count_sweep(sampler)))
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = time.perf_counter() - t0
    if save:
        _save(rec, dataset, mode, k, p, engine)
    return rec


def _save(rec: dict, dataset: str, mode: str, k: int, p: int, engine: str,
          run: bool = False) -> None:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    tag = ("" if engine == "einsum" else f"__{engine}") + ("__run" if run else "")
    (ART_DIR / f"bpmf-{dataset}-{mode}__K{k}__P{p}{tag}.json").write_text(
        json.dumps(rec, indent=2, default=str))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def real_sampler(dataset: str, mode: str, shards: int, k: int, engine: str, *,
                 seed: int = 0) -> tuple[DistributedBPMF, dict]:
    """The dataset at full scale (`movielens_like(1.0)` or `chembl_like(1.0)`)
    and a DistributedBPMF over `shards` shards on the card (width "auto"),
    with the host's seconds for each and the plans' widths and rows."""
    from repro_torch.core.distributed import shard_devices
    from repro_torch.data.datasets import chembl_like, movielens_like

    t0 = time.perf_counter()
    ratings, _, _ = (movielens_like if dataset == "ml20m" else chembl_like)(1.0, seed=seed)
    t1 = time.perf_counter()
    sampler = DistributedBPMF(ratings, None, devices=shard_devices(shards), k=k, alpha=1.5,
                              width="auto", mode=mode, engine=engine)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    info = dict(m=ratings.shape[0], n=ratings.shape[1], nnz=ratings.nnz, data_s=t1 - t0,
                plan_s=t2 - t1, width_u=sampler.u_plan.width, width_v=sampler.v_plan.width,
                rows_u=int(sampler.u_plan.indices.shape[2]),
                rows_v=int(sampler.v_plan.indices.shape[2]))
    return sampler, info


def measure(dataset: str = "ml20m", mode: str = "ring", shards: int = 4, k: int = 64,
            engine: str = "fused", *, sampler: DistributedBPMF | None = None,
            info: dict | None = None) -> dict:
    """`--run`: one sweep on the card beside its count on the meta device
    at the real plans' exact shapes. The real sweep runs once to warm up,
    once timed on the host clock (with the kernels' launches and the peak
    of device memory) and once profiled (`launch/profile.py`). Needs a
    card."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile import profile_call

    if not torch.cuda.is_available():
        raise RuntimeError("bpmf_dryrun.measure runs the sweep on a CUDA card; none is here")
    if sampler is None:
        sampler, info = real_sampler(dataset, mode, shards, k, engine)
    m, n = sampler.m, sampler.n
    t0 = time.perf_counter()
    u_side, v_side = sides_of(sampler)
    twin = DistributedBPMF.from_sides(m, n, u_side, v_side, k=k, alpha=sampler.alpha,
                                      mode=mode, engine=engine)
    counter = count_sweep(twin)
    meta_s = time.perf_counter() - t0
    rec = dict(info or {}, **sweep_record(m, n, info["nnz"], k, sampler.n_shards, counter),
               meta_s=meta_s)
    state = sampler.init(0)
    state = sampler.sweep(state)                     # warm-up
    torch.cuda.synchronize()
    args = tensors_of(list(state)) + tensors_of(_side_tensors(sampler._u)) \
        + tensors_of(_side_tensors(sampler._v))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.perf_counter()
    nxt = sampler.sweep(state)
    torch.cuda.synchronize()
    rec["sweep_s"] = time.perf_counter() - t1
    rec["launches"] = {key: v for key, v in ops.launches().items() if v}
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    # the arguments plus what the sweep allocated: the counter's peak's terms
    rec["measured_peak_bytes"] = (rec["max_memory_allocated"] - base
                                  + storage_bytes(args))
    del nxt
    prof = profile_call(lambda: sampler.sweep(state))
    rec.update(busy_ms=prof.busy_ms, kernels=prof.kernels)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="both", choices=["chembl", "ml20m", "both"])
    ap.add_argument("--mode", default="both", choices=["ring", "allgather", "both"])
    ap.add_argument("--shards", type=int, default=4,
                    help="P shards (4: the one-card layout; 256 and 512: the JAX meshes)")
    ap.add_argument("--engine", default="einsum", choices=["einsum", "fused"])
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--run", action="store_true",
                    help="make the data and plans and run the sweep on the card")
    args = ap.parse_args(argv)
    datasets = ["chembl", "ml20m"] if args.dataset == "both" else [args.dataset]
    modes = ["ring", "allgather"] if args.mode == "both" else [args.mode]
    fails = 0
    for d in datasets:
        for mo in modes:
            if args.run:
                rec = measure(d, mo, args.shards, args.k, args.engine)
                _save(rec, d, mo, args.k, args.shards, args.engine, run=True)
                r = rec["roofline"]
                print(f"[bpmf-dryrun] {d} {mo} P={args.shards} {args.engine} on the card: "
                      f"sweep {rec['sweep_s']:.4f} s, {rec['busy_ms']:.1f} ms busy; modelled "
                      f"compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
                      f"ms; peak {rec['measured_peak_bytes'] / 1e9:.2f} GB measured, "
                      f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB modelled")
                continue
            rec = run_cell(d, mo, args.shards, args.k, engine=args.engine)
            fails += 0 if rec["ok"] else 1
            if rec["ok"]:
                r, rs = rec["roofline"], rec["roofline_per_shard"]
                print(f"[bpmf-dryrun] {d} {mo} P={args.shards} {args.engine}: ok "
                      f"({rec['total_s']:.1f} s); {rec['flops'] / 1e12:.2f} TFLOP, "
                      f"{rec['hbm_bytes'] / 1e9:.1f} GB, exchange "
                      f"{rec['exchange_bytes'] / 1e9:.2f} GB in total; a shard "
                      f"{rs['dominant']} {rs['step_lower_bound_s'] * 1e3:.3f} ms; one card "
                      f"{r['dominant']} {r['step_lower_bound_s'] * 1e3:.3f} ms; peak "
                      f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB; useful "
                      f"{rec['useful_flops_ratio']:.3f}")
            else:
                print(f"[bpmf-dryrun] {d} {mo} P={args.shards}: FAIL {rec['error'][:160]}")
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
