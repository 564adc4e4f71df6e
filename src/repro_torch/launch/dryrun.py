"""Dry-run of the port: every (architecture x input shape) cell on the meta
device under the op-level cost counter, the counterpart of
`repro/launch/dryrun.py`.

The JAX dry-run lowers and compiles each cell for a 256- or 512-chip mesh
and walks the HLO. Here each cell's step runs on `torch.device("meta")`
(shapes and dtypes, no data, nothing allocated) under
`launch/cost.py::CostCounter`, which proves the config holds together (a
shape mismatch or a data-dependent shape fails loudly) and gives the
step's flops, HBM bytes and peak of live bytes, whether it fits a card
(80 GB), and the roofline at one H100 (`launch/mesh.py`):

  - on one card (no --mesh);
  - with --mesh single|multi|both, on the JAX package's production meshes
    of H100s, (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
    "model"), in a fake world of 256 or 512 ranks (`mesh.fake_world`): the
    state, parameters, cache and inputs are DTensors placed by the JAX
    sharding rules (`models/api.py`), and the counter counts the last
    rank's work (the busiest under causal sequence sharding) and its
    collectives by kind. The record's link term is the collective bytes
    over NVLINK_BYTES_PER_S: a lower bound, since a 16-wide "model" axis
    spans two 8-card hosts.

    python -m repro_torch.launch.dryrun --list                  # the cells
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --jobs 6                # every cell
    python -m repro_torch.launch.dryrun --mesh both --jobs 6    # every cell, both meshes

Records go to artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__opt].json,
<mesh> h100 (one card), single or multi.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch.configs import REGISTRY, apply_variant, get_config
from repro_torch.kernels import ops
from repro_torch.launch.cost import CostCounter, Steps, compute_s_by_pipe, roofline_terms
from repro_torch.launch.mesh import BF16_TENSOR_FLOPS, HBM_BYTES, HBM_BYTES_PER_S, \
    MULTI_POD_MESH, NVLINK_BYTES_PER_S, POD_MESH, fake_world, make_production_mesh
from repro_torch.launch.train import (
    adamw_config,
    make_train_step,
    shard_batch,
    shard_module,
    shard_state,
    shardings_of,
    train_state_shapes,
)
from repro_torch.models.api import (
    ShapeSpec,
    build_model,
    count_params,
    input_pspecs,
    input_specs,
    model_flops_per_step,
    param_pspecs,
    shape_by_name,
    supported_shapes,
    tokens_per_step,
)
from repro_torch.models.layers import DTensor, active_mesh

#: --mesh's names: the JAX package's record names of its two meshes
MESHES = {"single": POD_MESH, "multi": MULTI_POD_MESH}

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")


def tensors_of(obj: Any) -> list[torch.Tensor]:
    """The tensors of a module, state, dict, tuple or list, in order (a
    DTensor's: this rank's local shard)."""
    if isinstance(obj, DTensor):
        return [obj.to_local()]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return [t for p in obj.parameters() for t in tensors_of(p)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def lower_cell(cfg, shape: ShapeSpec, mesh=None) -> tuple[CostCounter, int]:
    """Run one cell's step on the meta device (no data) under a CostCounter:
    a train cell's `make_train_step` on the train state
    (`train_state_shapes`), a prefill cell's `prefill_fn`, a decode cell's
    `decode_fn` of one token against a cache of `seq_len` positions, and a
    "forward" cell's `loss_fn` without grad (the cache-free forward that
    runs the flash kernel, `chip_smoke.py`'s measured cell). The inputs are
    `input_specs(cfg, shape)` (a forward's a train cell's); the state,
    parameters, cache and inputs are live from the start. With `mesh` (a
    DeviceMesh of a fake world) they are DTensors placed by the sharding
    rules, the step runs under `active_mesh(mesh)`, and the counter counts
    this rank's work. Returns the counter and the bytes of the step's
    outputs (this rank's)."""
    if mesh is not None:
        with active_mesh(mesh):
            return _lower_cell(cfg, shape, mesh)
    return _lower_cell(cfg, shape, None)


def _lower_cell(cfg, shape: ShapeSpec, mesh) -> tuple[CostCounter, int]:
    model = build_model(cfg, device=META)
    kind = shape.kind
    as_train = shape if kind != "forward" else \
        ShapeSpec(shape.name, shape.seq_len, shape.global_batch, "train")
    batch = input_specs(cfg, as_train)
    if mesh is not None:
        batch = shard_batch(batch, input_pspecs(cfg, as_train, mesh), mesh)
    if kind == "train":
        opt_cfg = adamw_config(cfg)
        state = train_state_shapes(cfg, opt_cfg)
        if mesh is not None:
            state = shard_state(cfg, state, mesh)
        step = make_train_step(cfg, opt_cfg, device=META)
        with CostCounter(tensors_of(state) + tensors_of(batch)) as counter:
            out = step(state, batch)
        return counter, storage_bytes(tensors_of(out))
    params = model.init()
    if mesh is not None:
        shard_module(params, shardings_of(param_pspecs(cfg, params, mesh), mesh), mesh)
    if kind in ("prefill", "forward"):
        with CostCounter(tensors_of(params) + tensors_of(batch)) as counter:
            if kind == "prefill":
                out = model.prefill_fn(params, batch)
            else:
                with torch.no_grad():
                    out = model.loss_fn(params, batch)
        return counter, storage_bytes(tensors_of(out))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    with CostCounter(tensors_of(params) + tensors_of(cache) + tensors_of(batch)) as counter:
        out = model.decode_fn(params, cache, batch)
    return counter, storage_bytes(tensors_of(out))


def cut_and_full(cfg, shape: ShapeSpec) -> tuple[dict, dict]:
    """A cell's counter summary with its `steps` loops cut (the dry-run's
    way) and run whole: equal where the cut is right on this torch."""
    cut = lower_cell(cfg, shape)[0]
    iterate = Steps.__iter__
    Steps.__iter__ = lambda self: iter(range(self.n))
    try:
        full = lower_cell(cfg, shape)[0]
    finally:
        Steps.__iter__ = iterate
    keys = ("flops", "hbm_bytes", "ops", "peak_bytes")
    return ({k: cut.summary()[k] for k in keys} | {"repeated_ops": cut.repeated_ops},
            {k: full.summary()[k] for k in keys} | {"repeated_ops": full.repeated_ops})


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages of some tensors."""
    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}
    return sum(seen.values())


def cell_record(cfg, shape: ShapeSpec, counter: CostCounter, output_bytes: int,
                n_devices: int = 1) -> dict:
    """The counter's totals as a dry-run record's fields, with the roofline
    at one H100 (the tensor cores' bf16 peak, as the JAX record's at its
    chip's bf16 peak; `compute_s_by_pipe` puts the fp32 products on the
    fp32 pipes). On a mesh of `n_devices` the counts are one device's, the
    collectives by kind are added, the link term reads their bytes, and
    useful_flops_ratio is model_flops / (flops n_devices), as the JAX
    record's."""
    total, active = count_params(cfg)
    sm = counter.summary()
    model_flops = model_flops_per_step(cfg, shape)
    coll = counter.collectives()
    link_bytes = sm["exchange_bytes"] if n_devices == 1 else sum(coll["bytes"].values())
    terms = roofline_terms(
        flops=sm["flops"], hbm_bytes=sm["hbm_bytes"],
        collective_bytes_per_device=link_bytes, n_devices=n_devices,
        peak_flops=BF16_TENSOR_FLOPS, hbm_bw=HBM_BYTES_PER_S, ici_bw=NVLINK_BYTES_PER_S)
    mesh_fields = {} if n_devices == 1 else dict(
        per_device_flops=sm["flops"], per_device_hbm_bytes=sm["hbm_bytes"],
        collective_bytes=coll["bytes"], collective_counts=coll["counts"],
        collective_total_bytes=link_bytes, wire_bytes=coll["wire_bytes"],
        wire_total_bytes=sum(coll["wire_bytes"].values()))
    return dict(mesh_fields, **dict(
        params_total=total,
        params_active=active,
        memory=dict(argument_bytes=sm["argument_bytes"],
                    read_argument_bytes=sm["read_argument_bytes"],
                    output_bytes=output_bytes,
                    peak_bytes=sm["peak_bytes"],
                    peak_at=sm["peak_at"]),
        fits_one_card=sm["peak_bytes"] <= HBM_BYTES,
        flops=sm["flops"],
        tensor_flops=sm["tensor_flops"],
        fp32_flops=sm["fp32_flops"],
        hbm_bytes=sm["hbm_bytes"],
        exchange_bytes=sm["exchange_bytes"],
        ops=sm["ops"],
        repeated_ops=counter.repeated_ops,
        model_flops=model_flops,
        useful_flops_ratio=model_flops / (sm["flops"] * n_devices) if sm["flops"] else 0.0,
        tokens_per_step=tokens_per_step(shape),
        roofline=terms,
        compute_s_by_pipe=compute_s_by_pipe(sm["tensor_flops"], sm["fp32_flops"]),
        top_flops=counter.top("flops"),
        top_bytes=counter.top("bytes"),
    ))


def run_cell(arch: str, shape_name: str, variant: str = "base", *, save: bool = True,
             mesh: str | None = None) -> dict:
    """One cell on the meta device, on one card or on the production mesh
    `mesh` ("single" or "multi", in a fake world of its ranks): the record
    (ok, or the error and its traceback), written to ART_DIR unless
    `save` is False."""
    cfg = apply_variant(get_config(arch), variant)
    shape = shape_by_name(shape_name)
    n = 1 if mesh is None else math.prod(MESHES[mesh][0])
    rec: dict = {"arch": arch, "shape": shape_name, "kind": shape.kind, "variant": variant,
                 "device": "h100 (meta)", "n_devices": n, "ok": False}
    if mesh is not None:
        rec["mesh"] = "x".join(map(str, MESHES[mesh][0]))
    t0 = time.perf_counter()
    before = ops.launches()
    try:
        if mesh is None:
            rec.update(ok=True, **cell_record(cfg, shape, *lower_cell(cfg, shape)))
        else:
            # DTensor warns at every redistribution over several axes at once
            logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
            with fake_world(n):
                dm = make_production_mesh(multi_pod=mesh == "multi", device=META)
                rec.update(ok=True, **cell_record(cfg, shape, *lower_cell(cfg, shape, dm),
                                                  n_devices=n))
                rec["fits"] = rec.pop("fits_one_card")     # a device of the mesh
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["launches"] = {k: v - before[k] for k, v in ops.launches().items() if v != before[k]}
    rec["total_s"] = time.perf_counter() - t0
    if save:
        # a mesh record is committed: it keeps no host time, so that a rerun
        # rewrites it only where what it models changed
        saved = rec if mesh is None else {k: v for k, v in rec.items() if k != "total_s"}
        ART_DIR.mkdir(parents=True, exist_ok=True)
        artifact(arch, shape_name, variant, mesh).write_text(json.dumps(saved, indent=2))
    return rec


def artifact(arch: str, shape_name: str, variant: str = "base", mesh: str | None = None
             ) -> Path:
    suffix = "" if variant == "base" else f"__{variant}"
    return ART_DIR / f"{arch}__{shape_name}__{mesh or 'h100'}{suffix}.json"


def all_cells() -> list[tuple[str, str]]:
    """REGISTRY x supported_shapes, the JAX package's cell list."""
    return [(arch, s.name) for arch, cfg in REGISTRY.items() for s in supported_shapes(cfg)]


def _run_in_worker(arch: str, shape_name: str, variant: str, save: bool,
                   mesh: str | None = None) -> dict:
    torch.set_num_threads(1)
    return run_cell(arch, shape_name, variant, save=save, mesh=mesh)


def sweep(cells: Iterable[tuple[str, str]], variant: str = "base", *, jobs: int = 1,
          save: bool = True, meanwhile: Callable[[], Any] | None = None,
          mesh: str | None = None) -> tuple[list[dict], Any]:
    """run_cell over the cells (on `mesh` where given), in `jobs` processes
    (spawned) when more than one, the longest first; `meanwhile()` runs in
    this process while they do. Returns the records in the cells' order
    and what meanwhile returned."""
    cells = list(cells)
    if jobs <= 1:
        recs = [run_cell(a, s, variant, save=save, mesh=mesh) for a, s in cells]
        return recs, meanwhile() if meanwhile is not None else None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(range(len(cells)), key=lambda i: _weight(*cells[i]), reverse=True)
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {i: pool.submit(_run_in_worker, *cells[i], variant, save, mesh)
                   for i in order}
        other = meanwhile() if meanwhile is not None else None
        return [futures[i].result() for i in range(len(cells))], other


def _weight(arch: str, shape_name: str) -> int:
    """A rough order of the cells' host time: the train cells of the
    largest configs and the recurrent families first."""
    cfg = REGISTRY[arch]
    kind = shape_by_name(shape_name).kind
    return (cfg.n_layers * (3 if kind == "train" else 1)
            + (100 if cfg.family in ("ssm", "hybrid", "moe") else 0))


def summary_line(rec: dict) -> str:
    """One cell on one line: params, peak GB, fits one card, TFLOP, GB
    moved, and the roofline's dominant term and lower bound."""
    head = f"{rec['arch']:22s} {rec['shape']:12s}"
    if "mesh" in rec:
        head += f" {rec['mesh']:8s}"
    if not rec["ok"]:
        return f"{head} FAIL {rec.get('error', '')[:160]}"
    r = rec["roofline"]
    if "mesh" in rec:
        return (f"{head} ok  per device: peak {rec['memory']['peak_bytes'] / 1e9:9.2f} GB  "
                f"fits {str(rec['fits']):5s}  {rec['flops'] / 1e12:10.2f} TFLOP  "
                f"{rec['collective_total_bytes'] / 1e9:9.2f} GB collective  "
                f"{r['dominant']} {r['step_lower_bound_s']:.4g} s  ({rec['total_s']:.1f} s host)")
    return (f"{head} ok  params {rec['params_total'] / 1e9:8.3f} B  peak "
            f"{rec['memory']['peak_bytes'] / 1e9:10.2f} GB  fits {str(rec['fits_one_card']):5s}  "
            f"{rec['flops'] / 1e12:12.2f} TFLOP  {rec['hbm_bytes'] / 1e9:12.1f} GB moved  "
            f"{r['dominant']} {r['step_lower_bound_s']:.4g} s  ({rec['total_s']:.1f} s host, "
            f"{rec['ops']:,} ops, {rec['repeated_ops']:,} repeats)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes to run the cells in")
    ap.add_argument("--mesh", default=None, choices=["single", "multi", "both"],
                    help="the production mesh(es) of H100s, in a fake world on the "
                         "meta device (default: one card)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            print(arch, shape)
        return
    cells = [c for c in all_cells() if args.arch in ("all", c[0])
             and args.shape in ("all", c[1])]
    meshes: list = [None] if args.mesh is None else \
        (["single", "multi"] if args.mesh == "both" else [args.mesh])
    t0 = time.perf_counter()
    recs = []
    for mesh in meshes:
        todo = cells
        if args.skip_done:
            def done(cell) -> bool:
                out = artifact(*cell, args.variant, mesh)
                return out.exists() and json.loads(out.read_text()).get("ok", False)

            for cell in [c for c in todo if done(c)]:
                print(f"[dryrun] skip {cell[0]} {cell[1]} {mesh or ''} (done)")
            todo = [c for c in todo if not done(c)]
        recs += sweep(todo, args.variant, jobs=args.jobs, mesh=mesh)[0]
    for rec in recs:
        print(summary_line(rec))
    n_fail = sum(not r["ok"] for r in recs)
    print(f"[dryrun] {len(recs)} cells in {time.perf_counter() - t0:.1f} s, "
          f"{n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
