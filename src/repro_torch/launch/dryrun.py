"""Dry-run of the port: every (architecture x input shape) cell on the meta
device under the op-level cost counter, the counterpart of
`repro/launch/dryrun.py`.

The JAX dry-run lowers and compiles each cell for a 256- or 512-chip mesh
and walks the HLO. The port's target is one H100: each cell's step runs on
`torch.device("meta")` (shapes and dtypes, no data, nothing allocated)
under `launch/cost.py::CostCounter`, which proves the config holds
together (a shape mismatch or a data-dependent shape fails loudly) and
gives the step's flops, HBM bytes and peak of live bytes, whether it fits
one card (80 GB), and the roofline at one H100 (`launch/mesh.py`).

    python -m repro_torch.launch.dryrun --list                  # the cells
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --jobs 6                # every cell

Records go to artifacts/dryrun_torch/<arch>__<shape>__h100[__opt].json.
There is no --mesh: the card is one H100 (several cards: ROADMAP.md,
queue 1 item 7).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch.configs import REGISTRY, apply_variant, get_config
from repro_torch.kernels import ops
from repro_torch.launch.cost import CostCounter, Steps, compute_s_by_pipe, roofline_terms
from repro_torch.launch.mesh import BF16_TENSOR_FLOPS, HBM_BYTES, HBM_BYTES_PER_S, \
    NVLINK_BYTES_PER_S
from repro_torch.launch.train import adamw_config, make_train_step, train_state_shapes
from repro_torch.models.api import (
    ShapeSpec,
    build_model,
    count_params,
    input_specs,
    model_flops_per_step,
    shape_by_name,
    supported_shapes,
    tokens_per_step,
)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")


def tensors_of(obj: Any) -> list[torch.Tensor]:
    """The tensors of a module, state, dict, tuple or list, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def lower_cell(cfg, shape: ShapeSpec) -> tuple[CostCounter, int]:
    """Run one cell's step on the meta device (no data) under a CostCounter:
    a train cell's `make_train_step` on the train state
    (`train_state_shapes`), a prefill cell's `prefill_fn`, a decode cell's
    `decode_fn` of one token against a cache of `seq_len` positions, and a
    "forward" cell's `loss_fn` without grad (the cache-free forward that
    runs the flash kernel, `chip_smoke.py`'s measured cell). The inputs are
    `input_specs(cfg, shape)` (a forward's a train cell's); the state,
    parameters, cache and inputs are live from the start. Returns the
    counter and the bytes of the step's outputs."""
    model = build_model(cfg, device=META)
    kind = shape.kind
    batch = input_specs(cfg, shape if kind != "forward" else
                        ShapeSpec(shape.name, shape.seq_len, shape.global_batch, "train"))
    if kind == "train":
        opt_cfg = adamw_config(cfg)
        state = train_state_shapes(cfg, opt_cfg)
        step = make_train_step(cfg, opt_cfg, device=META)
        with CostCounter(tensors_of(state) + tensors_of(batch)) as counter:
            out = step(state, batch)
        return counter, storage_bytes(tensors_of(out))
    params = model.init()
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


def cell_record(cfg, shape: ShapeSpec, counter: CostCounter, output_bytes: int) -> dict:
    """The counter's totals as a dry-run record's fields, with the roofline
    at one H100 (the tensor cores' bf16 peak, as the JAX record's at its
    chip's bf16 peak; `compute_s_by_pipe` puts the fp32 products on the
    fp32 pipes)."""
    total, active = count_params(cfg)
    sm = counter.summary()
    model_flops = model_flops_per_step(cfg, shape)
    terms = roofline_terms(
        flops=sm["flops"], hbm_bytes=sm["hbm_bytes"],
        collective_bytes_per_device=sm["exchange_bytes"], n_devices=1,
        peak_flops=BF16_TENSOR_FLOPS, hbm_bw=HBM_BYTES_PER_S, ici_bw=NVLINK_BYTES_PER_S)
    return dict(
        params_total=total,
        params_active=active,
        memory=dict(argument_bytes=sm["argument_bytes"],
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
        useful_flops_ratio=model_flops / sm["flops"] if sm["flops"] else 0.0,
        tokens_per_step=tokens_per_step(shape),
        roofline=terms,
        compute_s_by_pipe=compute_s_by_pipe(sm["tensor_flops"], sm["fp32_flops"]),
        top_flops=counter.top("flops"),
        top_bytes=counter.top("bytes"),
    )


def run_cell(arch: str, shape_name: str, variant: str = "base", *, save: bool = True
             ) -> dict:
    """One cell on the meta device: the record (ok, or the error and its
    traceback), written to ART_DIR unless `save` is False."""
    cfg = apply_variant(get_config(arch), variant)
    shape = shape_by_name(shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "kind": shape.kind, "variant": variant,
                 "device": "h100 (meta)", "n_devices": 1, "ok": False}
    t0 = time.perf_counter()
    before = ops.launches()
    try:
        rec.update(ok=True, **cell_record(cfg, shape, *lower_cell(cfg, shape)))
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["launches"] = {k: v - before[k] for k, v in ops.launches().items() if v != before[k]}
    rec["total_s"] = time.perf_counter() - t0
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        artifact(arch, shape_name, variant).write_text(json.dumps(rec, indent=2))
    return rec


def artifact(arch: str, shape_name: str, variant: str = "base") -> Path:
    suffix = "" if variant == "base" else f"__{variant}"
    return ART_DIR / f"{arch}__{shape_name}__h100{suffix}.json"


def all_cells() -> list[tuple[str, str]]:
    """REGISTRY x supported_shapes, the JAX package's cell list."""
    return [(arch, s.name) for arch, cfg in REGISTRY.items() for s in supported_shapes(cfg)]


def _run_in_worker(arch: str, shape_name: str, variant: str, save: bool) -> dict:
    torch.set_num_threads(1)
    return run_cell(arch, shape_name, variant, save=save)


def sweep(cells: Iterable[tuple[str, str]], variant: str = "base", *, jobs: int = 1,
          save: bool = True, meanwhile: Callable[[], Any] | None = None
          ) -> tuple[list[dict], Any]:
    """run_cell over the cells, in `jobs` processes (spawned) when more than
    one, the longest first; `meanwhile()` runs in this process while they
    do. Returns the records in the cells' order and what meanwhile
    returned."""
    cells = list(cells)
    if jobs <= 1:
        recs = [run_cell(a, s, variant, save=save) for a, s in cells]
        return recs, meanwhile() if meanwhile is not None else None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(range(len(cells)), key=lambda i: _weight(*cells[i]), reverse=True)
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {i: pool.submit(_run_in_worker, *cells[i], variant, save) for i in order}
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
    if not rec["ok"]:
        return f"{head} FAIL {rec.get('error', '')[:160]}"
    r = rec["roofline"]
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
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            print(arch, shape)
        return
    cells = [c for c in all_cells() if args.arch in ("all", c[0])
             and args.shape in ("all", c[1])]
    if args.skip_done:
        def done(cell) -> bool:
            out = artifact(*cell, args.variant)
            return out.exists() and json.loads(out.read_text()).get("ok", False)

        for cell in [c for c in cells if done(c)]:
            print(f"[dryrun] skip {cell[0]} {cell[1]} (done)")
        cells = [c for c in cells if not done(c)]
    t0 = time.perf_counter()
    recs, _ = sweep(cells, args.variant, jobs=args.jobs)
    for rec in recs:
        print(summary_line(rec))
    n_fail = sum(not r["ok"] for r in recs)
    print(f"[dryrun] {len(recs)} cells in {time.perf_counter() - t0:.1f} s, "
          f"{n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
