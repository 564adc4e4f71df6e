"""Training launcher of the port, BPMF mode (`repro/launch/train.py`'s
`--bpmf`): train on a synthetic MovieLens-shaped matrix and retain the
post-burn-in draws in a SampleStore, or, with --co-serve, train while
serving them live through launch/serve.py::run_train_and_serve:

    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --sweeps 40
    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --co-serve

or, with --mode ring|allgather|async, train the distributed sampler over
--shards item shards (one a visible card by default; several may share a
card, as they do on one):

    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --mode async --shards 4

Started by `torchrun` (WORLD_SIZE set), a distributed mode runs one shard a
rank instead, over a 1-D "items" mesh of the launch's ranks (NCCL on the
card, gloo with --device cpu), the ranks exchanging messages:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --bpmf --mode ring --device cpu

`--engine sgld` trains the minibatch SGLD sampler instead of Gibbs, single
device or with --mode/--shards (--sweeps then counts SGLD steps, each
costing about --minibatch padded rating lanes a half-step):

    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --engine sgld --sweeps 400

Runs on the card ("--device cpu" for the plain path). LM training stays a
library, as in the reference: `init_train_state` and `make_train_step`
below, driven by `runtime.Trainer` (examples/train_lm_torch.py);
`train_state_shapes` builds the state on the meta device for the dry-run.
On a device mesh the state's parameters and moments are DTensors placed by
`models/api.py::train_state_pspecs` (`shardings_of`, `shard_state`) and
the step runs under `models.layers.active_mesh(mesh)`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, NamedTuple

import torch

from repro_torch.core.gibbs import ENGINES
from torch import nn

from repro_torch.models import build_model
from repro_torch.models.api import placements, train_state_pspecs
from repro_torch.models.layers import ModelConfig, active_mesh, get_active_mesh
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_schedule


# ---------------------------------------------------------------------------
# LM training step (the reference's make_train_step)
# ---------------------------------------------------------------------------
class TrainState(NamedTuple):
    params: nn.Module                # the family's parameter module (Decoder, XLSTM, ...)
    opt: AdamWState
    step: torch.Tensor               # 0-d int32, on the CPU


def init_train_state(cfg: ModelConfig, seed: int, opt_cfg: AdamWConfig, *,
                     device: str | torch.device = "cuda") -> TrainState:
    """Parameters drawn from `seed` on `device` (the family's model's
    `init`, `build_model`) and a zero AdamW state beside them."""
    params = build_model(cfg, device=device).init(seed)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32))


def adamw_config(cfg: ModelConfig, **kw) -> AdamWConfig:
    """AdamW with the config's moment dtype (bf16 for kimi-k2-1t-a32b), as
    the JAX dry-run builds it."""
    return AdamWConfig(moment_dtype=cfg.moment_dtype, **kw)


def train_state_shapes(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None) -> TrainState:
    """The train state on the meta device: parameters, AdamW moments in
    `opt_cfg.moment_dtype` (`adamw_config(cfg)` when None) and the step,
    with no data (the dry-run, `launch/dryrun.py`)."""
    return init_train_state(cfg, 0, opt_cfg or adamw_config(cfg), device="meta")


class StateShardings(NamedTuple):
    """Where a train state lives on a mesh (`runtime.Trainer`'s
    state_shardings): the mesh, the state's specs (`train_state_pspecs`)
    and, optionally, the inputs' (`input_pspecs`), by which the trainer
    places each batch."""

    mesh: Any
    specs: Any
    batch: dict | None = None


def state_shardings(cfg: ModelConfig, state: TrainState, mesh, batch_specs: dict | None = None
                    ) -> StateShardings:
    return StateShardings(mesh, train_state_pspecs(cfg, state, mesh), batch_specs)


def mesh_of(params: nn.Module):
    """The DeviceMesh of a parameter module on a mesh, else None."""
    from torch.distributed.tensor import DTensor

    p = next(params.parameters(), None)
    return p.device_mesh if isinstance(p, DTensor) else None


def shardings_of(specs: dict, mesh) -> dict:
    """{name: the DTensor placements of its spec on `mesh`}: the JAX
    package's `shardings_of` (NamedShardings of a PartitionSpec tree)."""
    return {name: placements(spec, mesh) for name, spec in specs.items()}


def _distribute(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)


def shard_module(module: nn.Module, placed: dict, mesh) -> nn.Module:
    """`module` with each parameter replaced, in place, by a DTensor
    parameter of its placements (`placed`: `shardings_of`), each rank
    keeping its slice of the values it holds (the same on every rank)."""
    for name, p in list(module.named_parameters()):
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        setattr(owner, leaf, nn.Parameter(_distribute(p, mesh, placed[name]),
                                          requires_grad=p.requires_grad))
    return module


def shard_state(cfg: ModelConfig, state: TrainState, mesh) -> TrainState:
    """The train state on `mesh`: parameters and AdamW moments as DTensors
    placed by `train_state_pspecs` (the moments as their parameters), the
    steps as they are (host scalars)."""
    specs = train_state_pspecs(cfg, state, mesh)
    m = {n: _distribute(t, mesh, placements(specs.opt.m[n], mesh)) for n, t in state.opt.m.items()}
    v = {n: _distribute(t, mesh, placements(specs.opt.v[n], mesh)) for n, t in state.opt.v.items()}
    return TrainState(params=shard_module(state.params, shardings_of(specs.params, mesh), mesh),
                      opt=AdamWState(m=m, v=v, step=state.opt.step), step=state.step)


def shard_batch(batch: dict, specs: dict, mesh) -> dict:
    """A batch's tensors placed by their specs (`input_pspecs`)."""
    return {k: _distribute(torch.as_tensor(v), mesh, placements(specs[k], mesh))
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, total_steps: int = 100_000,
                    device: str | torch.device = "cuda"):
    """train_step(state, batch) -> (state, metrics) for a model of any
    ported family (`build_model`): the loss, its gradient by autograd (the
    flash kernel's backward on the card; under `cfg.remat` each decoder
    layer, or each xLSTM mLSTM block or Mamba2 block, recomputed), then
    clipping and AdamW at the cosine schedule's rate, warm-up min(2000,
    total_steps // 10), every stacked leaf decayed as JAX decays it
    (`optim.adamw.jax_rank`). The parameters and moments are updated in
    place and the gradients freed; metrics holds "ce", "tokens",
    "grad_norm", "loss" and "lr" (and a decoder's "aux"). A state on a mesh
    (`shard_state`) steps under `models.layers.active_mesh` of it, its
    gradients placed as its parameters."""
    model = build_model(cfg, device=device)
    warmup = min(2000, total_steps // 10)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        mesh = mesh_of(state.params)
        if mesh is not None and get_active_mesh() is None:
            with active_mesh(mesh):
                return train_step(state, batch)
        params = state.params
        for p in params.parameters():
            p.grad = None
        loss, metrics = model.loss_fn(params, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        lr = cosine_schedule(state.step, peak_lr=opt_cfg.lr, warmup_steps=warmup,
                             total_steps=total_steps)
        _, opt, om = adamw_update(grads, state.opt, params, opt_cfg, lr=lr)
        del grads
        for p in params.parameters():
            p.grad = None
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss.detach()
        metrics["lr"] = lr
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# BPMF training CLI (train -> retain; optionally train-while-serve)
# ---------------------------------------------------------------------------


def bpmf_train_main(args) -> None:
    if args.co_serve:
        from repro_torch.launch.serve import run_train_and_serve

        run_train_and_serve(scale=args.scale, sweeps=args.sweeps, k=args.k,
                            burn_in=args.burn_in, window=args.keep,
                            samples=args.samples, seed=args.seed,
                            engine=args.engine, device=args.device)
        return

    from repro_torch.checkpoint import SampleStore
    from repro_torch.core import GibbsSampler
    from repro_torch.launch.serve import _demo_data

    train, test = _demo_data(args.scale, args.seed)
    if args.mode != "single":
        if "WORLD_SIZE" in os.environ:
            _distributed_on_ranks(args, train, test)
        else:
            from repro_torch.core.distributed import shard_devices

            _distributed(args, train, test, devices=shard_devices(args.shards, args.device))
        return
    widths = "balanced" if args.plan == "balanced" else (8, 32, 128)
    if args.engine == "sgld":
        from repro_torch.core.sgld import SGLDSampler

        sampler = SGLDSampler(train, test, k=args.k, alpha=4.0, burn_in=args.burn_in,
                              widths=widths, minibatch=args.minibatch,
                              step_size=args.step_size, device=args.device)
    else:
        sampler = GibbsSampler(train, test, k=args.k, alpha=4.0, burn_in=args.burn_in,
                               widths=widths, engine=args.engine, device=args.device)
    root = args.samples or tempfile.mkdtemp(prefix="bpmf_samples_")
    print(f"training {train.shape[0]} x {train.shape[1]} ({train.nnz} ratings), "
          f"k={args.k}, {args.sweeps} {_unit(args)} (burn-in {args.burn_in}), "
          f"engine={args.engine}, device={sampler.device} -> {root}")
    store = SampleStore(root, keep=args.keep)
    state = sampler.run(args.sweeps, seed=args.seed, store=store, thin=args.thin)
    print(f"test rmse {sampler.rmse(state):.4f}; retained {len(store.steps())} "
          f"draws; serve them with: python -m repro_torch.launch.serve --bpmf "
          f"--samples {root}")


def _distributed(args, train, test, **layout) -> None:
    """Train the distributed sampler over `layout` (devices= or mesh=) and
    print, from the process holding shard 0, the test RMSE."""
    from repro_torch.core.distributed import DistributedBPMF

    kw = dict(layout, k=args.k, alpha=4.0, mode=args.mode,
              width="auto" if args.plan == "balanced" else 32)
    if args.engine == "sgld":
        from repro_torch.core.sgld import DistributedSGLD

        d = DistributedSGLD(train, test, minibatch=args.minibatch,
                            step_size=args.step_size, **kw)
    else:
        d = DistributedBPMF(train, test, **kw,
                            engine="fused" if args.engine == "fused" else "einsum")
    lead = 0 in d.shards
    if lead:
        print(f"training {train.shape[0]} x {train.shape[1]} ({train.nnz} ratings), "
              f"k={args.k}, {args.sweeps} {_unit(args)} over {d.n_shards} shards on "
              f"{sorted({str(x) for x in d.devices})}"
              + (" (one a rank)" if "mesh" in layout else ""))
    state = d.run(args.sweeps, seed=args.seed, verbose=True)
    engine = "sgld" if args.engine == "sgld" else d.engine
    rmse = d.rmse(state)
    if lead:
        print(f"test rmse {rmse:.4f} ({d.n_shards} shards, engine={engine}, "
              f"mode={args.mode}, plan={args.plan})")


def _distributed_on_ranks(args, train, test) -> None:
    """The distributed sampler under torchrun: one shard a rank of the
    launch, over its group (`launch/mesh.py::open_rank_group`)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_item_mesh, open_rank_group

    world = int(os.environ["WORLD_SIZE"])
    if args.shards not in (None, world):
        raise SystemExit(f"under torchrun the shards are the {world} ranks; got --shards "
                         f"{args.shards}")
    open_rank_group(args.device)
    try:
        _distributed(args, train, test, mesh=make_item_mesh(device=args.device))
    finally:
        dist.destroy_process_group()


def _unit(args) -> str:
    return "steps" if args.engine == "sgld" else "sweeps"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bpmf", action="store_true",
                    help="train BPMF (the only CLI mode; LM training is a library)")
    ap.add_argument("--samples", default=None,
                    help="SampleStore directory for retained draws "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--burn-in", type=int, default=6)
    ap.add_argument("--keep", type=int, default=4,
                    help="retained-draw window (store keep / channel window)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="movielens_like dataset scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="fused", choices=[*ENGINES, "sgld"],
                    help="Gibbs sweep engine (with --mode: fused, or einsum for "
                         "any other), or 'sgld' for minibatch SG-MCMC: a step's "
                         "cost is set by --minibatch, not the data, and --sweeps "
                         "counts SGLD steps")
    ap.add_argument("--minibatch", type=int, default=4096,
                    help="sgld: padded-lane budget a half-step (a shard's, with "
                         "--mode)")
    ap.add_argument("--step-size", type=float, default=0.3,
                    help="sgld: peak Langevin step size, decaying polynomially "
                         "(optim.schedule.sgld_step_schedule)")
    ap.add_argument("--thin", type=int, default=1,
                    help="retain every thin-th post-burn-in draw")
    ap.add_argument("--plan", default="balanced", choices=["balanced", "pow2"],
                    help="bucket planner: 'balanced' fits the widths to the "
                         "degree profile, 'pow2' is the fixed ladder")
    ap.add_argument("--mode", default="single",
                    choices=["single", "ring", "allgather", "async"],
                    help="'single' = one-device GibbsSampler; otherwise a "
                         "DistributedBPMF exchange mode ('async' = "
                         "stale-tolerant fused ring pipeline)")
    ap.add_argument("--shards", type=int, default=None,
                    help="item shards of a distributed mode, laid out "
                         "round-robin over the visible cards (default: one a "
                         "card; one on the CPU); under torchrun, one a rank")
    ap.add_argument("--co-serve", action="store_true",
                    help="serve live recommendations from this process while "
                         "training, through the publication channel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)
    if not args.bpmf:
        raise SystemExit("only --bpmf has a CLI; LM training is a library")
    bpmf_train_main(args)


if __name__ == "__main__":
    main()
