"""Elastic rescale: restore a checkpoint onto any mesh, the counterpart of
`repro/checkpoint/elastic.py`.

A parameter's shape does not depend on the mesh, only its placements do,
and the sharding rules (`models/api.py::train_state_pspecs`) are functions
of the config and the mesh's axes: a state saved on one mesh (or on one
card, `runtime/trainer.py`) restores onto another by reading the host
arrays (`CheckpointStore.read_arrays`) and giving each rank its own slice
of every array, placed as the rules say (`CheckpointStore.restore`). No
rank sends anything: each reads the files and keeps its shard. bf16
tensors, stored as their int16 bit patterns, restore to the saved bits.
"""
from __future__ import annotations

from typing import Any

from torch import nn

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.models.api import placements


def restore_resharded(store: CheckpointStore, like: Any, specs: Any, mesh,
                      step: int | None = None) -> Any:
    """The train state of checkpoint `step` (the latest when None) on
    `mesh`: `like` gives its structure, shapes and dtypes (a
    `launch.train.TrainState`, on any device, the meta one included; its
    parameter module is filled in place with DTensor parameters), `specs`
    its placements (`train_state_pspecs` on `mesh`). The names are the
    trainer's (`runtime.trainer.state_tensors`); the steps stay host
    scalars."""
    from repro_torch.launch.train import TrainState
    from repro_torch.optim import AdamWState
    from repro_torch.runtime.trainer import state_tensors

    template = state_tensors(like)
    placed = {f"params.{n}": placements(s, mesh) for n, s in specs.params.items()}
    placed.update({f"m.{n}": placements(s, mesh) for n, s in specs.opt.m.items()})
    placed.update({f"v.{n}": placements(s, mesh) for n, s in specs.opt.v.items()})
    got = store.restore(template, step, placements=placed, mesh=mesh)
    module = like.params
    for name, p in list(module.named_parameters()):
        *path, last = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        setattr(owner, last, nn.Parameter(got[f"params.{name}"], requires_grad=p.requires_grad))
    return TrainState(params=module,
                      opt=AdamWState(m={n: got[f"m.{n}"] for n in like.opt.m},
                                     v={n: got[f"v.{n}"] for n in like.opt.v},
                                     step=got["opt_step"]),
                      step=got["step"])
