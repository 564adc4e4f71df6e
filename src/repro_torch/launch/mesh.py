"""The device mesh and the card's roofline constants, the counterpart of
`repro/launch/mesh.py`.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's shapes and axis names: (16, 16) ("data", "model") for one pod of
256 cards, (2, 16, 16) ("pod", "data", "model") for two. A mesh spans
the ranks of the default process group, one rank a card:

  - `make_production_mesh` needs a world of 256 or 512 ranks: on the meta
    device that is `fake_world(n)`, a process group of n ranks that moves
    no data (`torch.testing._internal.distributed.fake_pg`), in which this
    process is the last rank (the busiest under causal sequence sharding,
    `launch/dryrun.py`);
  - `make_host_mesh` covers the ranks the group has, (data, model), opening
    a group of one rank (NCCL on the card, gloo on the CPU, over an
    in-process store) where none is open: one card is a (1, 1) mesh;
  - `make_item_mesh` is the distributed sampler's: 1-D over every rank,
    the dim "items" (the JAX package's `AXIS`), one item shard a rank.
    Under `torchrun`, `open_rank_group` opens the group from its
    environment (NCCL on the card, gloo on the CPU).

The port runs on one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit.
The rates are the published peaks of NVIDIA's data sheet, dense, without
sparsity; a card set below 700 W runs slower under load, so a roofline
share is stated beside the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit`). `launch/cost.py::roofline_terms`
and `chip_smoke.py`'s bounds read them.

`serving_host_devices` gives the serving tier (serve/cluster.py) its
hosts' devices, one a shard host: on a mesh the lead rank of each index
along "pod" (else along the first axis), `serving_host_ranks`, each of
which must be this process's; without one the visible devices of a type,
cycled. NVLINK_BYTES_PER_S is the dry-run's link term.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

#: the card the constants describe, and the power limit they assume
CARD = "NVIDIA H100 80GB HBM3"
CARD_POWER_LIMIT_W = 700.0
#: device memory: bytes, and bytes a second
HBM_BYTES = 80e9
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: bf16 (and fp16) tensor-core operations a second
BF16_TENSOR_FLOPS = 989e12
#: NVLink to the other cards of the host, each way (900 GB/s both ways)
NVLINK_BYTES_PER_S = 450e9


#: the production meshes' shapes and axis names, the JAX package's
POD_MESH = ((16, 16), ("data", "model"))
MULTI_POD_MESH = ((2, 16, 16), ("pod", "data", "model"))


def _device_type(device: str | torch.device) -> str:
    """The mesh's device type: "cuda" on the card, "cpu" for the CPU and
    for the meta device (a fake world's shards are meta tensors)."""
    dev = torch.device(device)
    return "cpu" if dev.type == "meta" else resolve_device(dev).type


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with `multi_pod`, over the default group's ranks, which must number
    256 or 512 (`fake_world` on the meta device)."""
    shape, axes = MULTI_POD_MESH if multi_pod else POD_MESH
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"mesh {shape} needs a world of {need} ranks, have {have}: "
                           f"open one with launch.mesh.fake_world({need}) on the meta device")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device: str | torch.device = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the default group's ranks, model the
    largest divisor of the world size up to `model`. Without a group, one
    of one rank is opened over an in-process store (NCCL on the card, gloo
    on the CPU): `close_host_group` closes it."""
    dtype = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dtype == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        _opened.append(True)
    n = dist.get_world_size()
    model = max(d for d in range(1, max(1, min(model, n)) + 1) if n % d == 0)
    return init_device_mesh(dtype, (n // model, model), mesh_dim_names=("data", "model"))


def serving_host_ranks(mesh: DeviceMesh) -> list[int]:
    """The serving tier's lead ranks, one a shard host: the first rank of
    each index along "pod" when the mesh has that axis (the slowest
    fabric, where a resident shard and a routed U replica beat shipping
    scores), else along its first axis."""
    names = list(mesh.mesh_dim_names or ())
    k = names.index("pod") if "pod" in names else 0
    ranks = mesh.mesh
    return [int(ranks.select(k, i).flatten()[0]) for i in range(ranks.shape[k])]


def _rank_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on `mesh`: its current card on a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_local_devices(mesh: DeviceMesh) -> list[torch.device]:
    """The devices of `mesh` this process holds: its own rank's, once (a
    process is one rank), or none when the mesh leaves it out."""
    return [_rank_device(mesh)] if mesh.get_rank() in mesh.mesh.flatten().tolist() else []


def serving_host_devices(*, mesh: DeviceMesh | None = None, n_hosts: int | None = None,
                         device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices of the serving tier's shard hosts, one a host.

    With a mesh, each lead rank of `serving_host_ranks` maps to this
    process's device; a lead rank of another process raises, as one process
    places every host's tables (a tier whose hosts are processes is not
    built). Without one, the first `n_hosts` visible devices of `device`'s
    type, cycled when fewer exist (every card by default; "cpu" is one
    device): raises where a card is asked for and none is present."""
    if mesh is not None:
        me = mesh.get_rank()
        ranks = serving_host_ranks(mesh)
        for r in ranks:
            if r != me:
                raise RuntimeError(
                    f"serving host lead rank {r} belongs to another process (this one is "
                    f"rank {me}): one process places every shard host")
        return [_rank_device(mesh)] * len(ranks)
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(dev.type)]
    if n_hosts is None:
        n_hosts = len(visible)
    return [visible[i % len(visible)] for i in range(n_hosts)]


_opened: list[bool] = []

#: how long a rank waits at a collective for the others before it raises
RANK_TIMEOUT_S = 300


def open_rank_group(device: str | torch.device = "cuda") -> None:
    """The default group of a `torchrun` launch, from its environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL on the card, each
    rank on its LOCAL_RANK's card, gloo on the CPU. A rank left waiting at
    a collective raises after RANK_TIMEOUT_S."""
    dtype = _device_type(device)
    if dtype == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dtype == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def make_item_mesh(*, device: str | torch.device = "cuda") -> DeviceMesh:
    """The distributed sampler's mesh: 1-D over every rank of the open
    default group, the dim "items"; rank r holds item shard r
    (`core/distributed.py`). A "cuda" mesh takes each rank's current card."""
    if not dist.is_initialized():
        raise RuntimeError("make_item_mesh needs an open process group: open_rank_group() "
                           "under torchrun, or init_process_group")
    return init_device_mesh(_device_type(device), (dist.get_world_size(),),
                            mesh_dim_names=("items",))


def close_host_group() -> None:
    """Close the group `make_host_mesh` opened, if it opened one."""
    if _opened and dist.is_initialized():
        dist.destroy_process_group()
    _opened.clear()


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A process group of n ranks that moves no data, for meshes of meta
    tensors (the dry-run): this process is rank n - 1, the last index on
    every mesh axis. Closed again on exit; raises if a group is open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=n - 1, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
