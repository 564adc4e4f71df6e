"""Building blocks of the decoder LMs, ported from `repro/models/layers.py`.

The arithmetic is the JAX package's: activations and parameters in the
config's dtype (bf16 for the published configs), norms, RoPE and softmax
in fp32, and the products the JAX package takes with
`preferred_element_type=float32` (attention scores, P V, the logits) summed
in fp32 from exact products (`matmul_f32`). The cache-free attention of a
long sequence (`chunk`) runs the hand-written flash kernel
(`kernels/ops.py::flash_attention`); everything else is plain PyTorch.

Parameters keep the JAX layout (`wq` is (d_model, H * hd) and the layer
computes x @ wq), so `models/api.py::params_from_numpy` copies a
JAX parameter tree leaf by leaf. The dense configs' variants (layer norm,
QKV biases, ungated MLPs) and the MoE block's sort-based dispatch are
here, and `ModelConfig` carries the SSM, hybrid, audio and VLM families'
fields (`models/ssm.py`, `models/mamba.py`, `models/zamba.py` and the
whisper stack of `models/transformer.py` read them), as `attention_block`
carries Qwen2-VL's M-RoPE (`apply_mrope`) and whisper's non-causal and
cross-attention. The MoE's grouped dispatch (`moe_group_dispatch`) is
here, and so is the mesh: under `active_mesh(mesh)` (a DeviceMesh with the
JAX axes) the parameters and activations are DTensors, `constrain` places
a value as the JAX package's sharding constraint names it, and the regions
that DTensor has no rule for run under `local_map` with the collectives
the JAX package's shard_map uses (`_moe_sharded`, the attention's
sequence-sharded queries and the split-softmax decode).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Iterable, NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
#: the batch shards over these mesh axes (those the mesh has), the
#: sequence over SEQ_AXIS: the JAX package's token-sharded activations
BATCH_AXES = ("pod", "data")
SEQ_AXIS = "model"

# the mesh that the model's regions run on, made visible to the layers as
# the JAX package's `active_mesh` makes its concrete mesh visible
_ACTIVE_MESH: list = []


@contextlib.contextmanager
def active_mesh(mesh):
    _ACTIVE_MESH.append(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.pop()


def get_active_mesh():
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def mesh_spec(spec: tuple, mesh) -> tuple:
    """A spec with the axes `mesh` lacks dropped (BATCH_AXES names "pod"
    on a mesh without one)."""
    names = set(mesh.mesh_dim_names)

    def keep(e):
        if isinstance(e, tuple):
            e = tuple(a for a in e if a in names)
            return e if len(e) > 1 else (e[0] if e else None)
        return e if e in names else None

    return tuple(keep(e) for e in spec)


def spec_placements(spec: tuple, mesh) -> tuple:
    """`models/api.py::placements` of a spec, after `mesh_spec`."""
    from repro_torch.models.api import placements

    return placements(mesh_spec(spec, mesh), mesh)


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """x redistributed to `spec` (one entry a dim, as a PartitionSpec;
    `fit_spec`: as far as the mesh divides x's dims) under an active mesh
    where x is a DTensor; x itself otherwise, as the JAX
    `with_sharding_constraint` is a no-op outside a mesh."""
    mesh = get_active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = spec_placements(fit_spec(spec, tuple(x.shape), mesh), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def activation_spec() -> tuple:
    """(B, S, D) activations: batch over (pod, data), sequence over model."""
    return (BATCH_AXES, SEQ_AXIS, None)


def fit_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """`mesh_spec` with every entry whose axes do not divide its dim
    dropped: a (B, 1, D) decode step keeps its sequence whole, as the JAX
    input shardings keep any dim the mesh does not divide."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = []
    for e, n in zip(mesh_spec(spec, mesh), shape):
        ax = (e,) if isinstance(e, str) else (e or ())
        out.append(e if n % math.prod(sizes[a] for a in ax) == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------------
# local_map regions: what DTensor has no rule for runs on each rank's shard
# ---------------------------------------------------------------------------
class SeqShard(NamedTuple):
    """Where the code inside a region runs: the mesh; this rank's index on
    SEQ_AXIS and that axis's size (0 and 1 on a mesh without one), and
    whether the region's tokens are sharded over it (`seq`); the batch
    axes the mesh has, their product, and whether the tokens' batch is
    sharded over them (`batch`); and how
    many ranks hold each token (`replicas`: a sum over the tokens that
    leaves the region Partial is divided by it)."""

    mesh: Any
    index: int
    size: int
    seq: bool
    batch_axes: tuple[str, ...]
    batch_size: int
    batch: bool
    replicas: int

    @property
    def world(self) -> int:
        return self.mesh.size()


_region = threading.local()


def seq_shard() -> SeqShard | None:
    """The region this code runs in, or None outside one."""
    return getattr(_region, "shard", None)


@contextlib.contextmanager
def _in_region(mesh, tokens: tuple):
    """Inside a region whose tokens have the placements `tokens`."""
    outer = seq_shard()
    names = mesh.mesh_dim_names
    index, size = (mesh.get_local_rank(SEQ_AXIS), mesh.size(names.index(SEQ_AXIS))) \
        if SEQ_AXIS in names else (0, 1)
    seq = SEQ_AXIS in names and tokens[names.index(SEQ_AXIS)] == Shard(1)
    baxes = tuple(a for a in BATCH_AXES if a in names)
    batch = any(tokens[names.index(a)] == Shard(0) for a in baxes)
    bsize = math.prod(mesh.size(names.index(a)) for a in baxes)
    replicas = math.prod(mesh.size(i) for i, q in enumerate(tokens) if q == Replicate())
    _region.shard = SeqShard(mesh, index, size, seq, baxes, bsize, batch, replicas)
    try:
        yield
    finally:
        _region.shard = outer


# the tiled collectives with a backward (the "_single_" names where this
# torch has them: the "_tensor_" ones warn there)
_all_gather = getattr(funcol, "all_gather_single_autograd", None) or \
    funcol.all_gather_tensor_autograd
_reduce_scatter = getattr(funcol, "reduce_scatter_single_autograd", None) or \
    funcol.reduce_scatter_tensor_autograd


def _group(mesh, axis: str):
    return (mesh, mesh.mesh_dim_names.index(axis))


def _axis_size(axis: str) -> int:
    mesh = seq_shard().mesh
    return mesh.size(mesh.mesh_dim_names.index(axis))


def gather_axes(x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
    """x's shards over the mesh `axes` (major first) joined along `dim`, on
    each rank of them: the tiled all-gather, whose backward reduce-scatters
    (each rank's use of the whole adds into every shard's gradient)."""
    mesh = seq_shard().mesh
    for axis in reversed(axes):
        if _axis_size(axis) > 1:
            x = _all_gather(x.contiguous(), dim, _group(mesh, axis))
    return x


def reduce_scatter_axes(x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
    """The sum over the ranks of `axes` of x, each rank keeping its shard
    of `dim` (major axis first): the reduce-scatter, whose backward
    all-gathers."""
    mesh = seq_shard().mesh
    for axis in axes:
        if _axis_size(axis) > 1:
            x = _reduce_scatter(x.contiguous(), "sum", dim, _group(mesh, axis))
    return x


class _AllReduce(torch.autograd.Function):
    """The sum over a mesh axis's ranks; the backward sums the gradients
    the same way (each rank's gradient is its share, `region`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def all_reduce_axes(x: torch.Tensor, axes: tuple[str, ...], op: str = "sum") -> torch.Tensor:
    """The sum (or, with op "max", the max, which has no backward here) of x
    over the ranks of `axes`, on each of them."""
    mesh = seq_shard().mesh
    for axis in axes:
        if _axis_size(axis) > 1:
            if op == "sum":
                x = _AllReduce.apply(x, _group(mesh, axis))
            else:
                x = funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op,
                                                         _group(mesh, axis)))
    return x


def shard_index(axes: tuple[str, ...]) -> int:
    """This rank's shard of a dim sharded over the mesh `axes`, major first
    (JAX's order, and DTensor's over its mesh dims): 0 over no axis."""
    mesh, idx = (seq_shard().mesh if axes else None), 0
    for a in axes:
        idx = idx * _axis_size(a) + mesh.get_local_rank(a)
    return idx


def sharded_axes(t: torch.Tensor, dim: int) -> tuple[str, ...]:
    """The mesh axes of more than one rank that shard dim `dim` of a
    DTensor, in the mesh's order (major first); none for a plain tensor."""
    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(a for i, a in enumerate(mesh.mesh_dim_names)
                 if t.placements[i] == Shard(dim) and mesh.size(i) > 1)


def seq_chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's SEQ_AXIS shard of a dim that every rank holds whole."""
    sh = seq_shard()
    if sh is None or sh.size == 1:
        return x
    n = x.shape[dim] // sh.size
    return x.narrow(dim, sh.index * n, n)


def expert_sharded(name: str, p: torch.Tensor) -> bool:
    """Whether a region keeps the parameter `name` sharded over SEQ_AXIS:
    an MoE expert tensor whose expert dim the parameter rules put there
    (`models/api.py::param_pspecs`); every other parameter enters whole."""
    mesh = get_active_mesh()
    if not isinstance(p, DTensor) or SEQ_AXIS not in mesh.mesh_dim_names:
        return False
    axis = mesh.mesh_dim_names.index(SEQ_AXIS)
    return "moe" in name.split(".") and p.dim() == 3 and p.placements[axis] == Shard(0)


class _GradShare(torch.autograd.Function):
    """x itself; its gradient times `share`: an output held whole on n ranks
    (Replicate over them) hands each its 1/n share of the gradient."""

    @staticmethod
    def forward(ctx, x, share):
        ctx.share = share
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None


def _shared(out: Any, placements: tuple, mesh) -> Any:
    if not isinstance(out, torch.Tensor):
        return out
    n = math.prod(mesh.size(i) for i, p in enumerate(placements) if p == Replicate())
    return out if n == 1 or not out.requires_grad else _GradShare.apply(out, 1.0 / n)


class _Bound(nn.Module):
    def __init__(self, fn: Callable, block: nn.Module | None):
        super().__init__()
        self.fn, self.block = fn, block

    def forward(self, *args):
        return self.fn(self.block, *args)


def region(fn: Callable, block: nn.Module | None, args: tuple, out_placements: tuple, *,
           whole: tuple = (), unread: tuple[str, ...] = ()):
    """fn(block, *args) on each rank's shards under `local_map`, as the JAX
    package's GSPMD partitions it: `args` are DTensors, which enter as
    placed (their gradients leave so); the block's parameters enter whole
    (the FSDP all-gather: a `redistribute` to Replicate, whose backward
    reduce-scatters) but for MoE expert tensors, which keep their experts
    sharded over SEQ_AXIS (`expert_sharded`). Inside, the code is the plain
    path on local tensors: `seq_shard()` tells the attention and the MoE
    where the rank's tokens sit, and their collectives run over the mesh's
    groups.

    The backward runs on shares: each rank's gradient of a value is its
    share, and the shares sum to the gradient. An output held whole on n
    ranks (Replicate) hands each 1/n of its gradient (`_GradShare`), a
    collective's backward sums shares (`gather_axes`, `all_reduce_axes`),
    and what enters leaves Partial over the axes it was not sharded on: a
    parameter's gradient is summed over the ranks and scattered to its own
    placements by the redistribute's backward. An output that every rank
    computes in full leaves Partial, divided by the world size
    (`SeqShard.world`) inside. `whole`:
    parameters that are not the block's, which enter whole as its do and
    follow the args into fn. args[0] holds the tokens: their placements
    tell the code inside how they are sharded (`SeqShard`). `unread`: the
    block's parameters that fn does not read (whisper's cross-attention K
    and V weights at decode, whose K and V are cached), which do not enter
    and so are not gathered."""
    mesh = get_active_mesh()
    named = [(n, w) for n, w in block.named_parameters() if n not in unread] \
        if block is not None else []
    named += [(f"_whole.{i}", w) for i, w in enumerate(whole)]
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    part = tuple(Partial() for _ in range(mesh.ndim))
    axis = mesh.mesh_dim_names.index(SEQ_AXIS) if SEQ_AXIS in mesh.mesh_dim_names else -1
    weights, w_in, w_grad = [], [], []
    for name, p in named:
        if expert_sharded(name, p):
            want = tuple(p.placements[i] if i == axis else Replicate() for i in range(mesh.ndim))
            grad = tuple(p.placements[i] if i == axis else Partial() for i in range(mesh.ndim))
        else:
            want, grad = rep, part
        weights.append(p if tuple(p.placements) == want else p.redistribute(mesh, want))
        w_in.append(want)
        w_grad.append(grad)
    names = [n for n, _ in named]
    na, nb = len(args), len(named) - len(whole)
    single = all(not isinstance(q, (tuple, list)) for q in out_placements)

    def body(*local):
        with _in_region(mesh, tuple(args[0].placements)):
            extra = tuple(local[na + nb:])
            if block is None:
                out = fn(None, *local[:na], *extra)
            else:
                params = {"block." + n: w for n, w in zip(names, local[na:na + nb])}
                out = torch.func.functional_call(_Bound(fn, block), params,
                                                 tuple(local[:na]) + extra)
        if single:
            return _shared(out, out_placements, mesh)
        return tuple(_shared(o, pl, mesh) for o, pl in zip(out, out_placements))

    placed = tuple(tuple(a.placements) for a in args)
    shares = tuple(tuple(Partial() if q == Replicate() else q for q in pl) for pl in placed)
    return local_map(body, out_placements=(out_placements,) if single else out_placements,
                     in_placements=placed + tuple(w_in),
                     in_grad_placements=shares + tuple(w_grad),
                     device_mesh=mesh)(*args, *weights)


def distribute(t: torch.Tensor, spec: tuple, mesh=None) -> torch.Tensor:
    """t (whole on every rank) as a DTensor placed by `fit_spec`, each rank
    keeping its slice (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = mesh or get_active_mesh()
    return distribute_tensor(t, mesh, spec_placements(fit_spec(spec, tuple(t.shape), mesh), mesh),
                             src_data_rank=None)


def shard_like(t: torch.Tensor, like: DTensor) -> DTensor:
    """t (whole on every rank) placed as `like`, each rank keeping its slice."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)


def in_region(x: Any) -> bool:
    """Whether x is a DTensor under an active mesh: the model then runs its
    blocks as `region`s."""
    return get_active_mesh() is not None and isinstance(x, DTensor)


def partial_placements() -> tuple:
    return tuple(Partial() for _ in range(get_active_mesh().ndim))


def seq_region(fn: Callable, block: nn.Module, h: torch.Tensor, n_states: int = 0
               ) -> tuple[torch.Tensor, ...]:
    """A recurrent block under a mesh (the xLSTM's and Mamba2's scans, which
    run along the whole sequence): h gathered over SEQ_AXIS, fn(block,
    whole h) -> (out, *states) on every rank of it, and h plus the rank's
    shard of out, as the JAX package constrains the scans' inputs whole
    over the sequence. The states (batch first) leave sharded on their
    batch as h is, whole elsewhere."""
    def body(blk, hl):
        sh = seq_shard()
        whole = gather_axes(hl, 1, (SEQ_AXIS,)) if sh.seq else hl
        out, *states = fn(blk, whole)
        return (hl + (seq_chunk(out, 1) if sh.seq else out), *states)

    st = tuple(Shard(0) if q == Shard(0) else Replicate() for q in h.placements)
    return region(body, block, (h,), (tuple(h.placements),) + (st,) * n_states)


class Part(NamedTuple):
    """One layer's recurrent decode state on this rank under a mesh: `local`
    the rank's piece of it (a view of the cache leaf, written in place),
    `sl` that piece's slices of the layer's whole state (one a dim, the
    batch dim's within the block's rows, `state_region`), and `reduce`:
    whether what is computed from the piece joins the other ranks' by a
    sum over SEQ_AXIS (`join`): the piece is one of several over a dim
    that is not the rows, or the layer's slot of a stacked axis that
    SEQ_AXIS shards, which one rank holds and the others hold nothing of.
    Without a mesh, or where the leaf is whole, the piece is the state
    (`whole`): the recurrences' one step (`models/ssm.py::mlstm_step`,
    `slstm_step`, `conv_step`, `models/mamba.py::ssd_step`) serves both."""

    local: torch.Tensor
    sl: tuple
    reduce: bool


def whole(t: torch.Tensor) -> Part:
    """t as the `Part` that is all of the state."""
    return Part(t, (slice(None),) * t.dim(), False)


def write(parts: tuple[Part, ...], values: Iterable[torch.Tensor]) -> None:
    """Each piece's new value (a step's) into its cache leaf, in place."""
    for part, value in zip(parts, values):
        part.local.copy_(value)


def join(value: torch.Tensor, sl: tuple, shape: tuple, reduce: bool) -> torch.Tensor:
    """A value computed on the slices `sl` of a tensor of `shape`, as that
    whole tensor on every rank of SEQ_AXIS: zeros elsewhere, summed over
    the ranks where `reduce` (x + 0 is x: a gather; the pieces of a sum over
    a sharded dim add up: an all-reduce). The value itself where it is
    already whole."""
    if not reduce and all(q == slice(None) for q in sl):
        return value
    out = torch.zeros(shape, dtype=value.dtype, device=value.device)
    out[sl] = value
    return all_reduce_axes(out, (SEQ_AXIS,)) if reduce else out


def state_dim(t: torch.Tensor) -> int | None:
    """The dim of a recurrent state leaf (a DTensor) that SEQ_AXIS shards,
    or None where it is whole on every axis of more than one rank. The
    cache rules (`models/api.py::cache_pspecs`) shard such a leaf over
    SEQ_AXIS alone; any other placement raises."""
    mesh, dim = t.device_mesh, None
    for i, (axis, pl) in enumerate(zip(mesh.mesh_dim_names, t.placements)):
        if mesh.size(i) == 1 or pl == Replicate():
            continue
        if axis != SEQ_AXIS or not isinstance(pl, Shard):
            raise NotImplementedError(f"a recurrent state placed {tuple(t.placements)}: the "
                                      f"decode step on a mesh takes states sharded over "
                                      f"{SEQ_AXIS!r} alone")
        dim = pl.dim
    return dim


def state_part(local: torch.Tensor, idx: tuple[int, ...], dim: int | None) -> Part:
    """The `Part` of the layer at stacked index `idx` (the leaf's leading
    axes) of a state leaf, in a region: `local` the rank's shard of the
    leaf, `dim` the leaf's dim that SEQ_AXIS shards (`state_dim`)."""
    lead = len(idx)
    full = (slice(None),) * (local.dim() - lead)
    if dim is None or dim == lead:       # whole, or the batch: the block's rows are the rank's
        return whole(local[idx])
    rank = seq_shard().mesh.get_local_rank(SEQ_AXIS)
    n = local.shape[dim]
    if dim < lead:                       # a stacked axis: the layer's slot or nothing
        j = idx[dim] - rank * n
        if 0 <= j < n:
            return Part(local[idx[:dim] + (j,) + idx[dim + 1:]], full, True)
        view = local[idx[:dim] + (0,) + idx[dim + 1:]].narrow(0, 0, 0)
        return Part(view, (slice(0, 0),) + full[1:], True)
    sl = list(full)
    sl[dim - lead] = slice(rank * n, (rank + 1) * n)
    return Part(local[idx], tuple(sl), True)


def state_region(fn: Callable, block: nn.Module, h: torch.Tensor, leaves: tuple,
                 lead: int) -> torch.Tensor:
    """A recurrent block's decode step under a mesh, as a region. The state
    `leaves` (DTensors of stacked layers, `lead` stacked axes, each placed by
    `models/api.py::cache_pspecs`) enter at their placements and are
    written in place, each rank its own pieces. h (B, 1, D) is
    redistributed to the rows the states need: the batch over SEQ_AXIS
    where the leaves shard their batch there (the states' batch shard, not
    the tokens'), else whole; fn(block, h_rows, dims, *local leaves) ->
    h_rows' output, placed as h_rows, with `dims` the leaves' `state_dim`s.
    The states are never gathered: what a rank's arithmetic needs of
    the others' pieces is the step's own small outputs (`join`)."""
    mesh = get_active_mesh()
    dims = tuple(state_dim(t) for t in leaves)
    on_rows = {d == lead for d in dims}
    if len(on_rows) > 1:
        raise NotImplementedError("a block's states shard their batch over "
                                  f"{SEQ_AXIS!r} and others do not: {dims}")
    rows = on_rows == {True}
    want = tuple(Shard(0) if rows and a == SEQ_AXIS else Replicate()
                 for a in mesh.mesh_dim_names)
    if tuple(h.placements) != want:
        h = h.redistribute(mesh, want)

    def body(blk, x, *local):
        return fn(blk, x, dims, *local)

    return region(body, block, (h, *leaves), want)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to Replicate on every mesh axis (a Partial
    sum all-reduced); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() for _ in range(x.device_mesh.ndim))
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of `repro.models.layers.ModelConfig` that the dense, MoE,
    SSM (xLSTM), hybrid (Zamba2), audio (whisper) and VLM (Qwen2-VL)
    models read, with the same names and defaults; dtypes are torch's."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    n_experts_pad: int = 0           # allocated experts (0 -> n_experts); the
    moe_d_ff: int = 0                # pad experts are never routed to
    capacity_factor: float = 1.25
    # --- attention flavour ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma2: every 2nd layer global
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    attn_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    norm_eps: float = 1e-6
    norm_type: str = "rms"           # rms | layer
    post_norms: bool = False         # gemma2 sandwich norms
    tie_embeddings: bool = True      # False: a separate (d_model, vocab) head
    mlp_act: str = "silu"            # silu | gelu (tanh approximation)
    mlp_gated: bool = True           # gated (3-matrix) vs classic (2-matrix)
    qkv_bias: bool = False
    embed_scale: bool = False        # gemma2 multiplies embeddings by sqrt(d)
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    attn_every: int = 0              # zamba: shared attn block period
    slstm_every: int = 0             # xlstm: one sLSTM per group of this size
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # frames the encoder takes (the conv stub's output)
    # --- vlm ---
    n_patches: int = 0               # patch embeddings put before the text
    mrope_sections: tuple[int, ...] = ()   # M-RoPE's (t, h, w) lanes of hd / 2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32   # AdamW's m and v (bf16 for kimi)
    fsdp_pod: bool = False           # FSDP over ("pod", "data") on a mesh with a pod axis
    attn_chunk: int = 1024           # KV block of the JAX chunked attention
    chunked_attn_min_len: int = 8192 # cache-free sequences this long take the kernel
    remat: bool = True               # recompute each layer in the backward
    remat_policy: str = "nothing"    # nothing | dots | attn_probs (transformer.REMAT_POLICIES)
    attn_probs_bf16: bool = False    # the direct path's probabilities (and v) in bf16
    moe_group_dispatch: bool = False # per-sequence dispatch groups (no global sort)
    moe_ep_shard_map: bool = False   # the EP local_map region under a mesh with a model axis
    ssm_chunk: int = 128             # SSD chunk length (xLSTM's mLSTM keeps 64)
    ssd_fold_decay: bool = False     # fold exp(cumsum) into B/C, skip decay tensor
    slstm_reshard: bool = False      # sLSTM gate pre-activations held in bf16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# Initializers, norms, products
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator | None, shape: tuple[int, ...],
               dtype: torch.dtype, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """std * truncated_normal(-2, 2), std = 1/sqrt(fan_in) unless `scale`
    is given, drawn on `device` straight into `dtype` from `generator`.
    Without a generator the tensor is left uninitialised, for a caller that
    fills it (params_from_numpy)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if generator is None:
        return t
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             offset: float = 1.0) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (offset + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Mean, variance and rsqrt in fp32, then scale and bias, cast back."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 for bf16 operands: every product is exact and the sums
    are fp32, as XLA's `preferred_element_type=float32` (fp32 or float64
    operands of one dtype multiply as they are). a is
    (..., m, k) and b (k, n) or (..., k, n) with a's leading axes. On the
    card (and on the meta device, the dry-run's model of the card) bf16
    operands go through `MatmulF32`, whose backward is JAX's transpose of
    such a product; on the CPU autograd differentiates a.float() @
    b.float(), which is the same function."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return MatmulF32.apply(a, b)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 out (a and b of one dtype), through torch.mm or
    torch.bmm: a (..., m, k), b (k, n) or (..., k, n)."""
    if b.dim() == 2:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(a.shape[:-1] + b.shape[-1:])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(lead + out.shape[-2:])


class MatmulF32(torch.autograd.Function):
    """a @ b with fp32 out for bf16 operands on the card (cuBLAS). The
    backward is the transpose JAX takes of a `preferred_element_type=
    float32` product: the fp32 cotangent times the other operand (exact in
    fp32), summed in fp32, then cast to the operand's dtype:
    da = (g @ b^T).to(a.dtype), db = (a^T g).to(b.dtype), with b's leading
    axes summed where b is 2-D and a is not."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                a2 = a.reshape(-1, a.shape[-1]).float()
                db = (a2.t() @ g.reshape(-1, g.shape[-1])).to(b.dtype)
            else:
                db = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return da, db


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves of
    hd (not interleaved pairs), in fp32, and casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs            # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (B, S, H, hd), positions (B, 3, S) for
    the (t, h, w) axes. The hd / 2 frequency lanes are cut into `sections`
    (summing to hd / 2), and each section rotates by its own position
    channel; otherwise `apply_rope`'s arithmetic."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to hd / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    # output_size: the lanes' count is known without reading `sections`
    # back, which a meta tensor cannot (launch/dryrun.py)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device),
                                     output_size=hd // 2)
    lane_pos = positions.float().index_select(1, sec_id)      # (B, hd/2, S)
    angles = lane_pos.transpose(1, 2) * freqs                  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Q, K, V and output projections (JAX layout: x @ w), and with
    `cfg.qkv_bias` the Q, K and V biases (zeros at init); the layer's
    arithmetic is `attention_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd

        def w(shape):
            return nn.Parameter(dense_init(generator, shape, cfg.param_dtype, device))

        self.wq = w((d, cfg.n_heads * hd))
        self.wk = w((d, cfg.n_kv_heads * hd))
        self.wv = w((d, cfg.n_kv_heads * hd))
        self.wo = w((cfg.n_heads * hd, d))
        if cfg.qkv_bias:
            def zeros(n):
                return nn.Parameter(torch.zeros(n, dtype=cfg.param_dtype, device=device))

            self.bq = zeros(cfg.n_heads * hd)
            self.bk = zeros(cfg.n_kv_heads * hd)
            self.bv = zeros(cfg.n_kv_heads * hd)


def init_attention(cfg: ModelConfig, *, generator: torch.Generator | None,
                   device: torch.device) -> Attention:
    return Attention(cfg, generator=generator, device=device)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hk, hd) -> (B, S, H, hd) by repeating groups: head h reads
    group h // (H / Hk), as jnp.repeat orders them."""
    b, s, hk, hd = k.shape
    rep = n_heads // hk
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(b, s, hk, rep, hd).reshape(b, s, n_heads, hd)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                          window: int) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask of int position vectors; window 0 = none."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


_names = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The ops run inside carry `name` for a remat policy
    (`transformer.REMAT_POLICIES`), as `jax.ad_checkpoint.checkpoint_name`
    names a value: the selective checkpoint's policy reads it when the op
    runs."""
    outer = getattr(_names, "name", None)
    _names.name = name
    try:
        yield
    finally:
        _names.name = outer


def current_checkpoint_name() -> str | None:
    return getattr(_names, "name", None)


def multi_head_attention(
    q: torch.Tensor,                 # (B, Sq, H, hd)
    k: torch.Tensor,                 # (B, Sk, Hk, hd)
    v: torch.Tensor,                 # (B, Sk, Hk, hd)
    *,
    causal: bool,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: float = 0.0,
    q_offset: torch.Tensor | int = 0,
    chunk: int = 0,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """Attention over (B, S, H, hd) heads; returns (B, Sq, H, hd).

    The direct path materialises the (B, H, Sq, Sk) scores in fp32 and
    rounds the probabilities to q's dtype before P V, as the JAX package
    does. With `chunk` (a cache-free sequence of more than `chunk` keys)
    the flash kernel computes the same softmax with fp32 probabilities and
    never materialises the scores: where the JAX package takes its chunked
    path. That branch takes what the models give it: with causality a
    sequence's queries from an int q_offset (0, or a shard's offset under a
    mesh) against its keys (q_offset + Sq <= Sk); without, any Sq and Sk
    (whisper's cross-attention). It raises on anything else. A
    ragged Sk is masked exactly, as on the JAX direct
    path: the JAX chunked path pads it with zero keys that enter the
    softmax without causality, a fault of the reference that the port does
    not copy (ROADMAP.md, queue 3). The JAX signature's `kv_len` has no
    caller in the models and is not ported.

    `probs_bf16` (the config's `attn_probs_bf16`) rounds the direct path's
    probabilities, and v, to bf16 before P V, whatever q's dtype. The flash
    kernel writes no probability tensor, so the flag changes nothing on
    that branch. The probabilities carry the checkpoint name "attn_probs",
    which the remat policy of that name keeps.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = scale or (1.0 / math.sqrt(hd))

    if chunk and sk > chunk:
        if not isinstance(q_offset, int) or (causal and q_offset + sq > sk):
            raise ValueError("the flash path takes a cache-free sequence: an int q_offset, "
                             "and q_offset + Sq <= Sk where causal")
        return _flash(q, k, v, causal=causal, window=window,
                      softcap=attn_softcap, scale=scale, q_offset=q_offset)

    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)
    scores = matmul_f32(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale  # (B, H, Sq, Sk)
    scores = softcap(scores, attn_softcap)
    mask = attention_scores_mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(mask, scores, -1e30)
    probs_dtype = torch.bfloat16 if probs_bf16 else q.dtype
    if probs_dtype == torch.float32:
        with checkpoint_name("attn_probs"):
            probs = torch.softmax(scores, dim=-1)
    else:
        probs = torch.softmax(scores, dim=-1)
        with checkpoint_name("attn_probs"):     # the cast's output is the named tensor
            probs = probs.to(probs_dtype)
    del scores
    out = matmul_f32(probs, v.transpose(1, 2).to(probs_dtype))           # (B, H, Sq, hd)
    return out.transpose(1, 2).to(q.dtype)


def _flash(q, k, v, *, causal, window, softcap, scale, q_offset=0):
    """(B, S, H, hd) heads through the kernel's (B*H, S, hd) layout; k and v
    keep their Hk heads (the kernel maps each query head to its group)."""
    b, s, h, hd = q.shape
    hk = k.shape[2]

    def flat(x, n):
        return x.transpose(1, 2).reshape(b * n, x.shape[1], hd).contiguous()

    out = ops.flash_attention(flat(q, h), flat(k, hk), flat(v, hk), causal=causal,
                              window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def attention_block(
    params: Attention,
    x: torch.Tensor,                 # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,         # (B, S), or (B, 3, S) for M-RoPE
    causal: bool = True,
    window: int = 0,
    kv_src: torch.Tensor | None = None,   # cross-attention source (B, S_k, D)
    cache: dict | None = None,       # {"k", "v", "pos"}, or a static {"k", "v"}
    use_rope: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Projection + RoPE + attention + output projection.

    RoPE (M-RoPE where `cfg.mrope_sections`) applies to self-attention
    with `use_rope`; K and V come from `kv_src` where it is given. With a
    decode cache ((B, T, Hk, hd) buffers and a 0-d int "pos"), the new K/V
    are written at `pos` and the queries attend over the whole buffer with
    causality from q_offset = pos masking the unwritten slots. The buffers
    are updated in place (the JAX package returns new ones), so the cache
    passed in is consumed; the write start is clamped to [0, T - S], as
    `jax.lax.dynamic_update_slice` clamps it. A cache without "pos" is a
    static cross-attention cache (whisper's K/V of the encoder output,
    `transformer.init_cross_cache`): the queries attend over all of it,
    and x's own K/V, which the JAX package computes and drops, are not
    computed. Without a cache, a sequence of at least
    `cfg.chunked_attn_min_len` queries over more than `cfg.attn_chunk` keys
    takes the flash kernel (`multi_head_attention`), causal or not.

    In a region (`seq_shard()`), x holds the rank's shard of the sequence:
    the cache-free path gathers K and V over SEQ_AXIS (the JAX package
    constrains them replicated there) and its queries attend from their
    offset in the sequence, which also sets the path by the whole
    sequence's length. A cross-attention's kv_src comes whole. A decode
    cache sharded on its sequence (`models/api.py::cache_pspecs`) names
    the mesh axes that shard it under "axes" (`sharded_axes`, read by the
    caller from the DTensor) and takes the split softmax
    (`_decode_sharded`): over SEQ_AXIS, or over ("data", SEQ_AXIS) where
    one long sequence's cache spans both; a static cross-attention cache
    with "axes" takes it without causality (`split_softmax`).
    """
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params.wq.to(cfg.dtype)).reshape(b, s, h, hd)
    if cfg.qkv_bias:
        q = q + params.bq.to(cfg.dtype).reshape(h, hd)
    if cache is not None and (kv_src is not None or "pos" not in cache):
        if cache.get("axes"):
            out = split_softmax(q, cache["k"], cache["v"], cfg, cache["axes"])
        else:
            out = multi_head_attention(
                q, cache["k"].to(cfg.dtype), cache["v"].to(cfg.dtype), causal=False,
                attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale)
        out = out.reshape(b, s, h * hd) @ params.wo.to(cfg.dtype)
        return out, cache
    src = x if kv_src is None else kv_src
    k = (src @ params.wk.to(cfg.dtype)).reshape(b, src.shape[1], hk, hd)
    v = (src @ params.wv.to(cfg.dtype)).reshape(b, src.shape[1], hk, hd)
    if cfg.qkv_bias:
        k = k + params.bk.to(cfg.dtype).reshape(hk, hd)
        v = v + params.bv.to(cfg.dtype).reshape(hk, hd)
    if use_rope and kv_src is None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    sh = seq_shard()
    seq = sh is not None and sh.seq and sh.size > 1
    if cache is not None and sh is not None and (seq or cache.get("axes")):
        if seq:          # a prefill's shard of the prompt: every token's q, k, v
            q, k, v = (gather_axes(t, 1, (SEQ_AXIS,)) for t in (q, k, v))
        out, new_cache = _decode_sharded(q, k, v, cache, cfg, window)
        if seq:
            out = seq_chunk(out, 1)
    elif cache is not None:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        start = pos.clamp(0, ck.shape[1] - s).long()
        idx = start + torch.arange(s, device=x.device)
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        out = multi_head_attention(
            q, ck.to(cfg.dtype), cv.to(cfg.dtype), causal=True, window=window,
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, q_offset=pos,
        )
    else:
        q_offset, s_all = 0, s
        if sh is not None and sh.seq and sh.size > 1:
            if kv_src is None:
                k = gather_axes(k, 1, (SEQ_AXIS,))
                v = gather_axes(v, 1, (SEQ_AXIS,))
            q_offset, s_all = sh.index * s, s * sh.size
        chunk = cfg.attn_chunk if s_all >= cfg.chunked_attn_min_len else 0
        out = multi_head_attention(
            q, k, v, causal=causal, window=window, attn_softcap=cfg.attn_softcap,
            scale=cfg.attn_scale, q_offset=q_offset, chunk=chunk,
            probs_bf16=cfg.attn_probs_bf16,
        )
    out = out.reshape(b, s, h * hd) @ params.wo.to(cfg.dtype)
    return out, new_cache


def _decode_sharded(q, k, v, cache: dict, cfg: ModelConfig, window: int
                    ) -> tuple[torch.Tensor, dict]:
    """Attention of queries held whole on every rank of the cache's
    sequence axes (a decode step's, or a prefill's gathered) over a K/V
    cache sharded on its sequence over `cache["axes"]` (SEQ_AXIS, or
    ("data", SEQ_AXIS) for one long sequence: `models/api.py::cache_pspecs`;
    none where the cache is whole): the rank that holds a new token's slot
    writes its K/V there, and `split_softmax` takes the softmax over the
    whole cache, causal from pos, with the window. The cache is never
    gathered."""
    s = q.shape[1]
    ck, cv = cache["k"], cache["v"]                     # (B, T_loc, Hk, hd)
    pos = cache["pos"]
    axes = tuple(cache.get("axes", ()))
    t_loc = ck.shape[1]
    lo, n = shard_index(axes) * t_loc, math.prod(_axis_size(a) for a in axes)
    start = pos.clamp(0, t_loc * n - s).long()
    # each of the rank's slots takes token lo + j - start where one lands
    tok = lo + torch.arange(t_loc, device=q.device) - start
    lands = ((tok >= 0) & (tok < s))[None, :, None, None]
    tok = tok.clamp(0, s - 1)
    ck.copy_(torch.where(lands, k.to(ck.dtype).index_select(1, tok), ck))
    cv.copy_(torch.where(lands, v.to(cv.dtype).index_select(1, tok), cv))
    out = split_softmax(q, ck, cv, cfg, axes, q_pos=pos, window=window)
    new = {"k": ck, "v": cv, "pos": pos + s}
    return out, (dict(new, axes=cache["axes"]) if "axes" in cache else new)


def split_softmax(q, ck, cv, cfg: ModelConfig, axes: tuple[str, ...], *,
                  q_pos: torch.Tensor | None = None, window: int = 0) -> torch.Tensor:
    """q (B, s, H, hd) held whole on every rank of `axes` against the rank's
    slots of a K/V cache (B, T_loc, Hk, hd) sharded on its sequence over
    `axes` (major first): each rank takes its slots' scores (causal from
    q_pos with the window, where q_pos is given; all of them where not, a
    static cross-attention cache), their max, the sum of their
    exponentials and its share of P V, and an all-reduce over every axis
    of the max, then of the rescaled sums and shares, gives the softmax
    over the whole cache."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    t_loc = ck.shape[1]
    lo = shard_index(axes) * t_loc
    scale = cfg.attn_scale or (1.0 / math.sqrt(hd))
    ke = _expand_kv(ck.to(cfg.dtype), h)
    ve = _expand_kv(cv.to(cfg.dtype), h)
    scores = matmul_f32(q.transpose(1, 2), ke.permute(0, 2, 3, 1)) * scale   # (B, H, s, T_loc)
    scores = softcap(scores, cfg.attn_softcap)
    if q_pos is not None:
        qp = q_pos + torch.arange(s, dtype=torch.int32, device=q.device)
        k_pos = lo + torch.arange(t_loc, dtype=torch.int32, device=q.device)
        mask = attention_scores_mask(qp, k_pos, causal=True, window=window)
        scores = torch.where(mask, scores, -1e30)
    m = all_reduce_axes(scores.amax(dim=-1, keepdim=True), axes, op="max")
    e = torch.exp(scores - m)
    l_all = all_reduce_axes(e.sum(dim=-1, keepdim=True), axes)
    o = all_reduce_axes(matmul_f32(e, ve.transpose(1, 2).float()), axes)
    return (o / l_all).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """MLP weights, with `w_gate` only where `cfg.mlp_gated`; the
    arithmetic is `mlp_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def w(shape):
            return nn.Parameter(dense_init(generator, shape, cfg.param_dtype, device))

        if cfg.mlp_gated:
            self.w_gate = w((d, f))
        self.w_up = w((d, f))
        self.w_down = w((f, d))


def init_mlp(cfg: ModelConfig, *, generator: torch.Generator | None,
             device: torch.device) -> MLP:
    return MLP(cfg, generator=generator, device=device)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact erf
    return F.silu(x) if cfg.mlp_act == "silu" else F.gelu(x, approximate="tanh")


def mlp_block(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """act(x w_gate) * (x w_up), or act(x w_up) ungated, then w_down."""
    u = x @ params.w_up.to(cfg.dtype)
    if cfg.mlp_gated:
        hidden = _act(cfg, x @ params.w_gate.to(cfg.dtype)) * u
    else:
        hidden = _act(cfg, u)
    return hidden @ params.w_down.to(cfg.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch; gathers only)
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """The router, (d_model, E) in fp32 and drawn in fp32, and the gated
    experts' weights, E_pad of each (the pad experts are never routed to);
    the arithmetic is `moe_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        ep = cfg.n_experts_pad or e

        def w(shape, dtype=cfg.param_dtype):
            return nn.Parameter(dense_init(generator, shape, dtype, device))

        self.router = w((d, e), torch.float32)
        self.w_gate = w((ep, d, f))
        self.w_up = w((ep, d, f))
        self.w_down = w((ep, f, d))


def init_moe(cfg: ModelConfig, *, generator: torch.Generator | None,
             device: torch.device) -> MoE:
    return MoE(cfg, generator=generator, device=device)


class MoERoute(NamedTuple):
    """Where each of a batch's T k token replicas goes. Replica i = t k + j
    is token t's j-th expert in ascending expert order, the order in which
    the JAX package's combine adds a token's contributions (its updates
    are sorted by expert). With G dispatch groups (whole sequences of T / G
    tokens), slot s = (e G + g) cap + c is place c of expert e's capacity
    buffer in group g, so the buffer is (E_pad, G cap, d): the experts'
    products take every group's places at once. One group is the global
    dispatch."""

    top_e: torch.Tensor              # (T, k) int64, experts ascending a row
    top_w: torch.Tensor              # (T, k) renormalised weights, fp32
    counts: torch.Tensor             # (E_pad G,) replicas routed to each (expert, group)
    cap: int                         # places an expert a group
    aux: torch.Tensor                # 0-d fp32 Switch load-balancing loss
    rep_slot: torch.Tensor           # (T k,) each replica's slot ...
    rep_keep: torch.Tensor           # ... where it fits in the capacity
    slot_rep: torch.Tensor           # (E_pad cap,) each slot's replica ...
    slot_used: torch.Tensor          # ... where one fills it


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values of each row
    in descending order and their indices, the lower index first among
    equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    out = x.index_select(0, idx)
    if valid is not None:
        out = out.masked_fill(~valid.view((-1,) + (1,) * (x.dim() - 1)), 0)
    return out


class _Route(torch.autograd.Function):
    """out[i] = x[idx[i]] where valid[i], else 0. The backward is the same
    kind of gather, dx[j] = g[inv[j]] where inv_valid[j]: the transpose
    wherever idx maps its valid rows one to one onto the rows inv maps back.
    So neither direction adds into a row: no `index_add_` or accumulating
    `index_put_`, which are atomic on the card."""

    @staticmethod
    def forward(ctx, x, idx, valid, inv, inv_valid):
        ctx.save_for_backward(inv, inv_valid)
        return _take(x, idx, valid)

    @staticmethod
    def backward(ctx, g):
        inv, inv_valid = ctx.saved_tensors
        return _take(g, inv, inv_valid), None, None, None, None


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(perm).scatter_(0, perm, torch.arange(perm.numel(),
                                                                 device=perm.device))


def moe_route(params: MoE, xf: torch.Tensor, cfg: ModelConfig, groups: int = 1, *,
              reduce: Callable | None = None, reduce_size: int = 1) -> MoERoute:
    """The router and the capacity-bounded assignment of
    `repro/models/layers.py::moe_block` for tokens xf (T, d): fp32 softmax,
    top k, weights renormalised by max(sum, 1e-9), the Switch auxiliary
    loss E sum(me ce) over all T tokens, a stable sort of the replicas by
    expert, each replica's place in its expert from the exclusive cumsum
    of the counts, and cap = max(ceil(T k / E capacity_factor), 1). A
    replica past the capacity is dropped. Under a mesh whose batch ranks
    hold reduce_size such token sets, `reduce` sums the auxiliary loss's
    per-expert sums over them, so that it is the whole batch's. With `groups` G > 1 the sort,
    the places and the capacity are each group's own (T / G consecutive
    tokens, cap from T / G), as `_moe_grouped` routes each sequence: a
    stable sort by (expert, group) leaves each group's replicas of an
    expert in replica order, the places a group-local stable sort gives."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_active
    e_pad = cfg.n_experts_pad or e
    dev, n = xf.device, t * k
    g = groups
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} dispatch groups")
    probs = torch.softmax(xf.float() @ params.router, dim=-1)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # a token's replicas in ascending expert order (its experts are distinct)
    top_e, within = torch.sort(top_e, dim=-1)
    perm = (torch.arange(t, device=dev)[:, None] * k + within).reshape(-1)
    top_w = _Route.apply(top_w.reshape(n), perm, None, _inverse(perm), None).reshape(t, k)

    flat_e = top_e.reshape(-1)
    # each replica's (expert, group) bucket: its expert when G = 1
    key = flat_e * g + torch.arange(n, device=dev) // (n // g)
    se, order = torch.sort(key, stable=True)
    buckets = torch.arange(e_pad * g, device=dev)
    offsets = torch.searchsorted(se, buckets)               # exclusive cumsum
    counts = torch.searchsorted(se, buckets, right=True) - offsets
    if reduce is None:
        me = probs.mean(dim=0)
        ce = counts.view(e_pad, g).sum(dim=1)[:e].float() / n
    else:
        me = reduce(probs.sum(dim=0)) / (t * reduce_size)
        ce = reduce(counts.view(e_pad, g).sum(dim=1)[:e].float()) / (n * reduce_size)
    aux = e * torch.sum(me * ce)

    cap = max(int(math.ceil(t // g * k / e * cfg.capacity_factor)), 1)
    # each replica's place in its bucket, back in replica order
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=dev) - offsets[se])
    rep_keep = pos < cap
    rep_slot = key * cap + pos.clamp(max=cap - 1)
    place = torch.arange(cap, device=dev)
    slot_used = (place[None, :] < counts[:, None]).reshape(-1)
    slot_rep = order[(offsets[:, None] + place[None, :]).clamp(max=n - 1).reshape(-1)]
    return MoERoute(top_e, top_w, counts, cap, aux, rep_slot, rep_keep, slot_rep,
                    slot_used)


def moe_experts(params: MoE, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated expert MLPs on the (E_pad, cap, d) buffer."""
    def w(p):
        return p.to(cfg.dtype)

    g = torch.bmm(buf, w(params.w_gate))
    u = torch.bmm(buf, w(params.w_up))
    return torch.bmm(_act(cfg, g) * u, w(params.w_down))


def moe_combine(y: torch.Tensor, route: MoERoute, cfg: ModelConfig) -> torch.Tensor:
    """Each token's kept replicas' expert outputs times their weights,
    added in the activation dtype one at a time from zero in ascending
    expert order, as the JAX package's `out.at[st_].add(back)` adds them.
    A dropped replica adds 0."""
    t, k = route.top_e.shape
    d = y.shape[-1]
    back = _Route.apply(y.reshape(-1, d), route.rep_slot, route.rep_keep,
                        route.slot_rep, route.slot_used)
    back = (back * route.top_w.reshape(-1, 1).to(cfg.dtype)).view(t, k, d)
    out = torch.zeros((t, d), dtype=cfg.dtype, device=y.device)
    for j in range(k):
        out = out + back[:, j]
    return out


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-bounded MoE with sort-based dispatch: the plain path
    of `repro/models/layers.py::moe_block`. Returns (out (B, S, D), aux).

    The replicas are the tokens expanded k times (the expand's backward
    sums over k), moved into the (E_pad, G cap, d) buffer and back by
    gathers whose backwards are gathers too (`_Route`), so the gradients
    are the same from run to run on the card. With `moe_group_dispatch`
    and S k >= 4 E each sequence is its own dispatch group (`_moe_grouped`:
    routing, sort and capacity per sequence); at B = 1 that is the global
    dispatch. `moe_ep_shard_map` takes the expert-parallel region only in a
    region of a mesh whose sequence axis is wider than one
    (`_moe_sharded`); elsewhere it falls through to the dispatches below,
    as the JAX package's does.

    In a region (`seq_shard()`) the dispatch is `_moe_sharded`'s."""
    sh = seq_shard()
    if sh is not None:
        return _moe_sharded(params, x, cfg, sh)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    e_pad = cfg.n_experts_pad or e
    groups = b if cfg.moe_group_dispatch and s * k >= 4 * e else 1
    xf = x.reshape(b * s, d)
    route = moe_route(params, xf, cfg, groups)
    reps = xf[:, None, :].expand(b * s, k, d).reshape(b * s * k, d)
    buf = _Route.apply(reps, route.slot_rep, route.slot_used, route.rep_slot,
                       route.rep_keep).view(e_pad, groups * route.cap, d)
    y = moe_experts(params, buf, cfg)
    return moe_combine(y, route, cfg).reshape(b, s, d), route.aux


def _my_slots(route: MoERoute, rows: int, e_lo: int, e_n: int, r_lo: int, r_n: int
              ) -> tuple[torch.Tensor, ...]:
    """The route restricted to one rank's block of the (E_pad, rows, d)
    buffer: experts e_lo .. e_lo + e_n - 1, rows r_lo .. r_lo + r_n - 1 of
    each (a row past `rows` is padding): (slot_rep, slot_used) of the
    block's e_n r_n slots and (rep_slot, rep_keep) of each replica into
    it, kept only where its slot is in the block."""
    dev = route.rep_slot.device
    e_idx = e_lo + torch.arange(e_n, device=dev)
    r_idx = r_lo + torch.arange(r_n, device=dev)
    valid = (r_idx < rows)[None, :].expand(e_n, r_n).reshape(-1)
    gslot = (e_idx[:, None] * rows + r_idx.clamp(max=rows - 1)[None, :]).reshape(-1)
    slot_rep = route.slot_rep[gslot]
    slot_used = route.slot_used[gslot] & valid
    e_of, r_of = route.rep_slot // rows, route.rep_slot % rows
    mine = (route.rep_keep & (e_of >= e_lo) & (e_of < e_lo + e_n)
            & (r_of >= r_lo) & (r_of < r_lo + r_n))
    rep_slot = (e_of - e_lo).clamp(0, e_n - 1) * r_n + (r_of - r_lo).clamp(0, r_n - 1)
    return slot_rep, slot_used, rep_slot, mine


def _moe_sharded(params: MoE, x: torch.Tensor, cfg: ModelConfig, sh: SeqShard
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE in a region: x is the rank's (B_loc, S_loc, d) shard, the
    expert weights the rank's experts where they are sharded over
    SEQ_AXIS (`expert_sharded`), else all of them. The route is the one the
    mesh-free path takes; each rank computes its block of the capacity
    buffer and adds its experts' outputs into a partial output, which a
    reduce-scatter sums into each rank's tokens:

      - the global dispatch (base): every token gathered to every rank and
        routed as one batch; a rank's block is its experts and its share
        of the capacity rows over the batch axes;
      - the grouped dispatch (`moe_group_dispatch`, S k >= 4 E): each
        sequence gathered over SEQ_AXIS and routed as its own group, the
        auxiliary loss's sums added over the batch axes, as `_moe_grouped`
        routes the whole batch;
      - expert parallelism (`moe_ep_shard_map`, S k >= 4 E, SEQ_AXIS wider
        than one): the JAX package's `_moe_ep_shard_map` with its
        collectives (the tokens gathered over SEQ_AXIS, each rank's
        experts, the partial outputs summed over SEQ_AXIS), the grouped
        route of the rank's sequences with its auxiliary loss averaged over
        the batch axes, as its `pmean`.

    Ranks that would compute the same block (the experts held whole, or a
    batch held whole) split its rows among themselves, and an all-reduce
    over them sums what a reduce-scatter does not. Returns the rank's
    output shard and the auxiliary loss divided by the world size (the
    region's Partial output)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    e_pad = cfg.n_experts_pad or e
    seq_axes = (SEQ_AXIS,) if sh.seq else ()
    batch_axes = sh.batch_axes if sh.batch else ()
    s_all = s * sh.size if sh.seq else s
    e_n = params.w_gate.shape[0]
    e_split = e_n < e_pad
    e_lo = sh.index * e_n if e_split else 0
    long_seq = s_all * k >= 4 * e
    ep = cfg.moe_ep_shard_map and long_seq and sh.size > 1
    xs = gather_axes(x, 1, seq_axes)
    # (axis, its rank's index, its size) of the axes whose ranks split rows
    model_dup = [] if e_split or sh.size == 1 else [(SEQ_AXIS, sh.index, sh.size)]
    batch_dup = [(a, sh.mesh.get_local_rank(a), _axis_size(a)) for a in sh.batch_axes]
    if ep or (cfg.moe_group_dispatch and long_seq):
        reduce = None
        if not ep and batch_axes:
            reduce = functools.partial(all_reduce_axes, axes=batch_axes)
        route = moe_route(params, xs.reshape(b * s_all, d), cfg, b, reduce=reduce,
                          reduce_size=sh.batch_size if batch_axes else 1)
        rows = b * route.cap
        dup = model_dup + ([] if batch_axes else batch_dup)
        gathered = seq_axes
    else:
        xs = gather_axes(xs, 0, batch_axes)
        route = moe_route(params, xs.reshape(-1, d), cfg, 1)
        rows = route.cap
        dup = batch_dup + model_dup
        gathered = seq_axes + batch_axes
    dup_n, dup_i = 1, 0
    for _, idx, n in dup:
        dup_n, dup_i = dup_n * n, dup_i * n + idx
    r_n = -(-rows // dup_n)
    slot_rep, slot_used, rep_slot, keep = _my_slots(route, rows, e_lo, e_n, dup_i * r_n, r_n)
    t_all = xs.shape[0] * xs.shape[1]
    xf = xs.reshape(t_all, d)
    reps = xf[:, None, :].expand(t_all, k, d).reshape(t_all * k, d)
    buf = _Route.apply(reps, slot_rep, slot_used, rep_slot, keep).view(e_n, r_n, d)
    y = moe_experts(params, buf, cfg)
    mine = route._replace(rep_slot=rep_slot, rep_keep=keep, slot_rep=slot_rep,
                          slot_used=slot_used)
    out = moe_combine(y, mine, cfg).view(xs.shape)
    # a token's output is summed over the ranks whose blocks differ
    differ = {a for a, _, _ in dup} | ({SEQ_AXIS} if e_split else set())
    out = reduce_scatter_axes(out, 1, seq_axes)
    out = reduce_scatter_axes(out, 0, tuple(a for a in batch_axes if a in gathered))
    out = all_reduce_axes(out, tuple(a for a in sh.mesh.mesh_dim_names
                                     if a in differ and a not in gathered))
    return out, route.aux / sh.world
