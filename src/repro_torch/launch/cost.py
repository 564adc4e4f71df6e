"""Op-level cost model of the port: the counterpart of `repro/launch/hlo_analysis.py`.

The JAX package compiles a step and walks its optimized HLO. PyTorch eager
has no compile step, so the port runs the step itself on the meta device
(no data, nothing allocated) under `CostCounter`, a TorchDispatchMode that
sees every aten op and every kernel of the port (`kernels/ops.py`: each
one is a dispatcher op with a fake) and records:

  - flops: `torch.utils.flop_counter`'s formulas (the matrix products,
    2 m n k) and the port's kernels' (registered in `kernels/ops.py`);
    elementwise and transcendental work counts nothing, as in the HLO
    model. Products of bf16 or fp16 operands are the tensor cores'
    (`tensor_flops`); the rest run on the fp32 pipes;
  - HBM bytes: each op's distinct inputs (a view counts its own elements)
    plus its outputs. In eager mode every op is a kernel, so operand plus
    result bytes is the analog of the HLO model's fusion-level traffic. An
    op that only writes its first argument (copy_, fill_, zero_, the
    in-place random draws) is not charged for reading it. Views and
    metadata ops are free, as HLO's `_FREE_OPS` are, and so are the
    allocations themselves (empty, empty_like, ...);
  - exchange bytes: what the ops inside the distributed sampler's
    collectives (`exchanging`, around `core/exchange.py`'s) write, the analog of the
    HLO model's collective bytes;
  - the peak of live bytes: the storages the ops allocate, from their
    allocation to their release (a weak reference a storage), on top of
    the arguments' (`arguments=`), plus, at a kernel of the port, the
    scratch its launch allocates and frees (`WORKSPACE`).

On the meta device an op's output shapes depend only on its inputs'
shapes, strides and dtypes and its other arguments, so the counter keeps
them, with the op's cost, by that key: a repeated op (one step of a
recurrence, one layer of a stack) makes its outputs as
`torch.empty_strided` on the meta device and adds its cost again, without
running the op's meta function, which for an elementwise op is several
hundred microseconds of Python. The op is still dispatched, counted and
its outputs made; only the shape inference is not repeated. Ops on CPU
tensors only (the host's scalars: a step counter, the learning rate) run
as they are and cost nothing here.

A loop over steps or chunks (the sLSTM's 32,768 steps at prefill_32k)
still dispatches some twenty ops a step at about twenty microseconds
each. The models run those loops over `steps(n)`: range(n) everywhere
but under a counter, where, as the HLO model multiplies a while body by
its trip count, the loop runs its first three iterations and its last
(which may be ragged), checks that the third dispatched the second's ops
exactly (the same shapes), and counts the n - 4 others as repeats of the
third; `Steps.full` gives a loop that collects an output an iteration its
other n - 4 outputs, empty. Under grad the third iteration's autograd
nodes (found by a TorchFunctionMode around it) count the ops the
backward runs for them n - 3 times: the ops the autograd engine runs
while such a node is its current one (`torch._C._current_autograd_node`),
its gradient sums into the nodes it feeds included, and without grad (a
recomputation of a checkpointed block runs with grad, and is a forward).
The bytes the iteration keeps alive (what it saves for the backward)
count n - 4 more times from the loop's end until the backward reaches
it. So the counts are the full loop's: `tests/test_torch_dryrun.py`
holds them to it. A loop recomputed inside the backward (remat) keeps its
cut iterations' bytes until the backward reaches its nodes.

On a device mesh (DTensors under a process group, `launch/mesh.py`) the
counter counts one rank's work: an op on DTensors is handed on to
DTensor (the mode returns NotImplemented), whose sharding propagation
runs on fake tensors (not counted) and whose local ops and collectives
come back through the mode on the rank's local tensors, as do the ops
inside a `local_map` region. The collectives (`_c10d_functional`'s, which
DTensor and the regions issue) count by kind as the HLO model names them
(all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute):
their operand bytes, their calls and the bytes on the wire (the HLO
model's factors of the operand bytes for a group of g ranks). The rank is
the fake world's last (`mesh.fake_world`), which under causal sequence
sharding holds the last queries, the most work.

`roofline_terms` is the JAX package's, keyword for keyword; its link term
reads the exchange bytes, or on a mesh the collective bytes, over NVLink
(`launch/mesh.py`).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import BF16_TENSOR_FLOPS, FP32_FLOPS

aten = torch.ops.aten

_exchange_state = threading.local()


@contextlib.contextmanager
def exchanging() -> Iterator[None]:
    """The ops run inside are a collective's (`core/exchange.py`): what
    they write counts as exchange bytes."""
    outer = getattr(_exchange_state, "on", False)
    _exchange_state.on = True
    try:
        yield
    finally:
        _exchange_state.on = outer


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """The ops run inside count nothing: shape-only work a real run does
    not do (a mesh's cache template, whose shards are allocated apart)."""
    outer = getattr(_exchange_state, "off", False)
    _exchange_state.off = True
    try:
        yield
    finally:
        _exchange_state.off = outer


#: ops that move no bytes of their own: views, metadata, and the
#: allocations (an empty tensor is written by the op that fills it)
FREE_OPS = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh, aten.detach,
    aten.alias, aten.view, aten.reshape, aten.expand, aten.permute, aten.t,
    aten.transpose, aten.select, aten.slice, aten.unsqueeze, aten.squeeze,
    aten.as_strided, aten.unbind, aten.split, aten.split_with_sizes, aten.chunk,
    aten.unfold, aten.view_as_real, aten.view_as_complex, aten.diagonal,
    aten.narrow, aten._reshape_alias, aten.unflatten, aten.flatten,
}
#: in-place ops that write their first argument without reading it
WRITE_ONLY = {
    aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_, aten.bernoulli_,
    aten.random_, aten.exponential_, aten.geometric_, aten.log_normal_, aten.cauchy_,
}
#: in-place ops that change their argument's metadata: always run
_META_MUTATING = {
    aten.resize_, aten.resize_as_, aten.transpose_, aten.t_, aten.squeeze_,
    aten.unsqueeze_, aten.as_strided_, aten.set_, aten.swapdims_, aten.swapaxes_,
    aten.detach_,
}
_TENSOR_CORE = (torch.bfloat16, torch.float16)
_SCALARS = (int, float, bool, str, torch.dtype, torch.device, torch.memory_format,
            torch.layout)

def _gather_syrk_seg_scratch(indices, values, mask, seg_ids, n_segments, v,
                             bf16_gather=False, identity_segments=False, seg_ptr=None) -> int:
    """The fp64 row partials of a multi-row bucket, (S, R, Kp, Kp) and
    (S, R, Kp), and the padded V where K is no kernel rank."""
    from repro_torch.kernels.ops import kernel_rank

    k = v.shape[-1]
    kp = kernel_rank(k)
    s = v.shape[0] if v.dim() == 3 else 1
    r = indices.shape[0]
    out = 0 if identity_segments else s * r * (kp * kp + kp) * 8
    if kp != k or bf16_gather:
        out += s * v.shape[-2] * kp * (2 if bf16_gather else 4)
    return out


def _topn_scratch(u, v, topk, slab=None) -> int:
    """A slab's (B, width) fp32 scores and, over several slabs, the running
    best (B, k) int64."""
    from repro_torch.kernels.ops import topn_slab

    b, n = u.shape[0], v.shape[0]
    width = topn_slab(b, n, topk, slab)
    return b * width * 4 + (b * topk * 8 if n > width else 0)


def _copies(*tensors: torch.Tensor) -> int:
    """Bytes of the contiguous copies a launcher makes of strided inputs."""
    return sum(_nbytes(t) for t in tensors if not t.is_contiguous())


def _flash_scratch(q, k, v, *args, **kwargs) -> int:
    return _copies(q, k, v)


def _flash_bwd_scratch(q, k, v, do, lse, o, *args, **kwargs) -> int:
    """D = rowsum(dO o), (BH, S_q) fp32, and the copies of strided inputs."""
    return q.shape[0] * q.shape[1] * 4 + _copies(q, k, v, do, o)


#: bytes a kernel's launch allocates and frees beyond its outputs, by its
#: op's name, from its arguments (as the op was called); the peak of live
#: bytes adds them at the launch
WORKSPACE: dict[str, Callable[..., int]] = {
    "gather_syrk_seg": _gather_syrk_seg_scratch, "topn_scores": _topn_scratch,
    "flash_forward": _flash_scratch, "flash_attention_bwd": _flash_bwd_scratch,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: meta kernels this module adds where the installed torch has none (torch
#: 2.11 has no meta kernel for the gamma draws of the Wishart noise)
_META_KERNELS: list = []


def _add_meta_kernels() -> None:
    if _META_KERNELS or torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_standard_gamma", "Meta"):
        return
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("_standard_gamma", lambda self, generator=None: torch.empty_like(self), "Meta")
    _META_KERNELS.append(lib)


class _Op:
    """One keyed op: its name, calls, cost a call, and how to make its
    outputs again (shape, stride, dtype and storage bytes of each; whether
    it returned one tensor; or, in place, its first argument)."""

    __slots__ = ("name", "calls", "flops", "tflops", "bytes", "exch", "scratch",
                 "specs", "single", "inplace", "coll", "coll_bytes", "wire")

    def __init__(self, name, flops, tflops, nbytes, exch, scratch, specs=None,
                 single=False, inplace=False):
        self.name, self.calls = name, 0
        self.flops, self.tflops, self.bytes = flops, tflops, nbytes
        self.exch, self.scratch = exch, scratch
        self.specs, self.single, self.inplace = specs, single, inplace
        self.coll, self.coll_bytes, self.wire = None, 0.0, 0.0


#: the HLO model's collective kinds, and the `_c10d_functional` ops of each
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}


def wire_factor(kind: str, g: int) -> float:
    """Bytes on the wire a rank, as a multiple of the operand's bytes, for
    a group of g ranks (`repro/launch/hlo_analysis.py`'s factors)."""
    if g <= 1:
        return 0.0
    return {"all-gather": g - 1.0, "reduce-scatter": (g - 1.0) / g,
            "all-reduce": 2.0 * (g - 1.0) / g, "all-to-all": (g - 1.0) / g,
            "collective-permute": 1.0}.get(kind, 1.0)


def _group_size(group: Any) -> int:
    """The ranks of a collective's group (its name, or the group)."""
    if not isinstance(group, str):
        return group.size()
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group).size()


#: the keys of a cut loop's marks in its autograd nodes' metadata: its
#: scale, and the marks of `_Nodes` (made, there before, walked)
_SCALE = "repro_torch.cost.scale"
_MADE, _BEFORE, _SEEN = ("repro_torch.cost.made", "repro_torch.cost.before",
                         "repro_torch.cost.seen")


class Steps:
    """range(n) for a loop whose every iteration runs the same ops on
    tensors of the same shapes (module docstring). `full(items)` pads a
    list of the iterations' outputs with empty tensors like its last
    where the counter ran fewer than n iterations."""

    def __init__(self, n: int):
        self.n = n
        #: [the bytes the cut iterations keep alive], where the counter cut
        #: a loop under grad
        self.kept: list | None = None

    def __iter__(self):
        counter = _counter()
        if counter is None or self.n <= 4 or counter._journal is not None or (
                torch.is_grad_enabled() and not hasattr(torch._C, "_current_autograd_node")):
            return iter(range(self.n))
        return counter._repeat(self)

    def full(self, items: list) -> list:
        """items (an output an iteration that ran) with the cut
        iterations' outputs, empty, in their place before the last."""
        rest = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in items[-1:] * (self.n - len(items))]
        counter = _counter()
        if rest and self.kept is not None and counter is not None:
            counter._filled(self.kept, sum(_nbytes(t) for t in rest))
        return items[:-1] + rest + items[-1:] if rest else items


class _Nodes(TorchFunctionMode):
    """The autograd nodes that what runs under it makes: `nodes()` walks
    the graph from its outputs' grad_fns (and an in-place op's target's)
    back to the grad_fns its inputs had before, which it leaves out, as it
    leaves out the leaves' AccumulateGrad nodes. The walk takes in the
    nodes a composite op (einsum) makes inside. Nodes are told apart by
    marks in their metadata, which lives with the graph's node: a node's
    Python object may be made anew at each access (torch 2.11), so its
    id() says nothing."""

    def __init__(self):
        super().__init__()
        self.token = object()
        self.made: list = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [x for a in (*args, *kwargs.values())
                for x in (a if isinstance(a, (list, tuple)) else (a,))
                if isinstance(x, torch.Tensor)]
        had = [x.grad_fn for x in flat]
        for node in had:
            if node is not None and node.metadata.get(_MADE) is not self.token:
                node.metadata[_BEFORE] = self.token
        out = func(*args, **kwargs)
        fresh = [t.grad_fn for t in (out if isinstance(out, (tuple, list)) else (out,))
                 if isinstance(t, torch.Tensor)]
        # an in-place op gives its target a new grad_fn
        fresh += [x.grad_fn for x, node in zip(flat, had)
                  if x.grad_fn is not None and (node is None or
                                                x.grad_fn.metadata is not node.metadata)]
        for node in fresh:
            if node is not None and node.metadata.get(_MADE) is not self.token:
                node.metadata[_MADE] = self.token
                self.made.append(node)
        return out

    def nodes(self) -> list:
        out, todo = [], list(self.made)
        while todo:
            node = todo.pop()
            meta = node.metadata
            if meta.get(_SEEN) is self.token or type(node).__name__ == "AccumulateGrad" or (
                    meta.get(_BEFORE) is self.token and meta.get(_MADE) is not self.token):
                continue
            meta[_SEEN] = self.token
            out.append(node)
            todo.extend(nxt for nxt, _ in node.next_functions if nxt is not None)
        return out


def steps(n: int) -> Steps:
    return Steps(n)


def _counter() -> "CostCounter | None":
    """The innermost CostCounter of this thread's dispatch modes."""
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, CostCounter)), None)


class CostCounter(TorchDispatchMode):
    """Flops, HBM bytes, exchange bytes and the peak of live bytes of what
    runs under it (module docstring). `arguments`: the tensors that are
    live when it starts (parameters, optimizer state, inputs, caches),
    whose storages count once in `argument_bytes` and the peak;
    `read_argument_bytes` counts those that an op read, as a JAX compile's
    argument size counts only the arguments its program uses (whisper's
    decode step reads none of its encoder's weights)."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        _add_meta_kernels()
        self._journal: list | None = None
        #: op calls counted as repeats of a loop's iteration, not dispatched
        self.repeated_ops = 0
        #: whether a cut loop's autograd nodes carry (in their metadata,
        #: under _SCALE) the calls each op of their backward counts (n - 3)
        #: and the loop's kept bytes; the nodes are not held here, so the
        #: graph is freed as it would be
        self._scaled = False
        #: the kept bytes of loops recomputed inside the backward
        self._recomputed: list[list] = []
        #: bytes the cut iterations of loops would keep alive
        self._phantom = 0
        self._cache: dict = {}          # key -> _Op
        self._once: list[_Op] = []      # ops that could not be keyed
        self._kinds: dict[int, str] = {}
        self._live: dict[int, tuple] = {}   # storage -> (bytes, weak reference)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.peak_at = ""
        args: dict[int, int] = {}
        for t in arguments:
            st = t.untyped_storage()
            args[st._cdata] = st.nbytes()
        self._arguments = args
        self._read: set[int] = set()
        self.argument_bytes = sum(args.values())

    @property
    def read_argument_bytes(self) -> int:
        return sum(self._arguments[k] for k in self._read)

    def _repeat(self, loop: Steps):
        """range(n) of a `steps` loop: iteration 0 fills the cache, 1 and 2
        are journaled; where they dispatched the same ops, iterations 3 to
        n - 2 are counted as repeats of iteration 2 and not run, and n - 1
        runs (module docstring)."""
        n = loop.n
        grad = torch.is_grad_enabled()
        yield 0
        journals, lives = [], [self.live_bytes]
        watch = _Nodes()
        for t in (1, 2):
            self._journal = []
            try:
                if grad and t == 2:
                    with watch:
                        yield t
                else:
                    yield t
            finally:
                journals.append(self._journal)
                lives.append(self.live_bytes)
                self._journal = None
        if not journals[1] or journals[0] != journals[1]:
            yield from range(3, n)
            return
        cut = n - 4
        for op in journals[1]:
            op.calls += cut
        self.repeated_ops += len(journals[1]) * cut
        if not grad:
            yield n - 1
            return
        # kept: [bytes the cut iterations keep alive until the backward
        # reaches the loop]; a loop recomputed inside the backward (remat)
        # keeps them until the backward reaches the next cut loop's nodes,
        # its own forward's
        kept = [max(lives[2] - lives[1], 0) * cut]
        self._add_phantom(kept[0])
        loop.kept = kept
        if torch._C._current_graph_task_id() != -1:
            self._recomputed.append(kept)
        for node in watch.nodes():
            node.metadata[_SCALE] = (cut + 1, kept)
            self._scaled = True
        yield n - 1

    def _add_phantom(self, nbytes: int) -> None:
        self._phantom += nbytes
        self.live_bytes += nbytes
        self._peak(self.live_bytes, "a cut loop")

    def _filled(self, kept: list, nbytes: int) -> None:
        """`Steps.full` allocates what a cut loop's kept bytes hold of its
        outputs: take it out of them."""
        take = min(nbytes, kept[0])
        kept[0] -= take
        self._add_phantom(-take)

    # -------------------------------------------------------------- records
    def _records(self) -> list[_Op]:
        return [*self._cache.values(), *self._once]

    def _total(self, field: str) -> float:
        return float(sum(op.calls * getattr(op, field) for op in self._records()))

    @property
    def flops(self) -> float:
        return self._total("flops")

    @property
    def tensor_flops(self) -> float:
        """Flops of bf16 and fp16 products: the tensor cores'."""
        return self._total("tflops")

    @property
    def hbm_bytes(self) -> float:
        return self._total("bytes")

    @property
    def exchange_bytes(self) -> float:
        return self._total("exch")

    def collectives(self) -> dict:
        """{"bytes", "counts", "wire_bytes"}: each by collective kind
        (COLLECTIVES), the operand bytes, the calls and the bytes on the
        wire of the rank's collectives."""
        out = {f: dict.fromkeys(COLLECTIVES, 0.0) for f in ("bytes", "counts", "wire_bytes")}
        for op in self._records():
            if op.coll is not None:
                out["bytes"][op.coll] += op.calls * op.coll_bytes
                out["counts"][op.coll] += op.calls
                out["wire_bytes"][op.coll] += op.calls * op.wire
        return out

    @property
    def n_ops(self) -> int:
        return sum(op.calls for op in self._records())

    @property
    def peak_bytes(self) -> int:
        """The arguments plus the most the ops had live at once."""
        return self.argument_bytes + self.peak_live_bytes

    @property
    def by_op(self) -> dict[str, list]:
        """op name -> [calls, flops, bytes]."""
        out: dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        for op in self._records():
            rec = out[op.name]
            rec[0] += op.calls
            rec[1] += op.calls * op.flops
            rec[2] += op.calls * op.bytes
        return dict(out)

    def top(self, key: str = "flops", n: int = 10) -> list[dict]:
        """The n ops with the most flops (or "bytes"), with their calls."""
        col = {"flops": 1, "bytes": 2}[key]
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][col])[:n]
        return [{"op": name, "calls": c, "flops": f, "bytes": b}
                for name, (c, f, b) in rows if (f if col == 1 else b) > 0]

    def summary(self) -> dict:
        flops, tflops = self.flops, self.tensor_flops
        return {
            "flops": flops, "tensor_flops": tflops, "fp32_flops": flops - tflops,
            "hbm_bytes": self.hbm_bytes, "exchange_bytes": self.exchange_bytes,
            "ops": self.n_ops, "argument_bytes": self.argument_bytes,
            "read_argument_bytes": self.read_argument_bytes,
            "peak_bytes": self.peak_bytes, "peak_at": self.peak_at,
        }

    # ------------------------------------------------------------- dispatch
    def _kind(self, func) -> str:
        """"free" (a view, metadata, an allocation), "inplace" (returns its
        mutated first argument), "fresh" (returns new tensors only) or
        "other"."""
        packet = func._overloadpacket
        rets = func._schema.returns
        first = func._schema.arguments[0] if func._schema.arguments else None
        if packet in FREE_OPS:
            return "free"
        if packet in _META_MUTATING:
            return "other"
        if (len(rets) == 1 and rets[0].alias_info is not None and rets[0].alias_info.is_write
                and first is not None and first.alias_info is not None
                and not first.kwarg_only):
            return "inplace"
        if not func._schema.is_mutable and rets and all(r.alias_info is None for r in rets):
            return "fresh"
        if rets and all(r.alias_info is not None and not r.alias_info.is_write for r in rets):
            return "free"
        return "other"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(_exchange_state, "off", False):
            return func(*args, **(kwargs or {}))
        for t in types:
            if issubclass(t, DTensor):
                return NotImplemented       # DTensor's local ops come back here
            if issubclass(t, FakeTensor):
                return func(*args, **(kwargs or {}))   # sharding propagation
        fid = id(func)
        kind = self._kinds.get(fid)
        if kind is None:
            kind = self._kinds[fid] = self._kind(func)
        if kwargs is None:
            kwargs = {}
        if kind == "free":
            out = func(*args, **kwargs)
            if func._overloadpacket in _ALLOCATIONS:
                self._allocated(out, func._overloadpacket)
            return out
        # the key: the op, whether it runs inside a collective, and each
        # argument (a keyword one after its name): a tensor's shape,
        # strides, dtype and whether it is on the meta device (or, passed
        # again, its place among the distinct tensors), a list's length and
        # items, or the value. Keyed: every tensor is on the meta device or
        # a CPU scalar (the learning rate), and one is on the meta device
        tensors: list = []
        key: list = [fid, getattr(_exchange_state, "on", False)]
        meta, keyed = False, True
        for a in (args if not kwargs else (*args, *(x for kv in kwargs.items() for x in kv))):
            if isinstance(a, torch.Tensor):
                parts = (a,)
            elif isinstance(a, (list, tuple)):
                key.append(len(a))
                parts = a
            elif a is None or isinstance(a, _SCALARS):
                key.append(a)
                continue
            else:
                keyed = False
                continue
            for x in parts:
                if isinstance(x, torch.Tensor):
                    for i, t in enumerate(tensors):
                        if t is x:
                            key.append(i)
                            break
                    else:
                        tensors.append(x)
                        if x.is_meta:
                            meta = True
                        elif x.dim():
                            keyed = False
                        key.append((x.shape, x.stride(), x.dtype, x.is_meta))
                elif x is None or isinstance(x, _SCALARS):
                    key.append(x)
                else:
                    keyed = False
        if not tensors:
            meta = torch.device(kwargs.get("device") or "cpu").type == "meta"
        if not meta and all(t.device.type == "cpu" for t in tensors):
            return func(*args, **kwargs)           # host work
        if self._arguments:
            for t in tensors:
                st = t.untyped_storage()._cdata
                if st in self._arguments:
                    self._read.add(st)
        key = tuple(key) if keyed and meta and kind != "other" else None
        op = self._cache.get(key) if key is not None else None
        scale = 1
        node = torch._C._current_autograd_node() if self._scaled else None
        if node is not None and not torch.is_grad_enabled():
            hit = node.metadata.get(_SCALE)
            if hit is not None:
                scale, kept = hit
                for held in [kept, *self._recomputed]:    # the backward reached the loop
                    self._add_phantom(-held[0])
                    held[0] = 0
                self._recomputed.clear()
        if op is not None:
            op.calls += scale
            if self._journal is not None:
                self._journal.append(op)
            if op.inplace:
                if op.scratch:
                    self._peak(self.live_bytes + op.scratch, op.name)
                return args[0]
            outs = []
            for size, stride, dtype, nbytes in op.specs:
                t = torch.empty_strided(size, stride, dtype=dtype, device="meta")
                self._track(t.untyped_storage()._cdata, t, nbytes)
                outs.append(t)
            self._peak(self.live_bytes + op.scratch, op.name)
            return outs[0] if op.single else tuple(outs)
        out = func(*args, **kwargs)
        op = self._new_op(func, kind, args, kwargs, tensors, out, key is not None)
        op.calls = scale
        if self._journal is not None:
            self._journal.append(op)
        if key is not None and (op.inplace or op.specs is not None):
            self._cache[key] = op
        else:
            self._once.append(op)
        if kind == "inplace":
            if op.scratch:
                self._peak(self.live_bytes + op.scratch, op.name)
        else:
            self._allocated(out, op.name, op.scratch)
        return out

    def _new_op(self, func, kind, args, kwargs, tensors, out, keyed: bool) -> _Op:
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = tflops = 0.0
        if formula is not None:
            # the products' ".dtype" overloads (an fp32 out of bf16 operands)
            # take the dtype after the operands, where the formulas do not
            shapes = args if func._overloadname != "dtype" else \
                tuple(a for a in args if not isinstance(a, torch.dtype))
            flops = float(formula(*shapes, **kwargs, out_val=out))
            floating = [t.dtype for t in tensors if t.is_floating_point()]
            if floating and floating[0] in _TENSOR_CORE:
                tflops = flops
        reads = tensors[1:] if kind == "inplace" and packet in WRITE_ONLY else tensors
        written = _out_bytes(out)
        nbytes = float(sum(_nbytes(t) for t in reads) + written)
        coll = _COLLECTIVE_OPS.get(packet.__name__) \
            if func.namespace in ("_c10d_functional", "_c10d_functional_autograd") else None
        fn = WORKSPACE.get(packet.__name__) if func.namespace == "repro_torch" else None
        scratch = int(fn(*args, **kwargs)) if fn is not None else 0
        op = _Op(str(packet), flops, tflops, nbytes,
                 float(written) if getattr(_exchange_state, "on", False) else 0.0, scratch,
                 inplace=kind == "inplace" and keyed)
        if coll is not None:
            operand = float(_nbytes(tensors[0]))
            op.coll, op.coll_bytes = coll, operand
            op.wire = operand * wire_factor(coll, _group_size(args[-1]))
        if keyed and kind == "fresh":
            flat = [out] if isinstance(out, torch.Tensor) else \
                list(out) if isinstance(out, (tuple, list)) else None
            if flat and all(isinstance(t, torch.Tensor) and t.is_meta
                            and t.storage_offset() == 0 for t in flat):
                op.specs = tuple((tuple(t.shape), t.stride(), t.dtype,
                                  t.untyped_storage().nbytes()) for t in flat)
                op.single = isinstance(out, torch.Tensor)
        return op

    # ------------------------------------------------------------- liveness
    def _allocated(self, out, name, scratch: int = 0) -> None:
        for t in ([out] if isinstance(out, torch.Tensor) else
                  out if isinstance(out, (tuple, list)) else ()):
            if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._arguments:
                continue
            self._track(key, t, st.nbytes())
        self._peak(self.live_bytes + scratch, name)

    def _track(self, key: int, t: torch.Tensor, nbytes: int) -> None:
        """Count t's storage (key: its address) live until it is freed."""
        self.live_bytes += nbytes
        self._live[key] = (nbytes, weakref.ref(t.untyped_storage(),
                                               lambda _, k=key: self._freed(k)))

    def _peak(self, live: int, name) -> None:
        if live > self.peak_live_bytes:
            self.peak_live_bytes = live
            self.peak_at = str(name)

    def _freed(self, key: int) -> None:
        nbytes, _ = self._live.pop(key, (0, None))
        self.live_bytes -= nbytes


# TorchDispatchMode wraps a subclass's __torch_dispatch__ so that dynamo
# skips it, a few microseconds an op; the counter never runs under
# torch.compile, and a step on the meta device is millions of ops
CostCounter.__torch_dispatch__ = getattr(CostCounter.__dict__["__torch_dispatch__"],
                                         "__wrapped__", CostCounter.__torch_dispatch__)

_ALLOCATIONS = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
                aten.new_empty_strided}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return _nbytes(out)
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(t) for t in out if isinstance(t, torch.Tensor))
    return 0


def roofline_terms(
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes_per_device: float,
    n_devices: int,
    peak_flops: float,
    hbm_bw: float,
    ici_bw: float,
) -> dict:
    """The JAX package's `roofline_terms`: every input per device. On the
    H100, `ici_bw` is NVLink's rate and the collective bytes are the
    exchange's (`CostCounter.exchange_bytes`)."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    collective_s = collective_bytes_per_device / ici_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update(
        dominant=dom,
        step_lower_bound_s=bound,
        roofline_fraction=(compute_s / bound) if bound > 0 else 0.0,
        global_flops=flops * n_devices,
        global_collective_bytes=collective_bytes_per_device * n_devices,
    )
    return terms


def compute_s_by_pipe(tensor_flops: float, fp32_flops: float) -> float:
    """The least time of the products on the H100's pipes: the tensor
    cores' at their bf16 rate, the rest at the fp32 pipes' (TF32 is off in
    the port, `device.resolve_device`)."""
    return tensor_flops / BF16_TENSOR_FLOPS + fp32_flops / FP32_FLOPS
