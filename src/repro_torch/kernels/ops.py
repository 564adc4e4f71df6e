"""Public wrappers of the CUDA kernels.

Each wrapper takes the plain PyTorch version (`kernels/ref.py`) for a tensor
on the CPU and nothing else; for a CUDA tensor it checks device, type, shape
and contiguity, launches its kernel on the tensor's card (made current for
the launch, `_on_card`: the launchers size their grids and set their
shared-memory limits for the current card) and that card's current stream,
raises if the launch returned an error, and adds one to its entry in
`LAUNCHES`. There is no fallback: a CUDA tensor the kernel cannot take
raises.

The syrk kernels take R and W as they are, and the solve its batch. The
BPMF kernels are built for the ranks in KERNEL_RANKS; another rank up to
64 is padded to the next one (`kernel_rank`) with zero columns
(`pad_rank`; the syrk sums gain exact zeros) or, for the solve, with an
identity block (`pad_rank_systems`): the only padding they get.
Top-N pads the width to a multiple of 4 with zero columns
(`topn_operands`) and scores the catalogue in slabs whose scratch is
bounded (`topn_slab`). Flash attention pads nothing: its kernels mask a
ragged sequence themselves. With grad, `flash_attention` is an autograd
Function (`FlashAttention`) whose backward is `flash_attention_bwd`, the
backward kernel on the card and its plain version on the CPU.

Each kernel is a dispatcher op (`torch.library.custom_op`, namespace
`repro_torch`): gather_syrk_seg (and gather_syrk_seg_into, its store into
the sweep's system buffers), masked_syrk, chol_solve_sample,
topn_scores, flash_forward and flash_attention_bwd. On a CUDA tensor the op
launches the kernel, on a CPU tensor it runs the plain version, and on the
meta device its fake (`register_fake`) returns empty outputs of the
kernel's shapes after the launch's shape checks, running nothing. Each op's
flops, the function's work as `chip_smoke.py`'s bounds count it, are
registered with `torch.utils.flop_counter` (`_flops_*` below): the cost
counter of the dry-run (`launch/cost.py`) and the flop counter read them.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

#: launches of each kernel since the last reset_launches(); the count moves
#: only where a wrapper launches its kernel. The serving tier launches from
#: several threads (trainer, host loops, request threads), so the counts
#: move under _launch_lock.
LAUNCHES = dict.fromkeys(
    ("gather_syrk_seg", "masked_syrk", "chol_solve_sample", "topn_scores",
     "flash_attention", "flash_attention_bwd"), 0
)
_launch_lock = threading.Lock()

#: the factor ranks the syrk and solve kernels are instantiated for
KERNEL_RANKS = (16, 32, 64)


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    """A consistent copy of LAUNCHES."""
    with _launch_lock:
        return dict(LAUNCHES)


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_card(x: torch.Tensor) -> torch.cuda.device:
    """The guard every launch runs under: x's card current. The launchers
    read the current card (`cudaGetDevice` for a persistent grid's size,
    `cudaFuncSetAttribute` for a kernel's shared memory), so a launch for
    cuda:1 while cuda:0 is current would size and configure for cuda:0."""
    return torch.cuda.device(x.device)


def _require(name: str, x: torch.Tensor, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    return x.contiguous()


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """x with zeros appended along `axis` up to a multiple of `mult`."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [0, pad])


def kernel_rank(k: int) -> int:
    """The rank the BPMF kernels run a rank-k problem at: the smallest of
    KERNEL_RANKS that is at least k."""
    for kp in KERNEL_RANKS:
        if k <= kp:
            return kp
    raise ValueError(
        f"the BPMF kernels take K <= {KERNEL_RANKS[-1]}, got {k}: the repo runs "
        "no larger rank; ROADMAP.md (queue 3) says what a larger one needs")


def pad_rank(x: torch.Tensor, kp: int) -> torch.Tensor:
    """x with zero columns appended to its last axis up to kp. The syrk
    sums over zero-padded factors hold the unpadded sums in their leading
    K x K block and K-vector, bit for bit."""
    pad = kp - x.shape[-1]
    return x if pad == 0 else F.pad(x, [0, pad])


def pad_rank_systems(prec: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor,
                     kp: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, K, K) systems padded to kp with an identity block,
    [[prec, 0], [0, I]], and zeros in rhs and z: the kept block's Cholesky
    and solves do the same arithmetic, and the padded entries of the
    solution are 0. (Zero padding would make the system singular.)"""
    k = prec.shape[-1]
    if kp == k:
        return prec, rhs, z
    eye = torch.eye(kp, device=prec.device, dtype=prec.dtype)
    big = eye.expand(prec.shape[:-2] + (kp, kp)).clone()
    big[..., :k, :k] = prec
    return big, pad_rank(rhs, kp), pad_rank(z, kp)


def segment_offsets(seg_ids: np.ndarray, n_segments: int) -> np.ndarray:
    """(n_segments + 1,) int32 row offsets of nondecreasing dense segment ids,
    taken on the host from a plan's bucket: the kernel's segment boundaries."""
    return np.searchsorted(seg_ids, np.arange(n_segments + 1)).astype(np.int32)


#: the widest bucket row the narrow paths of masked_syrk and of
#: gather_syrk_seg's identity buckets take (csrc/masked_syrk.cu,
#: csrc/gather_syrk_seg.cu); wider rows take one block a row. chip_smoke.py
#: times both paths of both kernels on every ChEMBL bucket the narrow path
#: can stage: on the H100 the narrow paths win up to width 8 and lose from
#: 15 (PERF.md §6)
SYRK_NARROW_MAX_W = 8


def gather_syrk_seg(
    indices: torch.Tensor,    # (R, W) int32
    values: torch.Tensor,     # (R, W) f32
    mask: torch.Tensor,       # (R, W) f32
    seg_ids: torch.Tensor,    # (R,) int32, nondecreasing dense 0..n_segments-1
    n_segments: int,
    v: torch.Tensor,          # (N, K) counterpart factors, or (S, N, K)
    *,
    bf16_gather: bool = False,
    identity_segments: bool = False,
    seg_ptr: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather -> syrk -> segment reduce: per-segment (prec, rhs).

    Returns prec (..., n_segments, K, K) and rhs (..., n_segments, K), with
    the leading draw axis iff v has one. `seg_ptr` (n_segments + 1 row
    offsets, int32, from `segment_offsets` on the host) is the plan's
    segment boundaries; the kernel needs it unless every row is its own
    segment. The kernel takes R and W as they are; identity buckets up to
    SYRK_NARROW_MAX_W wide take its narrow path.
    """
    return _gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v,
                            bf16_gather, identity_segments, seg_ptr)


def _check_gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v,
                           identity_segments, seg_ptr) -> None:
    """The launch's checks of shapes and types, which need no data."""
    if v.dtype != torch.float32:
        raise ValueError(f"v must be float32, got {v.dtype}")
    kernel_rank(v.shape[-1])
    r, w = indices.shape
    if r == 0 or n_segments == 0:
        raise ValueError("gather_syrk_seg needs at least one row and segment")
    if not identity_segments and seg_ptr is None:
        raise ValueError("gather_syrk_seg needs seg_ptr, the plan's segment "
                         "offsets, for a bucket of multi-row segments")
    if values.shape != (r, w) or mask.shape != (r, w) or seg_ids.shape != (r,):
        raise ValueError(f"values and mask must be {(r, w)} and seg_ids ({r},)")
    if identity_segments and n_segments != r:
        raise ValueError("an identity bucket has one segment a row")
    if seg_ptr is not None and not identity_segments and seg_ptr.shape != (n_segments + 1,):
        raise ValueError(f"seg_ptr must have {n_segments + 1} entries")


@torch.library.custom_op("repro_torch::gather_syrk_seg", mutates_args=())
def _gather_syrk_seg(indices: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                     seg_ids: torch.Tensor, n_segments: int, v: torch.Tensor,
                     bf16_gather: bool, identity_segments: bool,
                     seg_ptr: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather_syrk_seg` as one op: the kernel's launch or the plain version."""
    if not _on_cuda(v):
        return ref.gather_syrk_seg_ref(
            indices, values, mask, seg_ids, n_segments, v,
            bf16_gather=bf16_gather, identity_segments=identity_segments,
        )
    dev = v.device
    stacked = v.dim() == 3
    k = v.shape[-1]
    _check_gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v,
                           identity_segments, seg_ptr)
    kp = kernel_rank(k)
    # one copy of V per call where the rank is not instantiated; the sampler
    # pads V once per half-sweep instead (core/gibbs.py::posterior_systems)
    vs = pad_rank(v if stacked else v[None], kp)
    s, n, _ = vs.shape
    indices = _require("indices", indices, dev, torch.int32)
    values = _require("values", values, dev, torch.float32)
    mask = _require("mask", mask, dev, torch.float32)
    seg_ids = _require("seg_ids", seg_ids, dev, torch.int32)
    r, w = indices.shape
    vk = _aligned((vs.to(torch.bfloat16) if bf16_gather else vs).contiguous())
    if identity_segments:
        # the kernel writes each row's statistics straight into the output
        prec = torch.empty((s, r, kp, kp), device=dev, dtype=torch.float32)
        rhs = torch.empty((s, r, kp), device=dev, dtype=torch.float32)
        rows_prec = rows_rhs = ptr = None
    else:
        seg_ptr = _require("seg_ptr", seg_ptr, dev, torch.int32)
        # fp64 row partials for the second pass, which sums them by segment
        rows_prec = torch.empty((s, r, kp, kp), device=dev, dtype=torch.float64)
        rows_rhs = torch.empty((s, r, kp), device=dev, dtype=torch.float64)
        prec = torch.empty((s, n_segments, kp, kp), device=dev, dtype=torch.float32)
        rhs = torch.empty((s, n_segments, kp), device=dev, dtype=torch.float32)
        ptr = seg_ptr.data_ptr()
    lib = build.library("gather_syrk_seg")
    with _on_card(v):
        err = lib.gather_syrk_seg_launch(
            indices.data_ptr(), values.data_ptr(), mask.data_ptr(), vk.data_ptr(),
            int(bf16_gather),
            None if rows_prec is None else rows_prec.data_ptr(),
            None if rows_rhs is None else rows_rhs.data_ptr(), ptr,
            prec.data_ptr(), rhs.data_ptr(), r, w, n, s, n_segments, kp,
            SYRK_NARROW_MAX_W, _stream(v),
        )
    build.check("gather_syrk_seg", err)
    _count("gather_syrk_seg")
    if kp != k:
        prec, rhs = prec[..., :k, :k], rhs[..., :k]
    return (prec, rhs) if stacked else (prec[0], rhs[0])


@_gather_syrk_seg.register_fake
def _(indices, values, mask, seg_ids, n_segments, v, bf16_gather, identity_segments, seg_ptr):
    _check_gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v,
                           identity_segments, seg_ptr)
    k = v.shape[-1]
    lead = tuple(v.shape[:-2])
    return (v.new_empty(lead + (n_segments, k, k)), v.new_empty(lead + (n_segments, k)))


def gather_syrk_seg_into(
    indices: torch.Tensor,    # (R, W) int32
    values: torch.Tensor,     # (R, W) f32
    mask: torch.Tensor,       # (R, W) f32
    seg_ids: torch.Tensor,    # (R,) int32, nondecreasing dense 0..n_segments-1
    n_segments: int,
    v: torch.Tensor,          # (N, Kv) counterpart factors, one draw, Kv >= K
    prec_all: torch.Tensor,   # (n_items, K, K) f32, written in place
    rhs_all: torch.Tensor,    # (n_items, K) f32, written in place
    item_ids: torch.Tensor,   # (n_segments,) int64: segment -> item
    lam: torch.Tensor,        # (K, K) prior precision
    prior_rhs: torch.Tensor,  # (K,) prior precision times prior mean
    alpha: float,
    *,
    bf16_gather: bool = False,
    identity_segments: bool = False,
    seg_ptr: torch.Tensor | None = None,
) -> None:
    """`gather_syrk_seg` of one draw of V, stored as posterior systems:
    segment p's sums (S, s) land at item item_ids[p] as

        prec_all[item] = lam + alpha * S     rhs_all[item] = prior_rhs + alpha * s

    each product and sum rounded to fp32 on its own: the bits of
    `prec_all[ids] += alpha * prec` on buffers that hold the prior, with
    no output of the statistics, no prior copy and no pass over them. Only
    the items' K x K blocks and K-vectors are written (V may be padded to
    the kernel's rank), and nothing else of the buffers: the caller writes
    the prior into the items no bucket covers. No item may appear twice.
    On the card one `gather_syrk_seg` launch, on the CPU the plain version.
    """
    _gather_syrk_seg_into(indices, values, mask, seg_ids, n_segments, v, prec_all,
                          rhs_all, item_ids, lam, prior_rhs, alpha, bf16_gather,
                          identity_segments, seg_ptr)


def _check_gather_syrk_seg_into(indices, values, mask, seg_ids, n_segments, v, prec_all,
                                rhs_all, item_ids, lam, prior_rhs,
                                identity_segments, seg_ptr) -> None:
    """The "into" launch's checks of shapes and types, which need no data."""
    _check_gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v,
                           identity_segments, seg_ptr)
    if v.dim() != 2:
        raise ValueError(f"gather_syrk_seg_into takes one draw of V (N, K), got {tuple(v.shape)}")
    k = prec_all.shape[-1]
    n_items = prec_all.shape[0]
    if prec_all.shape != (n_items, k, k) or rhs_all.shape != (n_items, k):
        raise ValueError(f"prec_all and rhs_all must be (n_items, K, K) and (n_items, K), "
                         f"got {tuple(prec_all.shape)} and {tuple(rhs_all.shape)}")
    if not 1 <= k <= v.shape[-1]:
        raise ValueError(f"the systems' rank {k} must be at most V's {v.shape[-1]}")
    if lam.shape != (k, k) or prior_rhs.shape != (k,):
        raise ValueError(f"lam and prior_rhs must be {(k, k)} and ({k},)")
    if item_ids.shape != (n_segments,):
        raise ValueError(f"item_ids must have one item a segment, {n_segments}, "
                         f"got {tuple(item_ids.shape)}")
    if item_ids.dtype != torch.int64:
        raise ValueError(f"item_ids must be int64, got {item_ids.dtype}")
    for name, x in (("prec_all", prec_all), ("rhs_all", rhs_all), ("lam", lam),
                    ("prior_rhs", prior_rhs)):
        if x.dtype != v.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {v.dtype}")
        if x.device != v.device or item_ids.device != v.device:
            raise ValueError(f"{name} and item_ids must be on {v.device}")
    if not (prec_all.is_contiguous() and rhs_all.is_contiguous()):
        raise ValueError("prec_all and rhs_all must be contiguous: they are written in place")


@torch.library.custom_op("repro_torch::gather_syrk_seg_into",
                         mutates_args=("prec_all", "rhs_all"))
def _gather_syrk_seg_into(indices: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                          seg_ids: torch.Tensor, n_segments: int, v: torch.Tensor,
                          prec_all: torch.Tensor, rhs_all: torch.Tensor,
                          item_ids: torch.Tensor, lam: torch.Tensor, prior_rhs: torch.Tensor,
                          alpha: float, bf16_gather: bool, identity_segments: bool,
                          seg_ptr: Optional[torch.Tensor]) -> None:
    """`gather_syrk_seg_into` as one op: the kernel's launch or the plain version."""
    _check_gather_syrk_seg_into(indices, values, mask, seg_ids, n_segments, v, prec_all,
                                rhs_all, item_ids, lam, prior_rhs, identity_segments,
                                seg_ptr)
    if not _on_cuda(v):
        ref.gather_syrk_seg_into_ref(
            indices, values, mask, seg_ids, n_segments, v, prec_all, rhs_all, item_ids,
            lam, prior_rhs, alpha, bf16_gather=bf16_gather,
            identity_segments=identity_segments,
        )
        return
    dev = v.device
    k = prec_all.shape[-1]
    kp = kernel_rank(v.shape[-1])
    vs = pad_rank(v, kp)
    n = vs.shape[0]
    indices = _require("indices", indices, dev, torch.int32)
    values = _require("values", values, dev, torch.float32)
    mask = _require("mask", mask, dev, torch.float32)
    item_ids = _require("item_ids", item_ids, dev, torch.int64)
    lam = _aligned(_require("lam", lam, dev, torch.float32))
    prior_rhs = _aligned(_require("prior_rhs", prior_rhs, dev, torch.float32))
    if prec_all.data_ptr() % 16 or rhs_all.data_ptr() % 16:
        raise ValueError("prec_all and rhs_all must start on 16 bytes (the kernel's "
                         "vector stores)")
    r, w = indices.shape
    vk = _aligned((vs.to(torch.bfloat16) if bf16_gather else vs).contiguous())
    rows_prec = rows_rhs = ptr = None
    if not identity_segments:
        seg_ptr = _require("seg_ptr", seg_ptr, dev, torch.int32)
        # fp64 row partials for the second pass, whose store is the epilogue
        rows_prec = torch.empty((1, r, kp, kp), device=dev, dtype=torch.float64)
        rows_rhs = torch.empty((1, r, kp), device=dev, dtype=torch.float64)
        ptr = seg_ptr.data_ptr()
    lib = build.library("gather_syrk_seg")
    with _on_card(v):
        rc = lib.gather_syrk_seg_into_launch(
            indices.data_ptr(), values.data_ptr(), mask.data_ptr(), vk.data_ptr(),
            int(bf16_gather),
            None if rows_prec is None else rows_prec.data_ptr(),
            None if rows_rhs is None else rows_rhs.data_ptr(), ptr,
            prec_all.data_ptr(), rhs_all.data_ptr(), item_ids.data_ptr(),
            lam.data_ptr(), prior_rhs.data_ptr(), alpha, k, r, w, n, n_segments, kp,
            SYRK_NARROW_MAX_W, _stream(v),
        )
    build.check("gather_syrk_seg", rc)
    _count("gather_syrk_seg")


@_gather_syrk_seg_into.register_fake
def _(indices, values, mask, seg_ids, n_segments, v, prec_all, rhs_all, item_ids, lam,
      prior_rhs, alpha, bf16_gather, identity_segments, seg_ptr):
    _check_gather_syrk_seg_into(indices, values, mask, seg_ids, n_segments, v, prec_all,
                                rhs_all, item_ids, lam, prior_rhs, identity_segments,
                                seg_ptr)


def syrk_flops(k: int) -> int:
    """Operations of one rating's statistics at rank k: the symmetric
    v v^T needs k(k + 1) / 2 multiply-adds, r v needs k."""
    return k * (k + 1) + 2 * k


@register_flop_formula(torch.ops.repro_torch.gather_syrk_seg)
def _flops_gather_syrk_seg(indices, values, mask, seg_ids, n_segments, v, *args,
                           out_shape=None, **kwargs) -> int:
    """syrk_flops a rating slot of the plan (R W of them, a draw each):
    the shapes do not say which slots are padding."""
    draws = v[0] if len(v) == 3 else 1
    return draws * indices[0] * indices[1] * syrk_flops(v[-1])


@register_flop_formula(torch.ops.repro_torch.gather_syrk_seg_into)
def _flops_gather_syrk_seg_into(indices, values, mask, seg_ids, n_segments, v, *args,
                                out_shape=None, **kwargs) -> int:
    """`_flops_gather_syrk_seg`'s count for one draw: the syrk's work; the
    epilogue's two operations an entry are not counted."""
    return indices[0] * indices[1] * syrk_flops(v[-1])


def gather_syrk(indices: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-level fused gather + syrk, `repro/kernels/ops.py::gather_syrk`:
    every row is its own segment, so prec is (..., R, K, K) and rhs
    (..., R, K), one row's statistics each. `gather_syrk_seg` with identity
    segments: its kernel's identity path on the card (counted as a
    `gather_syrk_seg` launch), its plain version on the CPU."""
    r = indices.shape[0]
    seg = torch.arange(r, dtype=torch.int32, device=v.device)
    return gather_syrk_seg(indices, values, mask, seg, r, v, identity_segments=True)


def masked_syrk(vm: torch.Tensor, rv: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., R, W, K) x (..., R, W) -> (prec (..., R, K, K), rhs (..., R, K)).

    Extra leading axes (the stacked-draw axis S) are flattened into rows:
    every row is independent, so one launch covers them all. The kernel
    takes any R and W as they are; only a rank it is not built for is
    padded (`pad_rank`).
    """
    if vm.dim() > 3:
        lead = vm.shape[:-2]
        prec, rhs = masked_syrk(vm.reshape((-1,) + vm.shape[-2:]),
                                rv.reshape((-1, rv.shape[-1])))
        return (prec.reshape(lead + prec.shape[1:]),
                rhs.reshape(lead + rhs.shape[1:]))
    return _masked_syrk(vm, rv)


def _check_masked_syrk(vm, rv) -> None:
    r, w, k = vm.shape
    kernel_rank(k)
    if r == 0:
        raise ValueError("masked_syrk needs at least one row")
    if rv.shape != (r, w):
        raise ValueError(f"rv must be {(r, w)}, got {tuple(rv.shape)}")


@torch.library.custom_op("repro_torch::masked_syrk", mutates_args=())
def _masked_syrk(vm: torch.Tensor, rv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`masked_syrk` of (R, W, K) rows as one op."""
    if not _on_cuda(vm):
        return ref.masked_syrk_ref(vm, rv)
    dev = vm.device
    _check_masked_syrk(vm, rv)
    r, w, k = vm.shape
    kp = kernel_rank(k)
    vm = _aligned(pad_rank(_require("vm", vm, dev, torch.float32), kp))
    rv = _require("rv", rv, dev, torch.float32)
    prec = torch.empty((r, kp, kp), device=dev, dtype=torch.float32)
    rhs = torch.empty((r, kp), device=dev, dtype=torch.float32)
    lib = build.library("masked_syrk")
    with _on_card(vm):
        err = lib.masked_syrk_launch(
            vm.data_ptr(), rv.data_ptr(), prec.data_ptr(), rhs.data_ptr(),
            r, w, kp, SYRK_NARROW_MAX_W, _stream(vm),
        )
    build.check("masked_syrk", err)
    _count("masked_syrk")
    if kp != k:
        prec, rhs = prec[..., :k, :k], rhs[..., :k]
    return prec, rhs


@_masked_syrk.register_fake
def _(vm, rv):
    _check_masked_syrk(vm, rv)
    r, _, k = vm.shape
    return vm.new_empty((r, k, k), dtype=torch.float32), vm.new_empty((r, k), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.masked_syrk)
def _flops_masked_syrk(vm, rv, *, out_shape=None, **kwargs) -> int:
    """syrk_flops a slot of the (R, W) rows."""
    return vm[0] * vm[1] * syrk_flops(vm[2])


def chol_solve_sample(prec: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor,
                      indefinite: str = "clamp") -> torch.Tensor:
    """Batched x = Lambda^-1 rhs + L^-T z over any leading axes.

    `indefinite` is what a system that is not positive definite gives:
    "clamp" the values of the diagonal clamped at 1e-20, as the Pallas
    kernel gives them (engine "kernel"); "nan" a row of NaN, as a Cholesky
    that fails gives (engine "fused", which solved by substitution). A
    system is not positive definite where a pivot is not > 0 (NaN
    included). Nothing raises.

    The kernel takes the batch as it is. A rank the kernel is not
    instantiated for is padded with an identity block (`pad_rank_systems`):
    a zero-padded precision matrix is singular.
    """
    if prec.dim() > 3:
        lead = prec.shape[:-2]
        out = chol_solve_sample(prec.reshape((-1,) + prec.shape[-2:]),
                                rhs.reshape((-1, rhs.shape[-1])),
                                z.reshape((-1, z.shape[-1])), indefinite)
        return out.reshape(lead + out.shape[1:])
    return _chol_solve_sample(prec, rhs, z, indefinite)


def _check_chol_solve_sample(prec, rhs, z, indefinite) -> None:
    bsz, k, _ = prec.shape
    kernel_rank(k)
    if rhs.shape != (bsz, k) or z.shape != (bsz, k):
        raise ValueError("rhs and z must be (B, K)")
    if bsz == 0:
        raise ValueError("chol_solve_sample needs at least one system")
    if indefinite not in ref.INDEFINITE:
        raise ValueError(f"indefinite must be one of {ref.INDEFINITE}, got {indefinite!r}")


@torch.library.custom_op("repro_torch::chol_solve_sample", mutates_args=())
def _chol_solve_sample(prec: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor,
                       indefinite: str = "clamp") -> torch.Tensor:
    """`chol_solve_sample` of (B, K, K) systems as one op."""
    if not _on_cuda(prec):
        return ref.chol_solve_sample_ref(prec, rhs, z, indefinite)
    dev = prec.device
    bsz, k, _ = prec.shape
    kp = kernel_rank(k)
    prec = _require("prec", prec, dev, torch.float32)
    rhs = _require("rhs", rhs, dev, torch.float32)
    z = _require("z", z, dev, torch.float32)
    _check_chol_solve_sample(prec, rhs, z, indefinite)
    prec, rhs, z = (_aligned(x) for x in pad_rank_systems(prec, rhs, z, kp))
    out = torch.empty((bsz, kp), device=dev, dtype=torch.float32)
    lib = build.library("chol_solve_sample")
    with _on_card(prec):
        err = lib.chol_solve_sample_launch(
            prec.data_ptr(), rhs.data_ptr(), z.data_ptr(), out.data_ptr(),
            bsz, kp, int(indefinite == "nan"), _stream(prec),
        )
    build.check("chol_solve_sample", err)
    _count("chol_solve_sample")
    return out if kp == k else out[:, :k].contiguous()


@_chol_solve_sample.register_fake
def _(prec, rhs, z, indefinite="clamp"):
    _check_chol_solve_sample(prec, rhs, z, indefinite)
    return rhs.new_empty(rhs.shape)


@register_flop_formula(torch.ops.repro_torch.chol_solve_sample)
def _flops_chol_solve_sample(prec, rhs, z, indefinite="clamp", *, out_shape=None,
                             **kwargs) -> float:
    """n (K^3 / 3 + 2 K^2): the factorisation and the two triangular solves."""
    n, k = prec[0], prec[-1]
    return n * (k ** 3 / 3 + 2 * k * k)


TOPN_MAX_K = 8192  # the largest k whose keys the last sort holds in shared memory
#: the most the (B, slab) fp32 scores of one slab may take; a slab is at
#: least one 128-item tile, so the scratch is bounded whatever N is
TOPN_SCRATCH_BYTES = 256 << 20
#: shared memory of a selection block (csrc/topn.cu, MAX_SELECT_SMEM): the
#: k keys (8 bytes each, k rounded up to a power of two) and a slab's
#: scores of one row (4 bytes an item)
TOPN_SELECT_SMEM = 160 * 1024
_TOPN_TILE = 128   # users and items of the scoring kernel's block tile


def topn_operands(u: torch.Tensor, v: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """u (B, D) and v (N, D) with zero columns up to a multiple of 4 in D,
    the scoring kernel's float4 loads (no copy where D is one already). A
    zero column adds +0.0 to every score, which leaves its bits unchanged."""
    return _pad_to(u, 1, 4).contiguous(), _pad_to(v, 1, 4).contiguous()


def topn_slab(b: int, n: int, topk: int, slab: int | None = None) -> int:
    """Items a slab of the catalogue scores at once for b users and the
    top-k: a multiple of 128 (one tile at least), whose (b, slab) fp32
    scores fit TOPN_SCRATCH_BYTES and whose scores of one row fit a
    selection block beside the keys, at most the catalogue rounded up to a
    tile; `slab` asks for fewer."""
    tile = _TOPN_TILE
    keys = 8 << (topk - 1).bit_length()
    fit = min(TOPN_SCRATCH_BYTES // (4 * b), (TOPN_SELECT_SMEM - keys) // 4)
    whole = -(-n // tile) * tile
    want = whole if slab is None else -(-slab // tile) * tile
    return max(tile, min(fit // tile * tile, whole, want))


def topn_kernel_launches(b: int, n: int, topk: int, slab: int | None = None) -> int:
    """CUDA kernels one topn_scores call launches on the card: 2 a slab."""
    return 2 * -(-n // topn_slab(b, n, topk, slab))


def topn_scores(u: torch.Tensor, v: torch.Tensor, topk: int, *,
                slab: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of U @ V^T per row without the (B, N) score matrix.

    u (B, D), v (N, D) -> (values (B, topk) f32, indices (B, topk) int32),
    descending, ties to the lowest item index. On the card the catalogue is
    scored in slabs of `topn_slab(...)` items, `slab` (a test's knob) asking
    for smaller ones; each slab is one scoring and one selection launch.
    """
    n = v.shape[0]
    if not 0 < topk <= n:
        raise ValueError(f"topk must be in [1, {n}], got {topk}")
    return _topn_scores(u, v, topk, slab)


def _check_topn(u, v, topk) -> None:
    d = u.shape[1]
    if v.shape[1] != d:
        raise ValueError(f"u and v need one width, got {d} and {v.shape[1]}")
    if topk > TOPN_MAX_K:
        raise ValueError(f"topn kernel takes topk <= {TOPN_MAX_K}, got {topk}")


@torch.library.custom_op("repro_torch::topn_scores", mutates_args=())
def _topn_scores(u: torch.Tensor, v: torch.Tensor, topk: int, slab: Optional[int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`topn_scores` as one op."""
    if not _on_cuda(u):
        return ref.topn_scores_ref(u, v, topk)
    b = u.shape[0]
    n = v.shape[0]
    dev = u.device
    u = _require("u", u, dev, torch.float32)
    v = _require("v", v, dev, torch.float32)
    _check_topn(u, v, topk)
    u, v = topn_operands(u, v)
    width = topn_slab(b, n, topk, slab)
    scores = torch.empty((b, width), device=dev, dtype=torch.float32)
    best = (torch.empty((b, topk), device=dev, dtype=torch.int64)
            if n > width else None)
    vals = torch.empty((b, topk), device=dev, dtype=torch.float32)
    idx = torch.empty((b, topk), device=dev, dtype=torch.int32)
    lib = build.library("topn_scores")
    with _on_card(u):
        err = lib.topn_scores_launch(
            u.data_ptr(), v.data_ptr(), scores.data_ptr(),
            None if best is None else best.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), b, n, u.shape[1], topk, width, _stream(u),
        )
    build.check("topn_scores", err)
    _count("topn_scores")
    return vals, idx


@_topn_scores.register_fake
def _(u, v, topk, slab):
    _check_topn(u, v, topk)
    b = u.shape[0]
    return (u.new_empty((b, topk), dtype=torch.float32),
            u.new_empty((b, topk), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.topn_scores)
def _flops_topn_scores(u, v, topk, slab=None, *, out_shape=None, **kwargs) -> int:
    """2 B N K: the scores; the selection does no products."""
    return 2 * u[0] * v[0] * u[1]


#: the head widths the forward kernels are built for (112: zamba2-7b's
#: shared attention block)
FLASH_HEAD_DIMS = (32, 64, 112, 128, 256)
#: the head widths the backward kernels are built for: the forward's (112:
#: zamba2-7b's shared attention block, trained at a cut depth on one card)
FLASH_BWD_HEAD_DIMS = (32, 64, 112, 128, 256)
#: the CUDA kernel each dtype launches (csrc/flash_attention.cu), as a
#: profiler names it: bf16 on the tensor cores, fp32 on the fp32 pipes
FLASH_KERNEL_NAMES = {torch.bfloat16: "flash_mma_kernel",
                      torch.float32: "flash_kernel<float"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """(BH, S, D) attention with an online softmax: causal mask, sliding
    window (0 = none), logit softcap (0 = none), scale (None = 1/sqrt(D)).

    k and v may carry fewer heads than q (GQA): BHk must divide BH, and
    query block bh reads KV block bh // (BH // BHk). S_q and S_k may
    differ (a cross-attention: whisper's decoder against its 1,500 encoder
    frames), and a ragged S_k, causal or not, is masked: the kernel sees
    no key at or past S_k. The JAX Pallas wrapper raises for a non-causal
    S_k that is no multiple of its KV block, and the JAX chunked path pads
    such an S_k with zero keys that enter the softmax (ROADMAP.md, queue 3);
    this wrapper computes the exact softmax, as the JAX direct path does.
    On the card bf16 and fp32 take different kernels (FLASH_KERNEL_NAMES),
    both counted as one `flash_attention` launch.

    The queries sit at positions q_offset .. q_offset + S_q - 1 for the
    causal mask and the window, the keys at 0 .. S_k - 1: a shard of a
    sequence's queries against all its keys (the model under a mesh shards
    the queries over "model", `models/layers.py::attention_block`). Where
    the offset is a multiple of the kernel's query block the shard's rows
    are the whole launch's to the bit.

    With grad enabled and an input that requires it, the call goes through
    `FlashAttention`: the forward also keeps each row's log-sum-exp and the
    fp32 output, and the backward is `flash_attention_bwd`, S_q != S_k
    included. Without grad the launch is the plain forward, which writes
    neither.
    """
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    if k.shape != v.shape or k.shape[2] != d or bhk == 0 or bh % bhk:
        raise ValueError(f"k and v must be (BHk, S_k, {d}) with BHk dividing "
                         f"{bh}; got {tuple(k.shape)} and {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    args = (bool(causal), int(window), float(softcap), scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, *args, int(q_offset))
    return flash_forward(q, k, v, *args, False, int(q_offset))[0]


#: the flash pair's products, one bf16 tensor pass each over the visible
#: (query, key) pairs: QK^T and P V forward; S, dV, dP, dQ and dK backward
FLASH_FWD_PASSES, FLASH_BWD_PASSES = 2, 5


def visible_pairs(sq: int, sk: int | None = None, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0) -> int:
    """(query, key) pairs an attention of sq queries over sk keys (sk = sq
    when None) sees: all sq sk without a causal mask; with one, query q
    (at positions q_offset .. q_offset + sq - 1) sees the keys up to q, and
    with a sliding window (0 = none) at most the last `window` of them: the
    sum over q of min(q + 1, sk, window)."""
    sk = sq if sk is None else sk
    if not causal:
        return sq * sk
    cap = sk if window <= 0 else min(sk, window)

    def upto(n: int) -> int:
        # the queries 0 .. n - 1: q + 1 < cap for q < cap - 1, then cap
        ramp = min(n, cap)
        return ramp * (ramp + 1) // 2 + (n - ramp) * cap

    return upto(q_offset + sq) - upto(q_offset)


def flash_flops(bh: int, sq: int, sk: int, d: int, *, causal: bool, window: int,
                passes: int, q_offset: int = 0) -> int:
    """2 D operations a visible pair a product, over BH query heads."""
    return passes * 2 * d * bh * visible_pairs(sq, sk, causal=causal, window=window,
                                               q_offset=q_offset)


def _flash_forward(q, k, v, causal, window, softcap, scale, *, keep: bool, q_offset: int = 0):
    """One launch of the forward kernel: (out, lse, o32). With `keep` the
    kernel also writes each row's log-sum-exp (BH, S) and, for bf16, the
    fp32 output before its rounding (o32 is out itself for fp32); without
    it both are None and the kernel takes today's path. lse is (BH, S_q)."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    dev = q.device
    _check_flash(q, k, v, q_offset)
    q, k, v = (_aligned(_require(n, t, dev, q.dtype))
               for n, t in (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = o32 = None
    if keep:
        lse = torch.empty((bh, sq), device=dev, dtype=torch.float32)
        o32 = out if q.dtype == torch.float32 else torch.empty(
            q.shape, device=dev, dtype=torch.float32)
    lib = build.library("flash_attention")
    with _on_card(q):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if o32 is None or o32 is out else o32.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, bhk, sq, sk, d,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            float(softcap), scale, int(q_offset), _stream(q),
        )
    build.check("flash_attention", err)
    _count("flash_attention")
    return out, lse, o32


@torch.library.custom_op("repro_torch::flash_forward", mutates_args=())
def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: int, softcap: float, scale: float, keep: bool = True,
                  q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash forward as one dispatcher op, so that a selective
    checkpoint's policy sees it and can keep its outputs (the remat policy
    "dots", `models/transformer.py::REMAT_POLICIES`): (out, lse (BH, S_q),
    o32), the kernel's launch on the card, `ref.flash_attention_fwd_ref`
    on the CPU. o32 is empty where the output is already unrounded (fp32):
    a custom op's outputs alias nothing. Without `keep` (the no-grad
    forward: `ref.flash_attention_ref` on the CPU) lse and o32 are empty
    and the kernel writes neither. `q_offset`: the queries' first position
    (`flash_attention`)."""
    if not keep:
        if _on_cuda(q):
            out = _flash_forward(q, k, v, causal, window, softcap, scale, keep=False,
                                 q_offset=q_offset)[0]
        else:
            out = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                          softcap=softcap, scale=scale, q_offset=q_offset)
        empty = out.new_empty(0, dtype=torch.float32)
        return out, empty, empty.clone()
    if _on_cuda(q):
        out, lse, o32 = _flash_forward(q, k, v, causal, window, softcap, scale, keep=True,
                                       q_offset=q_offset)
    else:
        out, lse, o32 = ref.flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=q_offset)
    if o32 is out:
        o32 = out.new_empty(0, dtype=torch.float32)
    return out, lse, o32


def _check_flash(q, k, v, q_offset: int = 0) -> None:
    """The forward launcher's checks of types and shapes, which need no data."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.dtype not in FLASH_KERNEL_NAMES:
        raise ValueError(f"flash attention kernel takes bf16 or fp32, got {q.dtype}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {FLASH_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[2] != d or bhk == 0 or bh % bhk:
        raise ValueError(f"k and v must be (BHk, S_k, {d}) with BHk dividing "
                         f"{bh}; got {tuple(k.shape)} and {tuple(v.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError("flash attention needs at least one query and one key")


@flash_forward.register_fake
def _(q, k, v, causal, window, softcap, scale, keep=True, q_offset=0):
    _check_flash(q, k, v, q_offset)
    bh, sq, _ = q.shape
    if not keep:
        return q.new_empty(q.shape), q.new_empty(0, dtype=torch.float32), \
            q.new_empty(0, dtype=torch.float32)
    o32 = q.new_empty(q.shape if q.dtype != torch.float32 else (0,), dtype=torch.float32)
    return q.new_empty(q.shape), q.new_empty((bh, sq), dtype=torch.float32), o32


@register_flop_formula(torch.ops.repro_torch.flash_forward)
def _flops_flash_forward(q, k, v, causal, window, softcap=0.0, scale=1.0, keep=True,
                         q_offset=0, *, out_shape=None, **kwargs) -> int:
    return flash_flops(q[0], q[1], k[1], q[2], causal=causal, window=window,
                       passes=FLASH_FWD_PASSES, q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """flash_attention with a backward: the forward (`flash_forward`) keeps
    q, k, v, each row's log-sum-exp and the fp32 output (D = rowsum(dO o)
    is taken from it, not from the output rounded to bf16), and the
    backward is `flash_attention_bwd`, looked up when it runs. On the card
    both are the kernels; on the CPU the plain versions
    (`ref.flash_attention_fwd_ref`, `ref.flash_attention_bwd_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset=0):
        out, lse, o32 = flash_forward(q, k, v, causal, window, softcap, scale, True, q_offset)
        ctx.save_for_backward(q, k, v, o32 if o32.numel() else out, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, o32, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, o: torch.Tensor, *,
                        causal: bool, window: int, softcap: float, scale: float,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash_attention(q, k, v) for the output
    cotangent do, from the forward's lse (BH, S_q) and fp32 output o: one
    launch of csrc/flash_attention_bwd.cu (three kernels: D = rowsum(dO o),
    dQ a query tile a block, dK and dV a KV tile a block; no atomics; bf16
    on the tensor cores, fp32 on the fp32 pipes). q, do and o are
    (BH, S_q, D), k and v (BHk, S_k, D). The plain version
    (`ref.flash_attention_bwd_ref`) for CPU tensors; a CUDA tensor the
    kernel cannot take raises. `q_offset`: the queries' first position, as
    the forward's."""
    return _flash_attention_bwd(q, k, v, do, lse, o, causal, window, softcap, scale,
                                q_offset)


def _check_flash_bwd(q, k, v, do, lse, o, q_offset: int = 0) -> None:
    bh, sq, d = q.shape
    bhk, sk = k.shape[:2]
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.dtype not in FLASH_KERNEL_NAMES:
        raise ValueError(f"flash attention backward takes bf16 or fp32, got {q.dtype}")
    if d not in FLASH_BWD_HEAD_DIMS:
        raise ValueError(
            f"flash attention backward takes D in {FLASH_BWD_HEAD_DIMS}, got {d}: the "
            "backward kernels are not built for it")
    if k.shape != v.shape or k.shape[2] != d or bhk == 0 or bh % bhk or sk == 0:
        raise ValueError(f"k and v must be (BHk, S_k, {d}) with BHk dividing {bh} and "
                         f"S_k > 0; got {tuple(k.shape)} and {tuple(v.shape)}")
    if do.shape != q.shape or o.shape != q.shape or lse.shape != (bh, sq) or sq == 0:
        raise ValueError(f"do and o must be {tuple(q.shape)} and lse {(bh, sq)}; got "
                         f"{tuple(do.shape)}, {tuple(o.shape)}, {tuple(lse.shape)}")


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor, o: torch.Tensor, causal: bool,
                         window: int, softcap: float, scale: float, q_offset: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_bwd` as one op."""
    bh, sq, d = q.shape
    bhk, sk = k.shape[:2]
    if not _on_cuda(q):
        return ref.flash_attention_bwd_ref(q, k, v, do, lse, o, causal=causal,
                                           window=window, softcap=softcap, scale=scale,
                                           q_offset=q_offset)
    dev = q.device
    _check_flash_bwd(q, k, v, do, lse, o, q_offset)
    q, k, v, do = (_aligned(_require(n, t, dev, q.dtype))
                   for n, t in (("q", q), ("k", k), ("v", v), ("do", do)))
    o = _aligned(_require("o", o, dev, torch.float32))
    lse = _require("lse", lse, dev, torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, sq), device=dev, dtype=torch.float32)
    lib = build.library("flash_attention_bwd")
    with _on_card(q):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, bhk, sq, sk, d, int(q.dtype == torch.bfloat16),
            int(causal), int(window), float(softcap), float(scale), int(q_offset),
            _stream(q),
        )
    build.check("flash_attention_bwd", err)
    _count("flash_attention_bwd")
    return dq, dk, dv


@_flash_attention_bwd.register_fake
def _(q, k, v, do, lse, o, causal, window, softcap, scale, q_offset=0):
    _check_flash_bwd(q, k, v, do, lse, o, q_offset)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flops_flash_bwd(q, k, v, do, lse, o, causal, window, softcap=0.0, scale=1.0,
                     q_offset=0, *, out_shape=None, **kwargs) -> int:
    return flash_flops(q[0], q[1], k[1], q[2], causal=causal, window=window,
                       passes=FLASH_BWD_PASSES, q_offset=q_offset)


def _flash_strategies(n_in: int, n_out: int) -> list:
    """The flash pair's DTensor strategies over one mesh axis: every tensor
    replicated, or every tensor sharded on its batch-heads dim (K and V's
    BHk with Q's BH: a query head's group stays on its rank where the axis
    divides BHk). The sequence shards outside the op: a rank's queries
    need their offset in the sequence, which is an argument of the op
    (`q_offset`) and the same on every rank, so the model shards them in
    a local_map region (`models/layers.py::attention_block`)."""
    from torch.distributed.tensor import Replicate, Shard

    return [([Replicate()] * n_out, [Replicate()] * n_in),
            ([Shard(0)] * n_out, [Shard(0)] * n_in)]


def _register_flash_sharding() -> None:
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_forward.default)
    def _(q, k, v, causal, window, softcap, scale, keep=True, q_offset=0):
        return [(out, ins + [None] * 6) for out, ins in _flash_strategies(3, 3)]

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _(q, k, v, do, lse, o, causal, window, softcap, scale, q_offset=0):
        return [(out, ins + [None] * 5) for out, ins in _flash_strategies(6, 3)]


_register_flash_sharding()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself where its data starts on 16 bytes (the kernel's vector
    loads), else a fresh copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
