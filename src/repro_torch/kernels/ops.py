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
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

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
    if not _on_cuda(v):
        return ref.gather_syrk_seg_ref(
            indices, values, mask, seg_ids, n_segments, v,
            bf16_gather=bf16_gather, identity_segments=identity_segments,
        )
    dev = v.device
    stacked = v.dim() == 3
    k = v.shape[-1]
    kp = kernel_rank(k)
    # one copy of V per call where the rank is not instantiated; the sampler
    # pads V once per half-sweep instead (core/gibbs.py::posterior_systems)
    vs = pad_rank(v if stacked else v[None], kp)
    s, n, _ = vs.shape
    if v.dtype != torch.float32:
        raise ValueError(f"v must be float32, got {v.dtype}")
    indices = _require("indices", indices, dev, torch.int32)
    values = _require("values", values, dev, torch.float32)
    mask = _require("mask", mask, dev, torch.float32)
    seg_ids = _require("seg_ids", seg_ids, dev, torch.int32)
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
    vk = _aligned((vs.to(torch.bfloat16) if bf16_gather else vs).contiguous())
    if identity_segments:
        # the kernel writes each row's statistics straight into the output
        prec = torch.empty((s, r, kp, kp), device=dev, dtype=torch.float32)
        rhs = torch.empty((s, r, kp), device=dev, dtype=torch.float32)
        rows_prec = rows_rhs = ptr = None
    else:
        seg_ptr = _require("seg_ptr", seg_ptr, dev, torch.int32)
        if seg_ptr.shape != (n_segments + 1,):
            raise ValueError(f"seg_ptr must have {n_segments + 1} entries")
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
    if not _on_cuda(vm):
        return ref.masked_syrk_ref(vm, rv)
    dev = vm.device
    r, w, k = vm.shape
    kp = kernel_rank(k)
    if r == 0:
        raise ValueError("masked_syrk needs at least one row")
    if rv.shape != (r, w):
        raise ValueError(f"rv must be {(r, w)}, got {tuple(rv.shape)}")
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


def chol_solve_sample(prec: torch.Tensor, rhs: torch.Tensor, z: torch.Tensor
                      ) -> torch.Tensor:
    """Batched x = Lambda^-1 rhs + L^-T z over any leading axes.

    The kernel takes the batch as it is. A rank the kernel is not
    instantiated for is padded with an identity block (`pad_rank_systems`):
    a zero-padded precision matrix is singular.
    """
    if prec.dim() > 3:
        lead = prec.shape[:-2]
        out = chol_solve_sample(prec.reshape((-1,) + prec.shape[-2:]),
                                rhs.reshape((-1, rhs.shape[-1])),
                                z.reshape((-1, z.shape[-1])))
        return out.reshape(lead + out.shape[1:])
    if not _on_cuda(prec):
        return ref.chol_solve_sample_ref(prec, rhs, z)
    dev = prec.device
    bsz, k, _ = prec.shape
    kp = kernel_rank(k)
    prec = _require("prec", prec, dev, torch.float32)
    rhs = _require("rhs", rhs, dev, torch.float32)
    z = _require("z", z, dev, torch.float32)
    if rhs.shape != (bsz, k) or z.shape != (bsz, k):
        raise ValueError("rhs and z must be (B, K)")
    if bsz == 0:
        raise ValueError("chol_solve_sample needs at least one system")
    prec, rhs, z = (_aligned(x) for x in pad_rank_systems(prec, rhs, z, kp))
    out = torch.empty((bsz, kp), device=dev, dtype=torch.float32)
    lib = build.library("chol_solve_sample")
    with _on_card(prec):
        err = lib.chol_solve_sample_launch(
            prec.data_ptr(), rhs.data_ptr(), z.data_ptr(), out.data_ptr(),
            bsz, kp, _stream(prec),
        )
    build.check("chol_solve_sample", err)
    _count("chol_solve_sample")
    return out if kp == k else out[:, :k].contiguous()


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
    b, d = u.shape
    n = v.shape[0]
    if not 0 < topk <= n:
        raise ValueError(f"topk must be in [1, {n}], got {topk}")
    if not _on_cuda(u):
        return ref.topn_scores_ref(u, v, topk)
    dev = u.device
    u = _require("u", u, dev, torch.float32)
    v = _require("v", v, dev, torch.float32)
    if v.shape[1] != d:
        raise ValueError(f"u and v need one width, got {d} and {v.shape[1]}")
    if topk > TOPN_MAX_K:
        raise ValueError(f"topn kernel takes topk <= {TOPN_MAX_K}, got {topk}")
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


FLASH_HEAD_DIMS = (32, 64, 128, 256)  # the head widths the kernels are built for
#: the CUDA kernel each dtype launches (csrc/flash_attention.cu), as a
#: profiler names it: bf16 on the tensor cores, fp32 on the fp32 pipes
FLASH_KERNEL_NAMES = {torch.bfloat16: "flash_mma_kernel",
                      torch.float32: "flash_kernel<float"}


def _flash_block(s: int) -> int:
    """The JAX wrapper's KV block for a sequence of s keys."""
    return min(128, max(16, s))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """(BH, S, D) attention with an online softmax: causal mask, sliding
    window (0 = none), logit softcap (0 = none), scale (None = 1/sqrt(D)).

    k and v may carry fewer heads than q (GQA): BHk must divide BH, and
    query block bh reads KV block bh // (BH // BHk). A ragged S is masked.
    Raises ValueError where the JAX wrapper does: without causality, S_k
    must be a multiple of its KV block, min(128, max(16, S_k)). On the card
    bf16 and fp32 take different kernels (FLASH_KERNEL_NAMES), both counted
    as one `flash_attention` launch.

    With grad enabled and an input that requires it, the call goes through
    `FlashAttention`: the forward also keeps each row's log-sum-exp and the
    fp32 output, and the backward is `flash_attention_bwd`. Without grad
    the launch is the plain forward, which writes neither.
    """
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    if not causal and sk % _flash_block(sk):
        raise ValueError("non-causal flash path requires S_k % block == 0")
    if k.shape != v.shape or k.shape[2] != d or bhk == 0 or bh % bhk:
        raise ValueError(f"k and v must be (BHk, S_k, {d}) with BHk dividing "
                         f"{bh}; got {tuple(k.shape)} and {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    args = (bool(causal), int(window), float(softcap), scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if sq != sk:
            raise ValueError(f"the flash backward takes S_q == S_k, got {sq} and {sk}")
        return FlashAttention.apply(q, k, v, *args)
    if not _on_cuda(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    return _flash_forward(q, k, v, *args, keep=False)[0]


def _flash_forward(q, k, v, causal, window, softcap, scale, *, keep: bool):
    """One launch of the forward kernel: (out, lse, o32). With `keep` the
    kernel also writes each row's log-sum-exp (BH, S) and, for bf16, the
    fp32 output before its rounding (o32 is out itself for fp32); without
    it both are None and the kernel takes today's path."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    dev = q.device
    if q.dtype not in FLASH_KERNEL_NAMES:
        raise ValueError(f"flash attention kernel takes bf16 or fp32, got {q.dtype}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {FLASH_HEAD_DIMS}, got {d}")
    if sq == 0 or sk == 0:
        raise ValueError("flash attention needs at least one query and one key")
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
            float(softcap), scale, _stream(q),
        )
    build.check("flash_attention", err)
    _count("flash_attention")
    return out, lse, o32


class FlashAttention(torch.autograd.Function):
    """flash_attention with a backward: the forward keeps q, k, v, each
    row's log-sum-exp and the fp32 output (D = rowsum(dO o) is taken from
    it, not from the output rounded to bf16), and the backward is
    `flash_attention_bwd`, looked up when it runs. On the card both are
    the kernels; on the CPU the plain versions (`ref.flash_attention_fwd_ref`,
    `ref.flash_attention_bwd_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        if _on_cuda(q):
            out, lse, o32 = _flash_forward(q, k, v, causal, window, softcap, scale,
                                           keep=True)
        else:
            out, lse, o32 = ref.flash_attention_fwd_ref(
                q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, o32, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, o: torch.Tensor, *,
                        causal: bool, window: int, softcap: float, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash_attention(q, k, v) for the output
    cotangent do, from the forward's lse (BH, S) and fp32 output o: one
    launch of csrc/flash_attention_bwd.cu (three kernels: D = rowsum(dO o),
    dQ a query tile a block, dK and dV a KV tile a block; no atomics; bf16
    on the tensor cores, fp32 on the fp32 pipes). S_q must equal S_k. The plain version (`ref.flash_attention_bwd_ref`) for
    CPU tensors; a CUDA tensor the kernel cannot take raises."""
    bh, s, d = q.shape
    bhk = k.shape[0]
    if not _on_cuda(q):
        return ref.flash_attention_bwd_ref(q, k, v, do, lse, o, causal=causal,
                                           window=window, softcap=softcap, scale=scale)
    dev = q.device
    if q.dtype not in FLASH_KERNEL_NAMES:
        raise ValueError(f"flash attention backward takes bf16 or fp32, got {q.dtype}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash attention backward takes D in {FLASH_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[1:] != (s, d) or bhk == 0 or bh % bhk:
        raise ValueError(f"k and v must be (BHk, {s}, {d}) with BHk dividing {bh}; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if do.shape != q.shape or o.shape != q.shape or lse.shape != (bh, s) or s == 0:
        raise ValueError(f"do and o must be {tuple(q.shape)} and lse {(bh, s)}; got "
                         f"{tuple(do.shape)}, {tuple(o.shape)}, {tuple(lse.shape)}")
    q, k, v, do = (_aligned(_require(n, t, dev, q.dtype))
                   for n, t in (("q", q), ("k", k), ("v", v), ("do", do)))
    o = _aligned(_require("o", o, dev, torch.float32))
    lse = _require("lse", lse, dev, torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, s), device=dev, dtype=torch.float32)
    lib = build.library("flash_attention_bwd")
    with _on_card(q):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, bhk, s, d, int(q.dtype == torch.bfloat16),
            int(causal), int(window), float(softcap), float(scale), _stream(q),
        )
    build.check("flash_attention_bwd", err)
    _count("flash_attention_bwd")
    return dq, dk, dv


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself where its data starts on 16 bytes (the kernel's vector
    loads), else a fresh copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
