"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, in the same arithmetic
where the order matters: the wrappers in `ops.py` run these for tensors on
the CPU, the CPU tests hold them against the JAX package, and the chip
smoke test holds each kernel against its plain version on the card. They
are references, not a fallback: a CUDA tensor never reaches them through
the wrappers.
"""
from __future__ import annotations

import math

import torch


def _syrk_in_order(gm_at, g_at, rv_at, width: int, shape, k: int, device,
                   out: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """sum_w gm_w g_w^T and sum_w gm_w rv_w over w = 0 .. width - 1, in that
    order, in float64, rounded once to `out`: the syrk kernels' arithmetic.

    gm_at(w), g_at(w) give the (..., K) vectors of step w and rv_at(w) the
    (...,) weights. The product of two fp32 values is exact in float64, so
    each step adds the exact product and the kernels' fused multiply-add
    gives the same bits. Each entry is summed on its own, in w order,
    whatever K is: zero columns leave the kept block's bits unchanged.
    """
    prec = torch.zeros(tuple(shape) + (k, k), dtype=torch.float64, device=device)
    rhs = torch.zeros(tuple(shape) + (k,), dtype=torch.float64, device=device)
    for w in range(width):
        a, b = gm_at(w).double(), g_at(w).double()
        prec.addcmul_(a[..., :, None], b[..., None, :])
        rhs.addcmul_(a, rv_at(w).double()[..., None])
    return prec.to(out), rhs.to(out)


def segment_sums_in_order(rows: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                          *, stacked: bool = False) -> torch.Tensor:
    """Per-segment sums of rows whose dense segment ids are nondecreasing,
    each segment's rows added in row order from zero: the order of the
    kernel's segment pass. (index_add_ is atomic on the card, and an fp64
    sum in another order can round to another fp32.) Step j adds the j-th
    row of every segment that has one; visited longest first, the
    segments of a step are a prefix. `stacked`: a leading draw axis
    precedes the row axis."""
    axis = 1 if stacked else 0
    lengths = torch.bincount(seg_ids.long(), minlength=n_segments)
    starts = torch.cumsum(lengths, 0) - lengths
    order = torch.argsort(lengths, descending=True, stable=True)
    starts = starts[order]
    ascending = lengths[order].flip(0).cpu()
    steps = int(ascending[-1]) if n_segments else 0
    active = n_segments - torch.searchsorted(ascending, torch.arange(steps), right=True)
    shape = list(rows.shape)
    shape[axis] = n_segments
    acc = rows.new_zeros(shape)
    for j, count in enumerate(active.tolist()):
        acc.narrow(axis, 0, count).add_(rows.index_select(axis, starts[:count] + j))
    return torch.empty_like(acc).index_copy_(axis, order, acc)


def masked_syrk_ref(vm: torch.Tensor, rv: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """vm (R, W, K) pre-masked gathered factors, rv (R, W) masked ratings
    -> prec (R, K, K) = vm^T vm and rhs (R, K) = rv @ vm per row, summed
    over W in order in float64 and rounded once (`_syrk_in_order`)."""
    r, w, k = vm.shape
    out = torch.promote_types(vm.dtype, torch.float32)
    return _syrk_in_order(lambda i: vm[:, i], lambda i: vm[:, i], lambda i: rv[:, i],
                          w, (r,), k, vm.device, out)


def gather_syrk_seg_ref(
    indices: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
    seg_ids: torch.Tensor, n_segments: int, v: torch.Tensor, *,
    bf16_gather: bool = False, identity_segments: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum m v v^T, sum m r v) with v = V[indices[r, w]].

    v is (N, K) or a stack of draws (S, N, K); the outputs carry the
    leading draw axis iff v does. With bf16_gather the factors are rounded
    to bf16 before the products. Rows are summed over W in order in
    float64 (`_syrk_in_order`), then into their segments in float64, and
    rounded once, as the kernel does (`segment_sums_in_order`); the
    outputs are fp32 (float64 for float64 inputs, the chip smoke test's
    exact yardstick).
    """
    stacked = v.dim() == 3
    if bf16_gather:
        v = v.to(torch.bfloat16)
    out = torch.promote_types(v.dtype, torch.float32)
    idx = indices.long()
    r, w = idx.shape
    rv = values * mask

    def g_at(i):
        return v[:, idx[:, i]] if stacked else v[idx[:, i]]        # (..., R, K)

    def gm_at(i):
        # masked before the products, in the gather's dtype
        return (g_at(i) * mask[:, i, None].to(v.dtype)).to(out)

    lead = (v.shape[0], r) if stacked else (r,)
    prec_rows, rhs_rows = _syrk_in_order(gm_at, lambda i: g_at(i).to(out),
                                         lambda i: rv[:, i].to(out), w, lead,
                                         v.shape[-1], v.device, torch.float64)
    if identity_segments:
        return prec_rows.to(out), rhs_rows.to(out)
    prec = segment_sums_in_order(prec_rows, seg_ids, n_segments, stacked=stacked)
    rhs = segment_sums_in_order(rhs_rows, seg_ids, n_segments, stacked=stacked)
    return prec.to(out), rhs.to(out)


def gather_syrk_seg_into_ref(
    indices: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
    seg_ids: torch.Tensor, n_segments: int, v: torch.Tensor,
    prec_all: torch.Tensor, rhs_all: torch.Tensor, item_ids: torch.Tensor,
    lam: torch.Tensor, prior_rhs: torch.Tensor, alpha: float, *,
    bf16_gather: bool = False, identity_segments: bool = False,
) -> None:
    """`gather_syrk_seg_ref` of one draw of v, stored as posterior systems:
    segment p's sums (S, s) go to item item_ids[p] of prec_all (n_items, K,
    K) and rhs_all (n_items, K) as lam + alpha * S and prior_rhs + alpha *
    s, the kept K x K block where v is padded to a larger rank. alpha * S
    and the sum are each rounded, as the sweep's `prec_all[ids] += alpha *
    prec` rounds them on buffers that hold the prior. Writes nothing else."""
    k = prec_all.shape[-1]
    prec, rhs = gather_syrk_seg_ref(indices, values, mask, seg_ids, n_segments, v,
                                    bf16_gather=bf16_gather,
                                    identity_segments=identity_segments)
    prec_all[item_ids] = lam + alpha * prec[..., :k, :k]
    rhs_all[item_ids] = prior_rhs + alpha * rhs[..., :k]


#: what chol_solve_sample gives for a system that is not positive definite
INDEFINITE = ("clamp", "nan")


def chol_solve_sample_ref(prec: torch.Tensor, rhs: torch.Tensor,
                          z: torch.Tensor, indefinite: str = "clamp") -> torch.Tensor:
    """Batched x = Lambda^-1 rhs + L^-T z with Lambda = L L^T.

    Column-by-column Cholesky with the diagonal clamped at 1e-20, then
    L y = rhs and one L^T x = y + z: the arithmetic of the reference kernel
    (`repro/kernels/chol_solve.py`), so under "clamp" a system that is not
    positive definite gives what that kernel gives and never raises. Under
    "nan" a system with a pivot that is not > 0 (NaN included) gives a row
    of NaN, as a Cholesky that fails gives; the others are the same bits.
    """
    if indefinite not in INDEFINITE:
        raise ValueError(f"indefinite must be one of {INDEFINITE}, got {indefinite!r}")
    a = prec.float()
    b = rhs.float()
    bsz, k, _ = a.shape
    pos = torch.arange(k, device=a.device)
    chol = torch.zeros_like(a)
    bad = torch.zeros(bsz, dtype=torch.bool, device=a.device)
    for j in range(k):
        s = torch.einsum("bik,bk->bi", chol, chol[:, j, :])
        col = a[:, :, j] - s
        bad |= ~(col[:, j] > 0)
        dj = torch.sqrt(torch.clamp(col[:, j], min=1e-20))
        chol[:, :, j] = torch.where(pos[None, :] >= j, col / dj[:, None], 0.0)
    y = torch.zeros_like(b)
    for j in range(k):
        lrow = torch.where(pos[None, :] < j, chol[:, j, :], 0.0)
        y[:, j] = (b[:, j] - (lrow * y).sum(-1)) / chol[:, j, j]
    y = y + z.float()
    x = torch.zeros_like(b)
    for j in range(k - 1, -1, -1):
        lcol = torch.where(pos[None, :] > j, chol[:, :, j], 0.0)
        x[:, j] = (y[:, j] - (lcol * x).sum(-1)) / chol[:, j, j]
    if indefinite == "nan":
        x = x.masked_fill(bad[:, None], float("nan"))
    return x


def topn_scores_ref(u: torch.Tensor, v: torch.Tensor, topk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of U @ V^T per row, ties to the lowest item index.

    The scores are summed over the contraction axis in order, one rounded
    multiply and one rounded add per term, which is the kernel's order, so
    the two agree bit for bit. Returns (values (B, topk) f32, indices
    (B, topk) int32).
    """
    u = u.float()
    v = v.float()
    scores = torch.zeros((u.shape[0], v.shape[0]), device=u.device)
    for d in range(u.shape[1]):
        scores += u[:, d, None] * v[None, :, d]
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :topk], idx[:, :topk].to(torch.int32)


def _attention_scores(q, k, *, causal, window, softcap, scale, work, q_offset=0):
    """The scores of q (BH, S, D) against k (BHk, S, D), GQA-expanded, in
    `work`: (scaled and capped scores, t = tanh(s / softcap) or None, the
    visibility mask). Query i is at position q_offset + i, key j at j."""
    bh, sq, d = q.shape
    rep = bh // k.shape[0]
    k = k.to(work).repeat_interleave(rep, dim=0) if rep > 1 else k.to(work)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.to(work), k) * scale
    t = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return s, t, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Direct softmax attention in fp32: q (BH, Sq, D), k and v (BHk, Sk, D)
    with BHk dividing BH (query block bh reads KV block bh // (BH // BHk))
    -> (BH, Sq, D) in q's dtype. The queries sit at positions q_offset ..
    q_offset + Sq - 1 for the causal mask and the window (a shard of a
    sequence's queries against all its keys).

    The scale comes before the softcap and the softcap before the mask;
    masked scores are -1e30, as in `repro/kernels/ref.py`.
    """
    s, _, mask = _attention_scores(q, k, causal=causal, window=window, softcap=softcap,
                                   scale=scale, work=torch.float32, q_offset=q_offset)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    rep = q.shape[0] // k.shape[0]
    v = v.float().repeat_interleave(rep, dim=0) if rep > 1 else v.float()
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None,
                            q_offset: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward that a backward needs: (out in q's dtype, lse (BH, S_q)
    and the unrounded output (BH, S_q, D)), computed in fp32 (float64 for
    float64 inputs). lse is each row's log-sum-exp of its visible scores,
    which the kernel writes as m + log(l); every row sees at least one key
    (its own where q_offset + S_q <= S_k, all S_k without causality)."""
    work = torch.promote_types(q.dtype, torch.float32)
    s, _, mask = _attention_scores(q, k, causal=causal, window=window, softcap=softcap,
                                   scale=scale, work=work, q_offset=q_offset)
    s = torch.where(mask, s, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)          # flash_attention_ref's arithmetic
    rep = q.shape[0] // k.shape[0]
    v = v.to(work).repeat_interleave(rep, dim=0) if rep > 1 else v.to(work)
    o = torch.einsum("bqk,bkd->bqd", p, v)
    return o.to(q.dtype), lse, o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, o: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None,
                            q_offset: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash attention, each in its input's
    dtype, from the forward's lse and unrounded output o, in fp32 (float64
    for float64 inputs), in the backward kernel's order:

        s' = softcap(scale q k^T)       P = exp(s' - lse), 0 where masked
        dV = P^T dO     dP = dO V^T     D = rowsum(dO o)
        dS' = P (dP - D)                dS = dS' (1 - (s'/c)^2) with a softcap c
        dQ = scale dS K                 dK = scale dS^T Q

    With GQA (BHk < BH) dK and dV are summed over each KV head's query
    heads bh = hk * rep .. hk * rep + rep - 1, in head order.
    """
    work = torch.promote_types(q.dtype, torch.float32)
    bh, sq, d = q.shape
    bhk = k.shape[0]
    rep = bh // bhk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, t, mask = _attention_scores(q, k, causal=causal, window=window, softcap=softcap,
                                   scale=scale, work=work, q_offset=q_offset)
    p = torch.where(mask, torch.exp(s - lse.to(work)[..., None]), 0.0)
    del s
    dof = do.to(work)
    ke = k.to(work).repeat_interleave(rep, dim=0) if rep > 1 else k.to(work)
    ve = v.to(work).repeat_interleave(rep, dim=0) if rep > 1 else v.to(work)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, ve)
    delta = (dof * o.to(work)).sum(-1)
    ds = p * (dp - delta[..., None])
    del p, dp
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, ke)
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.to(work))

    def by_group(x):
        if rep == 1:
            return x
        x = x.reshape(bhk, rep, *x.shape[1:])
        out = x[:, 0]
        for r in range(1, rep):
            out = out + x[:, r]
        return out

    return dq.to(q.dtype), by_group(dk).to(k.dtype), by_group(dv).to(v.dtype)
