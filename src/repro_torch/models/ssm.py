"""xLSTM blocks, ported from `repro/models/ssm.py`: the chunk-parallel mLSTM
(matrix memory), the sequential sLSTM, and the xLSTM model of groups of
(slstm_every - 1) mLSTM blocks and one sLSTM block.

The mLSTM forward is the stabilized chunkwise-parallel form: within a chunk
an attention-like product, across chunks a small recurrent state (C: hd x hd
matrix memory, n: hd normalizer, m: scalar stabilizer) carried in a Python
loop where the JAX package scans. The step-by-step sequential form is the
decode path and the oracle of the chunked one. The sLSTM is a per-timestep
recurrence in plain PyTorch, the port of a `lax.scan`: no Pallas kernel
stands behind it, and no kernel of the port runs in this module.

Parameters keep the JAX layout and names; the JAX package's stacked leaves
(`mlstm` (G, n_m, ...), `slstm` (G, ...)) are nested `ModuleList`s here, so
`mlstm.1.3.w_up` is slice [1, 3] of the leaf `mlstm/w_up`
(`models/api.py::params_from_numpy`). The gate weights and biases
(`w_if`, `b_if`, `w_gates`, `r_gates`, `b_gates`) are fp32 in every config,
and their products are fp32 x fp32 (TF32 stays off on the card). Decode
states keep the JAX layout and are updated in place: the states passed in
are consumed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.cost import steps
from repro_torch.models.layers import (
    ModelConfig,
    Part,
    activation_spec,
    constrain,
    dense_init,
    in_region,
    join,
    matmul_f32,
    rms_norm,
    seq_region,
    state_part,
    state_region,
    whole,
    write,
)
from repro_torch.models.transformer import (
    RMSNorm,
    checkpointed,
    final_logits,
    remat_on,
    sharded_embed,
)

#: the mLSTM chunk xlstm_forward uses, whatever `cfg.ssm_chunk` says (the
#: JAX package's `xlstm_forward(..., chunk=64)`, which its model never
#: overrides)
MLSTM_CHUNK = 64
#: the stabilizer's "minus infinity" and the gate-neutral padding values
NEG = -1e30
F_PAD = 1e9


def work(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in float64 where it is float64: the recurrences run in
    fp32, and a float64 oracle of them in float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, dk, dv) matrix memory
    n: torch.Tensor   # (B, H, dk) normalizer
    m: torch.Tensor   # (B, H) stabilizer


def mlstm_init_state(batch: int, heads: int, dk: int, dv: int, *,
                     device: torch.device | str = "cpu") -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((batch, heads, dk, dv), device=device),
        n=torch.zeros((batch, heads, dk), device=device),
        m=torch.full((batch, heads), NEG, device=device),
    )


def mlstm_sequential(q, k, v, i_raw, f_raw, state: MLSTMState
                     ) -> tuple[torch.Tensor, MLSTMState]:
    """Oracle and decode path: the exact recurrence, one step a position
    (`mlstm_step` on the whole state).

    q, k, v: (B, S, H, d); i_raw, f_raw: (B, S, H) fp32. Returns (h (B, S,
    H, d) fp32, state); float64 inputs and state run in float64."""
    q, k, v = (work(t) for t in (q, k, v))
    c, n, m = state
    hs = []
    for t in range(q.shape[1]):
        ht, (c, n, m) = mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t],
                                   whole(c), whole(n), whole(m))
        hs.append(ht)
    return torch.stack(hs, dim=1), MLSTMState(c, n, m)


def mlstm_step(qt, kt, vt, it, ft, c: Part, n: Part, m: Part
               ) -> tuple[torch.Tensor, MLSTMState]:
    """The stabilized mLSTM of one position (qt, kt, vt (B, H, d), the gates
    it, ft (B, H)) from a state given as `Part`s: the whole state, or under
    a mesh the rank's pieces of it. Each piece's new value comes from the
    slices of k, v and the gates it covers, and the output's sums over
    the pieces (the numerator over C's, the denominator over n's, the
    stabilizer m itself) are joined over SEQ_AXIS (`join`): a gather where
    a piece is some heads, an all-reduce where it is some of dk. Returns
    (h (B, H, d) in fp32, the pieces' new values); nothing is written."""
    d = qt.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (work(t) for t in (qt, kt, vt))
    logf = F.logsigmoid(ft)
    m_old = join(m.local, m.sl, tuple(it.shape), m.reduce)
    m_new = torch.maximum(logf + m_old, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m_old - m_new)
    cb, ch, ck, cv = c.sl
    c_new = f_p[cb, ch][..., None, None] * c.local + i_p[cb, ch][..., None, None] * (
        kt[cb, ch, ck][..., :, None] * scale * vt[cb, ch, cv][..., None, :])
    nb, nh, nk = n.sl
    n_new = f_p[nb, nh][..., None] * n.local + i_p[nb, nh][..., None] * kt[nb, nh, nk] * scale
    num = join(torch.einsum("bhkv,bhk->bhv", c_new, qt[cb, ch, ck]), (cb, ch, cv),
               tuple(vt.shape), c.reduce)
    den = join(torch.einsum("bhk,bhk->bh", n_new, qt[nb, nh, nk]), (nb, nh),
               tuple(it.shape), n.reduce)
    denom = torch.maximum(den.abs(), torch.exp(-m_new))
    return num / denom[..., None], MLSTMState(c_new, n_new, m_new[m.sl])


def mlstm_chunked(q, k, v, i_raw, f_raw, state: MLSTMState, *, chunk: int = MLSTM_CHUNK
                  ) -> tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel stabilized mLSTM; the signature of
    `mlstm_sequential`. A sequence that is no multiple of `chunk` is padded
    gate-neutrally (i -> -1e30: no input; f -> 1e9: log-sigmoid 0, no
    decay), so the pad steps leave the carried state as it was."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    q, k, v = (work(t) for t in (q, k, v))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=F_PAD)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    c, n, m = state
    out = []
    loop = steps(nc)
    for j in loop:
        sl = slice(j * chunk, (j + 1) * chunk)
        qb, kb, vb, ib, fb = q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl], f_raw[:, sl]
        logf = F.logsigmoid(fb)                                  # (B, L, H)
        fcum = torch.cumsum(logf, dim=1)                         # inclusive
        # intra-chunk exponent D[t, s] = F_t - F_s + logi_s, s <= t
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ib[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, NEG)    # (B, T, S, H)
        inter_b = fcum + m[:, None, :]                           # (B, T, H)
        m_new = torch.maximum(inter_b, dmat.amax(dim=2))
        w = torch.exp(dmat - m_new[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * scale * w
        inter_scale = torch.exp(inter_b - m_new)                 # (B, T, H)
        numer = torch.einsum("btsh,bshd->bthd", scores, vb) + inter_scale[..., None] * (
            torch.einsum("bthk,bhkv->bthv", qb, c))
        denom = scores.sum(dim=2) + inter_scale * torch.einsum("bthk,bhk->bth", qb, n)
        out.append(numer / torch.maximum(denom.abs(), torch.exp(-m_new))[..., None])
        # the carry to the end of the chunk
        f_all = fcum[:, -1, :]                                   # (B, H)
        dec_exp = f_all[:, None, :] - fcum + ib                  # (B, S, H)
        m_next = torch.maximum(f_all + m, dec_exp.amax(dim=1))
        wgt = torch.exp(dec_exp - m_next[:, None, :])
        ks = kb * scale
        carry = torch.exp(f_all + m - m_next)
        # sum_s wgt_s (k_s scale) v_s^T, as one product over the chunk
        c = carry[..., None, None] * c + torch.einsum("bshk,bshv->bhkv",
                                                      wgt[..., None] * ks, vb)
        n = carry[..., None] * n + torch.einsum("bsh,bshk->bhk", wgt, ks)
        m = m_next
    return torch.cat(loop.full(out), dim=1)[:, :s], MLSTMState(c, n, m)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------
def _weight(generator, shape, dtype, device, scale=None) -> nn.Parameter:
    return nn.Parameter(dense_init(generator, shape, dtype, device, scale=scale))


class MLSTMBlock(nn.Module):
    """An mLSTM block's parameters (`init_mlstm_block`'s); the arithmetic
    is `mlstm_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, h, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
        self.ln = RMSNorm(cfg, device=device)
        self.w_up = _weight(generator, (d, 2 * d), pd, device)
        self.conv = _weight(generator, (cfg.ssm_conv, d), pd, device, scale=0.3)
        self.wq = _weight(generator, (d, d), pd, device)
        self.wk = _weight(generator, (d, d), pd, device)
        self.wv = _weight(generator, (d, d), pd, device)
        self.w_if = _weight(generator, (d, 2 * h), torch.float32, device, scale=0.01)
        self.b_if = nn.Parameter(torch.cat([
            torch.zeros(h, device=device), torch.full((h,), 3.0, device=device)]))
        self.gn = nn.Parameter(torch.zeros(d, dtype=pd, device=device))
        self.w_down = _weight(generator, (d, d), pd, device)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv. x: (B, S, C), w: (W, C); returns (y, new
    cache). The W taps are summed in fp32 in tap order and the sum cast
    to x's dtype once. cache: (B, W - 1, C), the trailing context of a
    decode step; without it the sequence starts from zeros and no cache
    comes back."""
    width, s = w.shape[0], x.shape[1]
    if cache is not None:
        xin = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xin[:, -(width - 1):] if width > 1 else cache
    else:
        xin = F.pad(x, (0, 0, width - 1, 0))
        new_cache = None
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xin[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype), new_cache


def conv_step(x: torch.Tensor, w: torch.Tensor, cache: Part
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """`causal_conv1d` of one position x (B, 1, C) from the rank's piece of
    its cache (B, W - 1, C) under a mesh: the depthwise taps on the piece's
    channels (each channel is its own, so the piece's are the whole's
    bits), the output joined over the channels (`join`). Returns (y, the
    piece's new value); nothing is written."""
    b, _, ch = cache.sl
    y, new = causal_conv1d(x[b, :, ch], w[:, ch], cache.local)
    return join(y, (b, slice(None), ch), tuple(x.shape), cache.reduce), new


def mlstm_block(p: MLSTMBlock, x: torch.Tensor, cfg: ModelConfig,
                state: MLSTMState | None, conv_cache: torch.Tensor | None = None, *,
                chunk: int = MLSTM_CHUNK, parts: tuple[Part, ...] | None = None
                ) -> tuple[torch.Tensor, MLSTMState, torch.Tensor | None]:
    """x: (B, S, D). Returns (out, new state, new conv cache): one position
    takes the sequential form, a sequence the chunked one. With `parts`
    ((c, n, m, conv) `Part`s: a decode step under a mesh) one position
    takes `mlstm_step` and `conv_step` on the rank's pieces, which are
    written in place, and no state comes back."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin = rms_norm(x, p.ln.scale, cfg.norm_eps)
    up = xin @ p.w_up.to(cfg.dtype)
    xm, z = up.chunk(2, dim=-1)
    if parts is not None:
        xc, new_conv = conv_step(xm, p.conv, parts[3])
    else:
        xc, new_conv = causal_conv1d(xm, p.conv, conv_cache)
    xc = F.silu(xc)
    q = (xc @ p.wq.to(cfg.dtype)).reshape(b, s, h, hd)
    k = (xc @ p.wk.to(cfg.dtype)).reshape(b, s, h, hd)
    v = (xm @ p.wv.to(cfg.dtype)).reshape(b, s, h, hd)
    gates = xm.float() @ p.w_if + p.b_if
    i_raw, f_raw = gates.reshape(b, s, 2, h).unbind(dim=2)

    if state is None and parts is None:
        state = mlstm_init_state(b, h, hd, hd, device=x.device)
    if parts is not None:
        ht, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0],
                                   *parts[:3])
        write(parts, (*new_state, new_conv))
        ht, new_state, new_conv = ht[:, None], None, None
    elif s == 1:
        ht, new_state = mlstm_sequential(q, k, v, i_raw, f_raw, state)
    else:
        ht, new_state = mlstm_chunked(q, k, v, i_raw, f_raw, state, chunk=chunk)
    ht = ht.reshape(b, s, d).to(cfg.dtype)
    ht = rms_norm(ht, p.gn, cfg.norm_eps)           # group-norm stand-in
    out = (ht * F.silu(z)) @ p.w_down.to(cfg.dtype)
    return out, new_state, new_conv


# ---------------------------------------------------------------------------
# sLSTM block (sequential scalar memory with exponential gating)
# ---------------------------------------------------------------------------
class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H, hd)
    h: torch.Tensor   # (B, H, hd)


def slstm_init_state(batch: int, heads: int, hd: int, *,
                     device: torch.device | str = "cpu") -> SLSTMState:
    z = torch.zeros((batch, heads, hd), device=device)
    return SLSTMState(c=z, n=z.clone(), m=torch.full_like(z, NEG), h=z.clone())


class SLSTMBlock(nn.Module):
    """An sLSTM block's parameters (`init_slstm_block`'s); the arithmetic
    is `slstm_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, h, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
        hd = d // h
        self.ln = RMSNorm(cfg, device=device)
        self.w_gates = _weight(generator, (d, 4 * d), torch.float32, device, scale=0.02)
        self.r_gates = _weight(generator, (h, hd, 4 * hd), torch.float32, device, scale=0.02)
        self.b_gates = nn.Parameter(torch.zeros(4 * d, device=device))
        self.gn = nn.Parameter(torch.zeros(d, dtype=pd, device=device))
        self.w_up = _weight(generator, (d, 2 * d), pd, device)
        self.w_down = _weight(generator, (d, d), pd, device)


def slstm_block(p: SLSTMBlock, x: torch.Tensor, cfg: ModelConfig,
                state: SLSTMState | None, *, parts: tuple[Part, ...] | None = None
                ) -> tuple[torch.Tensor, SLSTMState | None]:
    """The sLSTM over the time axis, one step a position, then the gated
    FFN (GELU, tanh approximation, as `jax.nn.gelu`). x: (B, S, D). With
    `cfg.slstm_reshard` the gate pre-activations are held in bf16 (the
    recurrence itself stays fp32); the JAX package's resharding around
    the scan has no counterpart on one card. With `parts` ((c, n, m, h)
    `Part`s: a decode step under a mesh) one position takes `slstm_step`
    on the rank's pieces, which are written in place, and no state comes
    back."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin = rms_norm(x, p.ln.scale, cfg.norm_eps)
    wx = xin.float() @ p.w_gates + p.b_gates                     # (B, S, 4D)
    if cfg.slstm_reshard:
        wx = wx.to(torch.bfloat16)
    wx = wx.reshape(b, s, 4, h, hd)
    if parts is not None:
        ht, new = slstm_step(wx[:, 0], p.r_gates, *parts)
        write(parts, new)
        return _slstm_ffn(p, ht[:, None], cfg), None
    state = state if state is not None else slstm_init_state(b, h, hd, device=x.device)
    hs = torch.empty((b, s, h, hd), dtype=torch.float32, device=x.device)
    for t in steps(s):
        hs[:, t], state = slstm_step(wx[:, t], p.r_gates, *map(whole, state))
    return _slstm_ffn(p, hs, cfg), state


def _slstm_ffn(p: SLSTMBlock, hs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The recurrence's outputs hs (B, S, H, hd) fp32 through the group-norm
    stand-in and the gated FFN."""
    b, s = hs.shape[:2]
    ht = hs.reshape(b, s, cfg.d_model).to(cfg.dtype)
    ht = rms_norm(ht, p.gn, cfg.norm_eps)
    g, u = (ht @ p.w_up.to(cfg.dtype)).chunk(2, dim=-1)
    return (F.gelu(g, approximate="tanh") * u) @ p.w_down.to(cfg.dtype)


def slstm_step(wx: torch.Tensor, r: torch.Tensor, c: Part, n: Part, m: Part, hh: Part
               ) -> tuple[torch.Tensor, SLSTMState]:
    """The sLSTM recurrence of one position (wx (B, 4, H, hd), the gate
    pre-activations; r (H, hd, 4 hd)) from a state given as `Part`s, placed
    alike: the whole state, or under a mesh the rank's pieces of it. The
    previous output h is joined whole (`join`: the recurrent product per
    head reads all of its hd), the gates' pre-activations are sliced to
    the pieces, and the new h is joined whole. Returns (h (B, H, hd) fp32,
    the pieces' new values); nothing is written."""
    b, _, heads, hd = wx.shape
    h_old = join(hh.local, hh.sl, (b, heads, hd), hh.reduce)
    # the recurrent product per head, (H, B, hd) @ (H, hd, 4 hd), as
    # (B, 4, H, hd) beside the step's input pre-activations
    rec = torch.bmm(h_old.transpose(0, 1), r).reshape(heads, b, 4, hd).permute(1, 2, 0, 3)
    zi, zf, zz, zo = (t[c.sl] for t in (wx.float() + rec).unbind(dim=1))
    logf = F.logsigmoid(zf)
    lfm = logf + m.local
    m_new = torch.maximum(lfm, zi)
    i_p = torch.exp(zi - m_new)
    f_p = torch.exp(lfm - m_new)
    c_new = f_p * c.local + i_p * torch.tanh(zz)
    n_new = f_p * n.local + i_p
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1e-6)
    return join(h_new, c.sl, (b, heads, hd), c.reduce), SLSTMState(c_new, n_new, m_new, h_new)


# ---------------------------------------------------------------------------
# xLSTM model: groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM block
# ---------------------------------------------------------------------------
def xlstm_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mLSTM blocks a group)."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


class XLSTM(nn.Module):
    """The xLSTM's parameters: the tied embedding, `mlstm[g][i]`, `slstm[g]`
    and the final norm; the arithmetic is `xlstm_forward`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        n_groups, n_m = xlstm_groups(cfg)
        self.embed = _weight(generator, (cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                             device, scale=0.02)
        self.mlstm = nn.ModuleList(
            nn.ModuleList(MLSTMBlock(cfg, generator=generator, device=device)
                          for _ in range(n_m))
            for _ in range(n_groups))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, generator=generator, device=device)
                                   for _ in range(n_groups))
        self.ln_final = RMSNorm(cfg, device=device)


def init_xlstm(cfg: ModelConfig, *, generator: torch.Generator | None,
               device: torch.device) -> XLSTM:
    """Parameters drawn from `generator` on `device` (the JAX initialisers'
    distributions, not their numbers), or left empty for
    `params_from_numpy` when generator is None."""
    return XLSTM(cfg, generator=generator, device=device)


def xlstm_forward(params: XLSTM, cfg: ModelConfig, tokens: torch.Tensor,
                  states: dict | None = None, *, chunk: int = MLSTM_CHUNK,
                  prefill: bool = False) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (fp32 logits (B, S, V), new states or None).

    With `states` (`xlstm_init_states`'s layout) every block starts from
    its state and conv cache, and they are updated in place and returned;
    a prefill of S > 1 positions runs the chunked mLSTM from the given
    state, a decode step the sequential one. Without states the forward
    starts from zero and returns none; under grad with `cfg.remat` each
    mLSTM block (its residual add included) then runs under
    torch.utils.checkpoint and is recomputed in the backward, the JAX
    package's `jax.checkpoint(m_body)`. The sLSTM stays outside the
    checkpoint, as there.

    Under a mesh (tokens a DTensor) each block is a `seq_region`: the scan
    runs over the whole sequence on every rank of the sequence axis, and
    a prefill's states come from the regions, placed by the cache's rules
    (`prefill` says the states given are `xlstm_init_states`' zeros). A
    decode step on a mesh takes the states at their placements, each block
    a `state_region` that updates the rank's pieces in place
    (`_xlstm_decode_sharded`)."""
    if in_region(tokens):
        if states is not None and not prefill:
            return _xlstm_decode_sharded(params, cfg, tokens, states)
        return _xlstm_sharded(params, cfg, tokens, states, chunk)
    h = params.embed.to(cfg.dtype)[tokens]
    decode = states is not None
    remat = not decode and remat_on(cfg)
    for g, (group, sblock) in enumerate(zip(params.mlstm, params.slstm)):
        for i, block in enumerate(group):
            if remat:
                h = checkpointed(_mlstm_residual, block, h, cfg, chunk)
                continue
            st = cv = None
            if decode:
                st = MLSTMState(*(a[g, i] for a in states["mlstm"]))
                cv = states["conv"][g, i]
            out, new_st, new_cv = mlstm_block(block, h, cfg, st, cv, chunk=chunk)
            h = h + out
            if decode:
                for buf, val in zip(states["mlstm"], new_st):
                    buf[g, i].copy_(val)
                states["conv"][g, i].copy_(new_cv)
        st_s = SLSTMState(*(a[g] for a in states["slstm"])) if decode else None
        out, new_ss = slstm_block(sblock, h, cfg, st_s)
        h = h + out
        if decode:
            for buf, val in zip(states["slstm"], new_ss):
                buf[g].copy_(val)
    h = rms_norm(h, params.ln_final.scale, cfg.norm_eps)
    logits = matmul_f32(h, params.embed.to(cfg.dtype).t())
    return logits, states


def _xlstm_sharded(params: XLSTM, cfg: ModelConfig, tokens: torch.Tensor,
                   states: dict | None, chunk: int) -> tuple[torch.Tensor, dict | None]:
    """`xlstm_forward` under a mesh from zero states: the loss's forward, or
    a prefill (`states`: `xlstm_init_states`' zeros, which it does not
    read), whose final states are returned."""
    prefill = states is not None
    remat = not prefill and remat_on(cfg)
    heads, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    h = sharded_embed(params.embed, tokens, cfg)
    new_m: list = []
    new_s: list = []

    def m_fn(blk, x):
        if not prefill:
            return (mlstm_block(blk, x, cfg, None, None, chunk=chunk)[0],)
        b = x.shape[0]
        st = mlstm_init_state(b, heads, hd, hd, device=x.device)
        cv = torch.zeros((b, cfg.ssm_conv - 1, cfg.d_model), dtype=cfg.dtype, device=x.device)
        out, nst, ncv = mlstm_block(blk, x, cfg, st, cv, chunk=chunk)
        return (out, *nst, ncv)

    def s_fn(blk, x):
        st = slstm_init_state(x.shape[0], heads, hd, device=x.device) if prefill else None
        out, nst = slstm_block(blk, x, cfg, st)
        return (out, *nst) if prefill else (out,)

    def m_step(blk, x):
        return seq_region(m_fn, blk, x)[0]

    for group, sblock in zip(params.mlstm, params.slstm):
        for block in group:
            h = constrain(h, activation_spec())
            if remat:
                h = checkpointed(m_step, block, h)
                continue
            h, *st = seq_region(m_fn, block, h, 4 if prefill else 0)
            new_m.append(st)
        h, *st = seq_region(s_fn, sblock, constrain(h, activation_spec()), 4 if prefill else 0)
        new_s.append(st)
    logits = final_logits(h, params.ln_final.scale, params.embed, cfg)
    if not prefill:
        return logits, None
    n_groups, n_m = xlstm_groups(cfg)
    mlstm = tuple(torch.stack([torch.stack([new_m[g * n_m + i][j] for i in range(n_m)])
                               for g in range(n_groups)]) for j in range(3))
    conv = torch.stack([torch.stack([new_m[g * n_m + i][3] for i in range(n_m)])
                        for g in range(n_groups)])
    slstm = tuple(torch.stack([new_s[g][j] for g in range(n_groups)]) for j in range(4))
    return logits, {"mlstm": mlstm, "slstm": slstm, "conv": conv}


def _xlstm_decode_sharded(params: XLSTM, cfg: ModelConfig, tokens: torch.Tensor,
                          states: dict) -> tuple[torch.Tensor, dict]:
    """One decode step of `xlstm_forward` under a mesh: tokens (B, 1) placed
    by `input_pspecs` (batch over the batch axes), the states by
    `cache_pspecs` (batch over SEQ_AXIS where it divides B, else a head
    dim, or a stacked axis). Each block is a `state_region`: its
    activations move to the rows its states hold and back, and it updates
    the rank's pieces of its states in place (`mlstm_step`, `slstm_step`,
    `conv_step`), as the mesh-free decode updates the whole ones. Returns
    (logits, states)."""
    h = sharded_embed(params.embed, tokens, cfg)
    m_leaves = (*states["mlstm"], states["conv"])

    def m_fn(g, i):
        def fn(blk, x, dims, *local):
            parts = tuple(state_part(t, (g, i), d) for t, d in zip(local, dims))
            return x + mlstm_block(blk, x, cfg, None, parts=parts)[0]
        return fn

    def s_fn(g):
        def fn(blk, x, dims, *local):
            parts = tuple(state_part(t, (g,), d) for t, d in zip(local, dims))
            return x + slstm_block(blk, x, cfg, None, parts=parts)[0]
        return fn

    for g, (group, sblock) in enumerate(zip(params.mlstm, params.slstm)):
        for i, block in enumerate(group):
            h = state_region(m_fn(g, i), block, constrain(h, activation_spec()), m_leaves, 2)
        h = state_region(s_fn(g), sblock, constrain(h, activation_spec()), states["slstm"], 1)
    h = constrain(h, activation_spec())
    return final_logits(h, params.ln_final.scale, params.embed, cfg), states


def _mlstm_residual(block: MLSTMBlock, h: torch.Tensor, cfg: ModelConfig, chunk: int
                    ) -> torch.Tensor:
    """h plus a stateless mLSTM block's output: the function a checkpoint
    wraps."""
    return h + mlstm_block(block, h, cfg, None, None, chunk=chunk)[0]


def xlstm_init_states(cfg: ModelConfig, batch: int, *,
                      device: torch.device | str = "cpu") -> dict:
    """{"mlstm": (c, n, m) stacked (G, n_m, ...), "slstm": (c, n, m, h)
    stacked (G, ...), both fp32, "conv": (G, n_m, B, W - 1, D) in the
    activation dtype}, as the JAX package lays them out."""
    n_groups, n_m = xlstm_groups(cfg)
    heads, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    m0 = mlstm_init_state(batch, heads, hd, hd, device=device)
    s0 = slstm_init_state(batch, heads, hd, device=device)
    return {
        "mlstm": tuple(a.expand((n_groups, n_m) + a.shape).clone() for a in m0),
        "slstm": tuple(a.expand((n_groups,) + a.shape).clone() for a in s0),
        "conv": torch.zeros((n_groups, n_m, batch, cfg.ssm_conv - 1, cfg.d_model),
                            dtype=cfg.dtype, device=device),
    }
