"""Mamba2 (SSD) blocks, ported from `repro/models/mamba.py`: the chunked
parallel form of a sequence and the recurrent step of a decode.

The SSD computation splits the sequence into chunks: within a chunk an
attention-like product weighted by cumulative decays, across chunks a (B,
H, state, headdim) recurrent tensor carried in a Python loop where the JAX
package scans. The single step is the decode path and the oracle of the
chunked form. Plain PyTorch: no Pallas kernel stands behind it, and no
kernel of the port runs here. `a_log`, `dt_bias` and `d_skip` are fp32 in
every config; the scan runs in fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.cost import steps
from repro_torch.models.layers import ModelConfig, Part, dense_init, join, rms_norm, whole, write
from repro_torch.models.ssm import causal_conv1d, conv_step, work
from repro_torch.models.transformer import RMSNorm


class Mamba2State(NamedTuple):
    h: torch.Tensor       # (B, H, N, P) SSM state, fp32
    conv: torch.Tensor    # (B, W - 1, C) conv cache


def mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(d_inner, n_heads, headdim, n_groups, d_state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    headdim = cfg.ssm_headdim
    return d_inner, d_inner // headdim, headdim, max(1, cfg.ssm_groups), cfg.ssm_state


class Mamba2Block(nn.Module):
    """A Mamba2 block's parameters (`init_mamba2_block`'s); the arithmetic
    is `mamba2_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        d_inner, nh, _, ng, ns = mamba2_dims(cfg)
        conv_ch = d_inner + 2 * ng * ns
        d_in_proj = 2 * d_inner + 2 * ng * ns + nh

        def w(shape, scale=None):
            return nn.Parameter(dense_init(generator, shape, pd, device, scale=scale))

        self.ln = RMSNorm(cfg, device=device)
        self.in_proj = w((d, d_in_proj))
        self.conv = w((cfg.ssm_conv, conv_ch), scale=0.3)
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nh, device=device)))
        self.dt_bias = nn.Parameter(torch.full((nh,), -4.0, device=device))
        self.d_skip = nn.Parameter(torch.ones(nh, device=device))
        self.gn = nn.Parameter(torch.zeros(d_inner, dtype=pd, device=device))
        self.out_proj = w((d_inner, d))


def _split_proj(z: torch.Tensor, cfg: ModelConfig):
    """(z, x, B, C, dt) of the input projection."""
    d_inner, nh, _, ng, ns = mamba2_dims(cfg)
    return torch.split(z, [d_inner, d_inner, ng * ns, ng * ns, nh], dim=-1)


def ssd_chunked(x, dt, a, b_in, c_in, state, *, chunk: int = 128,
                fold_decay: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P), dt: (B, S, H) (after softplus), a: (H,) negative decay
    rates, b_in / c_in: (B, S, G, N), state: (B, H, N, P). Returns (y (B, S,
    H, P) fp32, new state; float64 where the inputs are). A ragged tail is
    padded with zeros (dt = 0: no decay, no input). `fold_decay` folds
    exp(+-cumsum(a dt)) into C and B so that the (B, T, S, H) decay tensor
    is never formed; the cumulative exponent restarts at each chunk.
    """
    bsz, s, h, p = x.shape
    rep = h // b_in.shape[2]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dt, b_in, c_in = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in (x, dt, b_in, c_in))
    x = work(x)
    # per-head B and C: head h reads group h // rep, as jnp.repeat orders them
    bh = work(b_in).repeat_interleave(rep, dim=2)
    ch = work(c_in).repeat_interleave(rep, dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    hst = work(state)
    ys = []
    loop = steps(nc)
    for j in loop:
        sl = slice(j * chunk, (j + 1) * chunk)
        xb, dtb, bb, cb = x[:, sl], dt[:, sl], bh[:, sl], ch[:, sl]
        acum = torch.cumsum(a[None, None, :] * dtb, dim=1)       # (B, L, H), inclusive
        if fold_decay:
            # scores[t, s] = (C_t e^{acum_t}) . (B_s e^{-acum_s} dt_s)
            cf = cb * torch.exp(acum)[..., None]
            bf = bb * (torch.exp(-acum) * dtb)[..., None]
            w = torch.einsum("bthn,bshn->btsh", cf, bf)
            w = torch.where(tri[None, :, :, None], w, 0.0)
            y_intra = torch.einsum("btsh,bshp->bthp", w, xb)
            # exp(acum_T - acum_s) dt_s B_s = e^{acum_T} bf_s
            upd = torch.einsum("bshn,bshp->bhnp", bf, xb)
            h_new = torch.exp(acum[:, -1])[:, :, None, None] * (hst + upd)
            y_inter = torch.einsum("bthn,bhnp->bthp", cf, hst)
        else:
            # scores[t, s] = (C_t . B_s) exp(acum_t - acum_s) dt_s. The
            # masked exponents (t < s) are set to -inf before exp: at full
            # width they pass fp32's range, and exp(seg) = inf there would
            # send 0 x inf = NaN back through a masking where (the JAX
            # package's jnp.where(tri, exp(seg), 0) does; ROADMAP.md queue 3)
            seg = acum[:, :, None, :] - acum[:, None, :, :]      # (B, T, S, H)
            decay = torch.exp(seg.masked_fill(~tri[None, :, :, None], float("-inf")))
            w = torch.einsum("bthn,bshn->btsh", cb, bb) * decay * dtb[:, None, :, :]
            y_intra = torch.einsum("btsh,bshp->bthp", w, xb)
            y_inter = torch.exp(acum)[..., None] * torch.einsum("bthn,bhnp->bthp", cb, hst)
            tail = torch.exp(acum[:, -1:, :] - acum)             # (B, S, H)
            upd = torch.einsum("bshn,bshp->bhnp", (tail * dtb)[..., None] * bb, xb)
            h_new = torch.exp(acum[:, -1])[:, :, None, None] * hst + upd
        hst = h_new
        ys.append(y_intra + y_inter)
    return torch.cat(loop.full(ys), dim=1)[:, :s], hst


def ssd_step(x, dt, a, b_in, c_in, state: torch.Tensor | Part
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. x: (B, H, P), dt: (B, H), b_in / c_in: (B, G, N),
    state (B, H, N, P) fp32, or under a mesh the rank's piece of it (a
    `Part`), whose new value comes from the slices of x, dt and B it
    covers, and y's sum over N is joined over SEQ_AXIS (`join`: a gather
    where the piece is some heads, an all-reduce where it is some of N).
    Returns (y (B, H, P), the new state or piece), in fp32 (float64 for
    float64 inputs); nothing is written."""
    part = state if isinstance(state, Part) else whole(state)
    rep = x.shape[1] // b_in.shape[1]
    bh = work(b_in).repeat_interleave(rep, dim=1)                # (B, H, N)
    ch = work(c_in).repeat_interleave(rep, dim=1)
    decay = torch.exp(a[None, :] * dt)                           # (B, H)
    sb, sh, sn, sp = part.sl
    upd = torch.einsum("bhn,bhp->bhnp", (dt[..., None] * bh)[sb, sh, sn], work(x)[sb, sh, sp])
    h_new = decay[sb, sh][..., None, None] * part.local + upd
    y = torch.einsum("bhn,bhnp->bhp", ch[sb, sh, sn], h_new)
    return join(y, (sb, sh, sp), tuple(x.shape), part.reduce), h_new


def mamba2_block(p: Mamba2Block, x: torch.Tensor, cfg: ModelConfig,
                 state: Mamba2State | None, *, chunk: int | None = None,
                 parts: tuple[Part, Part] | None = None
                 ) -> tuple[torch.Tensor, Mamba2State | None]:
    """x: (B, S, D). Returns (out, new state; None without a state). A
    single position with a state takes `ssd_step`, anything else
    `ssd_chunked` (chunk `cfg.ssm_chunk` unless given). With `parts` ((h,
    conv) `Part`s: a decode step under a mesh) one position takes
    `ssd_step` and `conv_step` on the rank's pieces, which are written in
    place, and no state comes back."""
    chunk = chunk or cfg.ssm_chunk
    bsz, s, _ = x.shape
    d_inner, nh, hp, ng, ns = mamba2_dims(cfg)
    xin = rms_norm(x, p.ln.scale, cfg.norm_eps)
    z, xi, bi, ci, dti = _split_proj(xin @ p.in_proj.to(cfg.dtype), cfg)

    conv_in = torch.cat([xi, bi, ci], dim=-1)
    if parts is not None:
        conv_out, new_conv = conv_step(conv_in, p.conv, parts[1])
    else:
        conv_out, new_conv = causal_conv1d(conv_in, p.conv,
                                           state.conv if state is not None else None)
    conv_out = F.silu(conv_out)
    xi, bi, ci = torch.split(conv_out, [d_inner, ng * ns, ng * ns], dim=-1)

    # softplus as jax.nn.softplus: log(1 + e^x) with no linear cut-off
    dt = torch.logaddexp(dti.float() + p.dt_bias, torch.zeros((), device=x.device))
    a = -torch.exp(p.a_log)
    xh = xi.reshape(bsz, s, nh, hp)
    bh = bi.reshape(bsz, s, ng, ns)
    chh = ci.reshape(bsz, s, ng, ns)

    if parts is not None or (s == 1 and state is not None):
        y, h_new = ssd_step(xh[:, 0], dt[:, 0], a, bh[:, 0], chh[:, 0],
                            parts[0] if parts is not None else state.h)
        y = y[:, None]
    else:
        h0 = (state.h if state is not None
              else torch.zeros((bsz, nh, ns, hp), dtype=torch.float32, device=x.device))
        y, h_new = ssd_chunked(xh, dt, a, bh, chh, h0, chunk=chunk,
                               fold_decay=cfg.ssd_fold_decay)
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(cfg.dtype)
    y = rms_norm(y * F.silu(z), p.gn, cfg.norm_eps)
    out = y @ p.out_proj.to(cfg.dtype)
    if parts is not None:
        write(parts, (h_new, new_conv))
        return out, None
    new_state = Mamba2State(h=h_new, conv=new_conv) if state is not None else None
    return out, new_state


def mamba2_init_state(cfg: ModelConfig, batch: int, *,
                      device: torch.device | str = "cpu") -> Mamba2State:
    d_inner, nh, hp, ng, ns = mamba2_dims(cfg)
    return Mamba2State(
        h=torch.zeros((batch, nh, ns, hp), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * ng * ns),
                         dtype=cfg.dtype, device=device),
    )
