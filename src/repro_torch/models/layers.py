"""Building blocks of the dense decoder LM, ported from `repro/models/layers.py`.

The arithmetic is the JAX package's: activations and parameters in the
config's dtype (bf16 for the published configs), norms, RoPE and softmax
in fp32, and the products the JAX package takes with
`preferred_element_type=float32` (attention scores, P V, the logits) summed
in fp32 from exact products (`matmul_f32`). The cache-free attention of a
long sequence (`chunk`) runs the hand-written flash kernel
(`kernels/ops.py::flash_attention`); everything else is plain PyTorch.

Parameters keep the JAX layout (`wq` is (d_model, H * hd) and the layer
computes x @ wq), so `models/transformer.py::params_from_numpy` copies a
JAX parameter tree leaf by leaf. MoE, M-RoPE, layer norm, cross-attention
and the mesh helpers are not ported yet (ROADMAP.md, queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of `repro.models.layers.ModelConfig` that the dense
    decoder of gemma2-2b reads, with the same names and defaults; dtypes
    are torch's. The port ties the embeddings and gates the MLP, as
    gemma2-2b does; QKV biases and untied or ungated variants come with
    the other dense configs (ROADMAP.md, queue 1 item 12)."""

    name: str
    family: str                      # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma2: every 2nd layer global
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    attn_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2 sandwich norms
    mlp_act: str = "silu"            # silu | gelu (tanh approximation)
    embed_scale: bool = False        # gemma2 multiplies embeddings by sqrt(d)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 1024           # KV block of the JAX chunked attention
    chunked_attn_min_len: int = 8192 # cache-free sequences this long take the kernel
    remat: bool = True               # recompute each layer in the backward
    remat_policy: str = "nothing"    # only "nothing" is ported (ROADMAP.md, item 12.4)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


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


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 for bf16 operands: every product is exact and the sums
    are fp32, as XLA's `preferred_element_type=float32` (fp32 or float64
    operands of one dtype multiply as they are). a is
    (..., m, k) and b (k, n) or (..., k, n) with a's leading axes. On the
    card bf16 operands go through `MatmulF32`, whose backward is JAX's
    transpose of such a product; on the CPU autograd differentiates
    a.float() @ b.float(), which is the same function."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return a @ b
    if not a.is_cuda:
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


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Q, K, V and output projections (JAX layout: x @ w); the layer's
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
) -> torch.Tensor:
    """Attention over (B, S, H, hd) heads; returns (B, Sq, H, hd).

    The direct path materialises the (B, H, Sq, Sk) scores in fp32 and
    rounds the probabilities to q's dtype before P V, as the JAX package
    does. With `chunk` (a cache-free sequence of more than `chunk` keys)
    the flash kernel computes the same softmax with fp32 probabilities and
    never materialises the scores: the JAX package's chunked path. That
    branch takes only what the model gives it, Sq == Sk from position 0,
    and raises on anything else. The JAX signature's `kv_len` has no
    caller in the dense decoder and is not ported.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = scale or (1.0 / math.sqrt(hd))

    if chunk and sk > chunk:
        if sq != sk or not (isinstance(q_offset, int) and q_offset == 0):
            raise ValueError("the flash path takes a cache-free sequence: "
                             "Sq == Sk and q_offset 0")
        return _flash(q, k, v, causal=causal, window=window,
                      softcap=attn_softcap, scale=scale)

    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)
    scores = matmul_f32(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale  # (B, H, Sq, Sk)
    scores = softcap(scores, attn_softcap)
    mask = attention_scores_mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = matmul_f32(probs, v.transpose(1, 2).to(q.dtype))               # (B, H, Sq, hd)
    return out.transpose(1, 2).to(q.dtype)


def _flash(q, k, v, *, causal, window, softcap, scale):
    """(B, S, H, hd) heads through the kernel's (B*H, S, hd) layout; k and v
    keep their Hk heads (the kernel maps each query head to its group)."""
    b, s, h, hd = q.shape
    hk = k.shape[2]

    def flat(x, n):
        return x.transpose(1, 2).reshape(b * n, s, hd).contiguous()

    out = ops.flash_attention(flat(q, h), flat(k, hk), flat(v, hk), causal=causal,
                              window=window, softcap=softcap, scale=scale)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def attention_block(
    params: Attention,
    x: torch.Tensor,                 # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,         # (B, S)
    window: int = 0,
    cache: dict | None = None,       # {"k", "v", "pos"} of this layer
) -> tuple[torch.Tensor, dict | None]:
    """Projection + RoPE + causal attention + output projection.

    With `cache` ((B, T, Hk, hd) buffers and a 0-d int position), the new
    K/V are written at `pos` and the queries attend over the whole buffer
    with causality from q_offset = pos masking the unwritten slots. The
    buffers are updated in place (the JAX package returns new ones), so
    the cache passed in is consumed. The write start is clamped to
    [0, T - S], as `jax.lax.dynamic_update_slice` clamps it.
    """
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params.wq.to(cfg.dtype)).reshape(b, s, h, hd)
    k = (x @ params.wk.to(cfg.dtype)).reshape(b, s, hk, hd)
    v = (x @ params.wv.to(cfg.dtype)).reshape(b, s, hk, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
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
        chunk = cfg.attn_chunk if s >= cfg.chunked_attn_min_len else 0
        out = multi_head_attention(
            q, k, v, causal=True, window=window, attn_softcap=cfg.attn_softcap,
            scale=cfg.attn_scale, chunk=chunk,
        )
    out = out.reshape(b, s, h * hd) @ params.wo.to(cfg.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """Gated MLP weights; the arithmetic is `mlp_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def w(shape):
            return nn.Parameter(dense_init(generator, shape, cfg.param_dtype, device))

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
    u = x @ params.w_up.to(cfg.dtype)
    hidden = _act(cfg, x @ params.w_gate.to(cfg.dtype)) * u
    return hidden @ params.w_down.to(cfg.dtype)
