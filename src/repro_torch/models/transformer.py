"""The decoder stack (dense and MoE), ported from `repro/models/transformer.py`.

The JAX package stacks the layers on a leading n_layers axis and scans
them; here they are a `ModuleList` walked by a Python loop, and gemma2's
alternating local/global windows are plain ints per layer. Decode caches
keep the JAX layout: {"k", "v": (L, B, T, Hk, hd), "pos": (L,) int32}.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.layers import (
    Attention,
    MLP,
    MoE,
    ModelConfig,
    attention_block,
    dense_init,
    init_attention,
    init_mlp,
    init_moe,
    layer_norm,
    matmul_f32,
    mlp_block,
    moe_block,
    rms_norm,
)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """RMS norm's zero-initialised scale, applied as (1 + scale) by
    `apply_norm`."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                              device=device))


class LayerNorm(nn.Module):
    """Layer norm's scale (ones) and bias (zeros), applied by `apply_norm`."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                             device=device))


def init_norm(cfg: ModelConfig, *, device: torch.device) -> RMSNorm | LayerNorm:
    """The norm of `cfg.norm_type`: "rms" or "layer"."""
    if cfg.norm_type == "layer":
        return LayerNorm(cfg, device=device)
    if cfg.norm_type != "rms":
        raise ValueError(f"norm_type {cfg.norm_type!r}: rms or layer")
    return RMSNorm(cfg, device=device)


def apply_norm(p: RMSNorm | LayerNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    """A pre-norm block's parameters: attention, then an MLP or, for an
    MoE config, the experts (`moe`), with gemma2's post (sandwich) norms
    when configured; the arithmetic is `decoder_layer`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.ln_attn = init_norm(cfg, device=device)
        self.attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_mlp = init_norm(cfg, device=device)
        if cfg.is_moe:
            self.moe: MoE = init_moe(cfg, generator=generator, device=device)
        else:
            self.mlp: MLP = init_mlp(cfg, generator=generator, device=device)
        if cfg.post_norms:
            self.ln_attn_post = init_norm(cfg, device=device)
            self.ln_mlp_post = init_norm(cfg, device=device)


def init_decoder_layer(cfg: ModelConfig, *, generator: torch.Generator | None,
                       device: torch.device) -> DecoderLayer:
    return DecoderLayer(cfg, generator=generator, device=device)


def decoder_layer(p: DecoderLayer, h: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, window: int, cache: dict | None = None
                  ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """(the layer's output, its new cache or None, the MoE auxiliary loss:
    a 0-d fp32 zero for an MLP layer)."""
    a, new_cache = attention_block(p.attn, apply_norm(p.ln_attn, h, cfg), cfg,
                                   positions=positions, window=window, cache=cache)
    if cfg.post_norms:
        a = apply_norm(p.ln_attn_post, a, cfg)
    h = h + a
    m_in = apply_norm(p.ln_mlp, h, cfg)
    if cfg.is_moe:
        m, aux = moe_block(p.moe, m_in, cfg)
    else:
        m = mlp_block(p.mlp, m_in, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.post_norms:
        m = apply_norm(p.ln_mlp_post, m, cfg)
    return h + m, new_cache, aux


def _layer_out(p: DecoderLayer, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A cache-free layer's output and aux: the function a checkpoint wraps."""
    out, _, aux = decoder_layer(p, h, cfg, positions=positions, window=window)
    return out, aux


# ---------------------------------------------------------------------------
# Decoder model
# ---------------------------------------------------------------------------
def layer_windows(cfg: ModelConfig) -> torch.Tensor:
    """(L,) int32 per-layer sliding windows, 0 = full attention. gemma2's
    pattern puts the window on the even layer indices (local, global,
    local, ...), as the JAX package does."""
    idx = torch.arange(cfg.n_layers)
    if cfg.local_global_period and cfg.sliding_window:
        global_layer = idx % cfg.local_global_period == cfg.local_global_period - 1
        return torch.where(global_layer, 0, cfg.sliding_window).to(torch.int32)
    return torch.full((cfg.n_layers,), cfg.sliding_window, dtype=torch.int32)


class Decoder(nn.Module):
    """The decoder's parameters (embedding, layers, final norm and, where
    the embeddings are not tied, the (d_model, vocab) head `unembed`); the
    arithmetic is `decoder_forward`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.embed = nn.Parameter(dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                             cfg.param_dtype, device, scale=0.02))
        self.layers = nn.ModuleList(
            init_decoder_layer(cfg, generator=generator, device=device)
            for _ in range(cfg.n_layers))
        self.ln_final = init_norm(cfg, device=device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(dense_init(
                generator, (cfg.d_model, cfg.vocab_size), cfg.param_dtype, device))


def init_decoder(cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device) -> Decoder:
    """A decoder with parameters drawn from `generator` on `device` (the
    JAX initialisers' distributions; not their numbers), or left empty for
    `load_numpy` when generator is None."""
    return Decoder(cfg, generator=generator, device=device)


def head_weight(params: Decoder, cfg: ModelConfig) -> torch.Tensor:
    """The head as a (vocab, d_model) operand in the activation dtype: the
    tied embedding, or the transposed view of `unembed` (no copy of it)."""
    if cfg.tie_embeddings:
        return params.embed.to(cfg.dtype)
    return params.unembed.to(cfg.dtype).t()


def decoder_forward(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
                    positions: torch.Tensor, caches: dict | None = None
                    ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """tokens (B, S) -> (fp32 logits (B, S, V), new caches or None, the
    layers' summed MoE aux loss): the stack (`decoder_hidden`), then the
    fp32 head (`head_weight`) and the logit softcap."""
    h, new_caches, aux = decoder_hidden(params, cfg, tokens, positions=positions,
                                        caches=caches)
    logits = matmul_f32(h, head_weight(params, cfg).t())
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        if torch.is_grad_enabled() and logits.requires_grad:
            # out of place: tanh keeps its output for the backward
            logits = torch.tanh(logits / cap) * cap
        else:
            # in place: at S = 8,192 the fp32 logits are 8.4 GB
            logits.div_(cap).tanh_().mul_(cap)
    return logits, new_caches, aux


def decoder_hidden(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
                   positions: torch.Tensor, caches: dict | None = None
                   ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """tokens (B, S) -> (the final norm's output (B, S, D), new caches or
    None, the MoE aux loss summed over the layers in order, as the JAX
    package's `_scan_layers` sums it): the embedding and the layers.

    `cfg` governs every layer (the modules' own configs are not read), so
    one set of parameters runs under a changed config, such as a
    `chunked_attn_min_len` that sends a long sequence down the direct path.

    With grad enabled and `cfg.remat`, each cache-free layer runs under
    `torch.utils.checkpoint` (non-reentrant): the backward keeps only the
    layer's input and recomputes the rest, the JAX package's
    `jax.checkpoint` with policy "nothing". The other policies are not
    ported (ROADMAP.md, item 12.4).
    """
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported; only \"nothing\" "
            "(full recompute) is: ROADMAP.md, queue 1 item 12.4")
    h = params.embed.to(cfg.dtype)[tokens]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as in JAX
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    windows = layer_windows(cfg).tolist()
    auxes = []
    for i, layer in enumerate(params.layers):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": caches["pos"][i]}
        if remat:
            h, aux = torch.utils.checkpoint.checkpoint(
                _layer_out, layer, h, cfg, positions, windows[i], use_reentrant=False)
        else:
            h, _, aux = decoder_layer(layer, h, cfg, positions=positions,
                                      window=windows[i], cache=cache)
        auxes.append(aux)
    h = apply_norm(params.ln_final, h, cfg)
    new_caches = None
    if caches is not None:
        new_caches = {"k": caches["k"], "v": caches["v"],
                      "pos": caches["pos"] + positions.shape[-1]}
    aux = torch.stack(auxes).sum() if auxes else torch.zeros((), device=h.device)
    return h, new_caches, aux


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: torch.device) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros(cfg.n_layers, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Cross-entropy loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE over valid (label >= 0) positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    nll = (lse - gold) * valid
    n = valid.sum().clamp(min=1.0)
    loss = nll.sum() / n
    return loss, {"ce": loss, "tokens": n}


#: rows (batch x sequence positions) of the logits a chunk of `head_loss`:
#: 1,024 rows of gemma2-2b's vocabulary are 1.05 GB of fp32 logits
HEAD_CHUNK = 1024


def head_loss(params: Decoder, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor
              ) -> tuple[torch.Tensor, dict]:
    """The head of the loss: `cross_entropy` of the softcapped fp32 logits
    of `decoder_forward`, from the final norm's output h (B, S, D), without
    the (B, S, V) logits. The head is `head_weight`'s (V, D) operand, tied
    or the view of `unembed`. `HeadLoss` takes HEAD_CHUNK rows at a time, adds
    the chunks' sums in order, and recomputes each chunk in the backward:
    the same function as decoder_forward + cross_entropy (one chunk gives
    its bits). At S = 8,192 the whole logits are 8.4 GB in fp32, and a
    backward through them holds several copies at once."""
    labels = labels.reshape(-1)
    valid = (labels >= 0).float()
    n = valid.sum().clamp(min=1.0)
    total = HeadLoss.apply(h.reshape(-1, h.shape[-1]), head_weight(params, cfg),
                           labels, cfg.logit_softcap)
    loss = total / n
    return loss, {"ce": loss, "tokens": n}


def _chunk_logits(h: torch.Tensor, w: torch.Tensor, cap: float
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(softcapped fp32 logits of rows h against w, tanh(logits / cap) or
    None); decoder_forward's arithmetic."""
    z = matmul_f32(h, w.t())
    if cap <= 0:
        return z, None
    t = torch.tanh(z.div_(cap))
    return t * cap, t


class HeadLoss(torch.autograd.Function):
    """sum over rows r with label >= 0 of logsumexp(s_r) - s_r[label_r],
    s = softcap(h w^T) in fp32, taken HEAD_CHUNK rows at a time in row
    order. The backward recomputes each chunk's logits and takes the
    transpose JAX takes: ds = g (softmax(s) - onehot(label)) for valid rows,
    dz = ds (1 - t^2) under the softcap, dh = dz w and dw = sum over the
    chunks of dz^T h, in fp32, each cast once to its input's dtype."""

    @staticmethod
    def forward(ctx, h, w, labels, cap):
        work = torch.promote_types(h.dtype, torch.float32)
        total = torch.zeros((), dtype=work, device=h.device)
        for lo in range(0, h.shape[0], HEAD_CHUNK):
            s, _ = _chunk_logits(h[lo:lo + HEAD_CHUNK], w, cap)
            lab = labels[lo:lo + HEAD_CHUNK]
            lse = torch.logsumexp(s, dim=-1)
            gold = s.gather(-1, lab.clamp(min=0).long()[:, None])[:, 0]
            total = total + ((lse - gold) * (lab >= 0).to(work)).sum()
            del s
        ctx.save_for_backward(h, w, labels)
        ctx.cap = cap
        return total

    @staticmethod
    def backward(ctx, g):
        h, w, labels = ctx.saved_tensors
        dh = torch.empty_like(h)
        work = torch.promote_types(h.dtype, torch.float32)
        dw = torch.zeros(w.shape, dtype=work, device=w.device)
        w32 = w.to(work)
        for lo in range(0, h.shape[0], HEAD_CHUNK):
            hc, lab = h[lo:lo + HEAD_CHUNK], labels[lo:lo + HEAD_CHUNK]
            s, t = _chunk_logits(hc, w, ctx.cap)
            scale = g * (lab >= 0).to(work)
            ds = torch.softmax(s, dim=-1).mul_(scale[:, None])
            del s
            rows = torch.arange(hc.shape[0], device=h.device)
            ds[rows, lab.clamp(min=0).long()] -= scale
            if t is not None:
                ds.mul_(1.0 - t * t)
                del t
            dh[lo:lo + HEAD_CHUNK] = (ds @ w32).to(h.dtype)
            dw.addmm_(ds.t(), hc.to(work))
            del ds
        return dh, dw.to(w.dtype), None, None


# ---------------------------------------------------------------------------
# Parameters carried across from the JAX package
# ---------------------------------------------------------------------------
def _leaf(tree: Any, path: list[str]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _as_tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":
        a = a.astype(np.float32)   # bf16 (ml_dtypes) widens exactly
    return torch.from_numpy(np.array(a))  # a writable copy


def _tree_paths(tree: Any, prefix: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _tree_paths(sub, prefix + (key,))
    else:
        yield prefix


def param_leaf(tree: Any, name: str) -> tuple[list[str], Any]:
    """The JAX tree path of the port's parameter `name` and its value. The
    name's integer parts index the stacked leaf its other parts name: a
    decoder layer's "layers.3.attn.wq" is slice [3] of "layers/attn/wq",
    an xLSTM "mlstm.1.4.w_up" slice [1, 4] of "mlstm/w_up", a Zamba2
    "mamba.0.2.in_proj" slice [0, 2] of "mamba/in_proj"."""
    parts = name.split(".")
    path = [p for p in parts if not p.isdigit()]
    idx = tuple(int(p) for p in parts if p.isdigit())
    value = _leaf(tree, path)
    return path, value[idx] if idx else value


def load_numpy(model: nn.Module, tree: dict) -> nn.Module:
    """`model`'s parameters filled from a JAX model's parameter tree (numpy
    arrays, stacked layers on their leading axes); returns `model`.

    Every leaf must have a parameter of the same shape and every parameter
    a leaf, by the path its name gives (`param_leaf`), and a stacked leaf's
    leading axes must be the port's: each slice one parameter. A leaf the
    port has no parameter for, or a slice too many, is refused (ValueError),
    as is a missing leaf (KeyError). Each value is cast to its parameter's
    dtype; the fp32 parameters (the MoE router, the xLSTM gates, the
    Mamba2 `a_log`, `dt_bias`, `d_skip`) stay fp32.
    """
    slices: dict[tuple[str, ...], set] = {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            try:
                path, value = param_leaf(tree, name)
            except KeyError as err:
                raise KeyError(f"{name}: the tree has no leaf for it ({err})") from None
            value = _as_tensor(value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: tree has {tuple(value.shape)}, "
                                 f"the port's parameter is {tuple(param.shape)}")
            param.copy_(value.to(param.dtype))
            slices.setdefault(tuple(path), set()).add(
                tuple(int(p) for p in name.split(".") if p.isdigit()))
    extra = [p for p in _tree_paths(tree) if p not in slices]
    if extra:
        raise ValueError(f"leaves with no parameter in the port: {extra}")
    for path, idx in slices.items():
        lead = np.shape(_leaf(tree, list(path)))[:len(next(iter(idx)))]
        if len(idx) != int(np.prod(lead, dtype=np.int64)):
            raise ValueError(f"leaf {'/'.join(path)} stacks {lead} slices, the port has "
                             f"{len(idx)} parameters for it")
    return model
