"""The dense decoder stack, ported from `repro/models/transformer.py`.

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
    ModelConfig,
    attention_block,
    dense_init,
    init_attention,
    init_mlp,
    matmul_f32,
    mlp_block,
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


def init_norm(cfg: ModelConfig, *, device: torch.device) -> RMSNorm:
    return RMSNorm(cfg, device=device)


def apply_norm(p: RMSNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    """A pre-norm block's parameters, with gemma2's post (sandwich) norms
    when configured; the arithmetic is `decoder_layer`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.ln_attn = init_norm(cfg, device=device)
        self.attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_mlp = init_norm(cfg, device=device)
        self.mlp: MLP = init_mlp(cfg, generator=generator, device=device)
        if cfg.post_norms:
            self.ln_attn_post = init_norm(cfg, device=device)
            self.ln_mlp_post = init_norm(cfg, device=device)


def init_decoder_layer(cfg: ModelConfig, *, generator: torch.Generator | None,
                       device: torch.device) -> DecoderLayer:
    return DecoderLayer(cfg, generator=generator, device=device)


def decoder_layer(p: DecoderLayer, h: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, window: int, cache: dict | None = None
                  ) -> tuple[torch.Tensor, dict | None]:
    a, new_cache = attention_block(p.attn, apply_norm(p.ln_attn, h, cfg), cfg,
                                   positions=positions, window=window, cache=cache)
    if cfg.post_norms:
        a = apply_norm(p.ln_attn_post, a, cfg)
    h = h + a
    m = mlp_block(p.mlp, apply_norm(p.ln_mlp, h, cfg), cfg)
    if cfg.post_norms:
        m = apply_norm(p.ln_mlp_post, m, cfg)
    return h + m, new_cache


def _layer_out(p: DecoderLayer, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, window: int) -> torch.Tensor:
    """A cache-free layer's output alone: the function a checkpoint wraps."""
    return decoder_layer(p, h, cfg, positions=positions, window=window)[0]


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
    """The decoder's parameters (tied embedding, layers, final norm); the
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


def init_decoder(cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device) -> Decoder:
    """A decoder with parameters drawn from `generator` on `device` (the
    JAX initialisers' distributions; not their numbers), or left empty for
    `params_from_numpy` when generator is None."""
    return Decoder(cfg, generator=generator, device=device)


def decoder_forward(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
                    positions: torch.Tensor, caches: dict | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (fp32 logits (B, S, V), new caches or None): the
    stack (`decoder_hidden`), then the tied fp32 unembedding and the logit
    softcap."""
    h, new_caches = decoder_hidden(params, cfg, tokens, positions=positions, caches=caches)
    logits = matmul_f32(h, params.embed.to(cfg.dtype).t())
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        if torch.is_grad_enabled() and logits.requires_grad:
            # out of place: tanh keeps its output for the backward
            logits = torch.tanh(logits / cap) * cap
        else:
            # in place: at S = 8,192 the fp32 logits are 8.4 GB
            logits.div_(cap).tanh_().mul_(cap)
    return logits, new_caches


def decoder_hidden(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
                   positions: torch.Tensor, caches: dict | None = None
                   ) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (the final norm's output (B, S, D), new caches or
    None): the embedding and the layers.

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
    for i, layer in enumerate(params.layers):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": caches["pos"][i]}
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _layer_out, layer, h, cfg, positions, windows[i], use_reentrant=False)
        else:
            h, _ = decoder_layer(layer, h, cfg, positions=positions, window=windows[i],
                                 cache=cache)
    h = apply_norm(params.ln_final, h, cfg)
    new_caches = None
    if caches is not None:
        new_caches = {"k": caches["k"], "v": caches["v"],
                      "pos": caches["pos"] + positions.shape[-1]}
    return h, new_caches


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
    the (B, S, V) logits. `HeadLoss` takes HEAD_CHUNK rows at a time, adds
    the chunks' sums in order, and recomputes each chunk in the backward:
    the same function as decoder_forward + cross_entropy (one chunk gives
    its bits). At S = 8,192 the whole logits are 8.4 GB in fp32, and a
    backward through them holds several copies at once."""
    labels = labels.reshape(-1)
    valid = (labels >= 0).float()
    n = valid.sum().clamp(min=1.0)
    total = HeadLoss.apply(h.reshape(-1, h.shape[-1]), params.embed.to(cfg.dtype),
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
    """The JAX tree path of the port's parameter `name` and its value: a
    layer's parameter is slice i of the stacked leaf "layers/..."."""
    parts = name.split(".")
    if parts[0] == "layers":
        path = ["layers", *parts[2:]]
        return path, _leaf(tree, path)[int(parts[1])]
    return parts, _leaf(tree, parts)


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device: torch.device | str = "cuda") -> Decoder:
    """The JAX decoder's parameter tree (numpy arrays, layers stacked on a
    leading n_layers axis) as the port's `Decoder` on `device`.

    Every leaf must have a parameter of the same shape and every parameter
    a leaf; each value is cast to the config's parameter dtype.
    """
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    model = init_decoder(cfg, generator=None, device=device)
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, value = param_leaf(tree, name)
            value = _as_tensor(value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: tree has {tuple(value.shape)}, "
                                 f"the port's parameter is {tuple(param.shape)}")
            param.copy_(value.to(param.dtype))
            used.add(tuple(path))
    extra = [p for p in _tree_paths(tree) if p not in used]
    if extra:
        raise ValueError(f"leaves with no parameter in the port: {extra}")
    return model
