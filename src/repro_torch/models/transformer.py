"""The decoder stack (dense, MoE and the VLM's) and whisper's encoder-decoder,
ported from `repro/models/transformer.py`.

The JAX package stacks the layers on a leading n_layers axis and scans
them; here they are a `ModuleList` walked by a Python loop, and gemma2's
alternating local/global windows are plain ints per layer. Decode caches
keep the JAX layout: {"k", "v": (L, B, T, Hk, hd), "pos": (L,) int32}, and
whisper's adds its cross-attention K/V {"ck", "cv": (L, B, S_enc, Hk, hd)}.
Under grad with `cfg.remat` every cache-free layer, the encoder's and the
cross-decoder's too, runs under `torch.utils.checkpoint`, where the JAX
package wraps its scan bodies in `jax.checkpoint`; the decoder's layers
under `cfg.remat_policy` (`REMAT_POLICIES`), as its `_scan_layers`.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels import ops  # noqa: F401  (registers repro_torch::flash_forward)
from repro_torch.launch.cost import steps
from repro_torch.models.layers import (
    Attention,
    BATCH_AXES,
    MLP,
    ModelConfig,
    MoE,
    activation_spec,
    attention_block,
    constrain,
    current_checkpoint_name,
    dense_init,
    in_region,
    init_attention,
    init_mlp,
    init_moe,
    layer_norm,
    matmul_f32,
    mlp_block,
    moe_block,
    partial_placements,
    region,
    replicated,
    rms_norm,
    seq_chunk,
    seq_shard,
    sharded_axes,
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


def _layer_region(p: DecoderLayer, h: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`_layer_out` of a cache-free layer under a mesh, as one region: h
    and the positions as placed, the layer's weights whole (experts
    sharded), out placed as h, aux Partial."""
    def fn(layer, hh, pp):
        return _layer_out(layer, hh, cfg, pp, window)

    return region(fn, p, (h, positions), (tuple(h.placements), partial_placements()))


def _cached_layer_region(p: DecoderLayer, h: torch.Tensor, positions: torch.Tensor,
                         cfg: ModelConfig, window: int, cache: dict
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer with a decode cache under a mesh: the cache's K/V shards are
    written in place inside the region, and the split softmax reduces over
    the axes that shard their sequence."""
    axes = sharded_axes(cache["k"], 1)

    def fn(layer, hh, pp, ck, cv, pos):
        out, _, aux = decoder_layer(layer, hh, cfg, positions=pp, window=window,
                                    cache={"k": ck, "v": cv, "pos": pos, "axes": axes})
        return out, aux

    return region(fn, p, (h, positions, cache["k"], cache["v"], cache["pos"]),
                  (tuple(h.placements), partial_placements()))


def remat_on(cfg: ModelConfig) -> bool:
    """Whether a cache-free stack recomputes its layers: under grad with
    `cfg.remat`, as the JAX package's `jax.checkpoint` does in its
    backward (with no grad there is nothing to recompute)."""
    return cfg.remat and torch.is_grad_enabled()


_aten = torch.ops.aten
#: the ops whose outputs "dots" keeps: every matrix product (JAX's
#: `dots_saveable` keeps each dot_general's output) and the flash forward's
#: (out, lse, o32), so that its backward launches no flash forward
DOTS = frozenset((_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
                  torch.ops.repro_torch.flash_forward))


# a selective checkpoint's policy: True keeps the op's output (MUST_SAVE),
# False recomputes it (PREFER_RECOMPUTE)
def _save_dots(ctx, op, *args, **kwargs) -> bool:
    return op.overloadpacket in DOTS


def _save_attn_probs(ctx, op, *args, **kwargs) -> bool:
    return current_checkpoint_name() == "attn_probs"


#: `cfg.remat_policy` -> what a checkpointed decoder layer keeps for its
#: backward beside its inputs, as the JAX package's `_scan_layers` picks
#: its `jax.checkpoint` policy: "nothing" recomputes the whole layer,
#: "dots" keeps the products' outputs (`DOTS`) and recomputes the rest,
#: "attn_probs" keeps only the direct path's probabilities (the ops run
#: under `layers.checkpoint_name("attn_probs")`; the flash path names
#: none, so there it keeps what "nothing" keeps). The selective
#: checkpoint's policy sees dispatcher ops only; the flash forward is one
#: (`ops.flash_forward`, a custom op).
REMAT_POLICIES = {"nothing": None, "dots": _save_dots, "attn_probs": _save_attn_probs}


def checkpointed(fn, *args, policy: str = "nothing"):
    """fn(*args) under torch.utils.checkpoint, non-reentrant: the backward
    keeps the inputs, and what `policy` (`REMAT_POLICIES`) keeps, and
    recomputes the rest."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not one of {sorted(REMAT_POLICIES)}")
    keep = REMAT_POLICIES[policy]
    if keep is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts, keep))


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


def decoder_forward(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor | None, *,
                    positions: torch.Tensor, embeds: torch.Tensor | None = None,
                    caches: dict | None = None
                    ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """tokens (B, S) -> (fp32 logits (B, S, V), new caches or None, the
    layers' summed MoE aux loss): the stack (`decoder_hidden`), then the
    fp32 head (`head_weight`) and the logit softcap. `embeds` (B, S, D)
    takes the place of the tokens' embeddings (the VLM's patches and
    text)."""
    h, new_caches, aux = decoder_hidden(params, cfg, tokens, positions=positions,
                                        embeds=embeds, caches=caches)
    if in_region(h):
        head = params.embed if cfg.tie_embeddings else params.unembed
        logits = region(functools.partial(_logits, cfg=cfg), None, (h,), tuple(h.placements),
                        whole=(head,))
        return logits, new_caches, aux
    logits = _logits(None, h, head_weight(params, cfg), cfg=cfg, ready=True)
    return logits, new_caches, aux


def _logits(_, h: torch.Tensor, head: torch.Tensor, *, cfg: ModelConfig,
            ready: bool = False) -> torch.Tensor:
    """The fp32 logits of h against the head (the parameter, or with
    `ready` its (V, D) operand in the activation dtype) and the softcap."""
    if not ready:
        head = head.to(cfg.dtype) if cfg.tie_embeddings else head.to(cfg.dtype).t()
    logits = matmul_f32(h, head.t())
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        if torch.is_grad_enabled() and logits.requires_grad:
            # out of place: tanh keeps its output for the backward
            logits = torch.tanh(logits / cap) * cap
        else:
            # in place: at S = 8,192 the fp32 logits are 8.4 GB
            logits.div_(cap).tanh_().mul_(cap)
    return logits


def decoder_hidden(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor | None, *,
                   positions: torch.Tensor, embeds: torch.Tensor | None = None,
                   caches: dict | None = None
                   ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """tokens (B, S) -> (the final norm's output (B, S, D), new caches or
    None, the MoE aux loss summed over the layers in order, as the JAX
    package's `_scan_layers` sums it): the embedding and the layers.
    Precomputed `embeds` (B, S, D), cast to the activation dtype, replace
    the tokens' embeddings (the VLM stub's patches before its text); the
    positions are then (B, 3, S) M-RoPE channels where the config has
    `mrope_sections`.

    `cfg` governs every layer (the modules' own configs are not read), so
    one set of parameters runs under a changed config, such as a
    `chunked_attn_min_len` that sends a long sequence down the direct path.

    With grad enabled and `cfg.remat`, each cache-free layer runs under
    `torch.utils.checkpoint` (non-reentrant): the backward keeps the
    layer's input and what `cfg.remat_policy` keeps (`REMAT_POLICIES`),
    and recomputes the rest, as the JAX package's `jax.checkpoint` under
    the policy of that name. The gradients are the same bits under every
    policy.
    """
    remat = caches is None and remat_on(cfg)
    sharded = in_region(tokens if embeds is None else embeds)
    if sharded and embeds is None:
        h = region(functools.partial(_embed_tokens, cfg=cfg), None, (tokens,),
                   tuple(tokens.placements), whole=(params.embed,))
    else:
        h = embed_tokens(params.embed, tokens, cfg) if embeds is None else embeds.to(cfg.dtype)
    windows = layer_windows(cfg).tolist()
    auxes = []
    for i, layer in enumerate(params.layers):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": caches["pos"][i]}
        if sharded:
            h = constrain(h, activation_spec())
            if cache is not None:
                h, aux = _cached_layer_region(layer, h, positions, cfg, windows[i], cache)
            elif remat:
                h, aux = checkpointed(_layer_region, layer, h, positions, cfg, windows[i],
                                      policy=cfg.remat_policy)
            else:
                h, aux = _layer_region(layer, h, positions, cfg, windows[i])
        elif remat:
            h, aux = checkpointed(_layer_out, layer, h, cfg, positions, windows[i],
                                  policy=cfg.remat_policy)
        else:
            h, _, aux = decoder_layer(layer, h, cfg, positions=positions,
                                      window=windows[i], cache=cache)
        auxes.append(aux)
    h = apply_norm(params.ln_final, h, cfg)
    new_caches = None
    if caches is not None:
        new_caches = {"k": caches["k"], "v": caches["v"],
                      "pos": caches["pos"] + positions.shape[-1]}
    aux = torch.stack([replicated(a) for a in auxes]).sum() if auxes else \
        torch.zeros((), device=h.device)
    return constrain(h, activation_spec()), new_caches, aux


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The tokens' embeddings in the activation dtype, times sqrt(d_model)
    (rounded to that dtype first, as in JAX) where `cfg.embed_scale`."""
    h = embed.to(cfg.dtype)[tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return h


def _embed_tokens(_, tokens: torch.Tensor, embed: torch.Tensor, *, cfg: ModelConfig
                  ) -> torch.Tensor:
    return embed_tokens(embed, tokens, cfg)


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
    """Mean next-token CE over valid (label >= 0) positions; under a mesh
    each rank's sums of its rows, added over the ranks."""
    if in_region(logits):
        total, n = region(_nll_sums, None, (logits, labels),
                          (partial_placements(), partial_placements()))
        total, n = replicated(total), replicated(n).clamp(min=1.0)
        loss = total / n
        return loss, {"ce": loss, "tokens": n}
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    nll = (lse - gold) * valid
    n = valid.sum().clamp(min=1.0)
    loss = nll.sum() / n
    return loss, {"ce": loss, "tokens": n}


def _nll_sums(_, logits: torch.Tensor, labels: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the summed loss of the valid rows, their count), each divided by
    the ranks that hold the same rows (a region's Partial outputs)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    total, n = ((lse - gold) * valid).sum(), valid.sum()
    reps = seq_shard().replicas
    return (total / reps, n / reps) if reps > 1 else (total, n)


def final_logits(h: torch.Tensor, scale: torch.Tensor, embed: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The fp32 logits of the final RMS norm of h against the tied embedding
    (the xLSTM's and Zamba2's head); under a mesh each rank's rows."""
    def fn(_, x, sc, emb):
        return matmul_f32(rms_norm(x, sc, cfg.norm_eps), emb.to(cfg.dtype).t())

    if in_region(h):
        return region(fn, None, (h,), tuple(h.placements), whole=(scale, embed))
    return fn(None, h, scale, embed)


def sharded_embed(embed: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """`embed_tokens`, under a mesh in a region (each rank its tokens'
    rows, the embedding entering whole)."""
    if in_region(tokens):
        return region(functools.partial(_embed_tokens, cfg=cfg), None, (tokens,),
                      tuple(tokens.placements), whole=(embed,))
    return embed_tokens(embed, tokens, cfg)


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
    if in_region(h):
        head = params.embed if cfg.tie_embeddings else params.unembed
        total, n = region(functools.partial(_head_sums, cfg=cfg), None, (h, labels),
                          (partial_placements(), partial_placements()), whole=(head,))
        total, n = replicated(total), replicated(n).clamp(min=1.0)
    else:
        total, n = _head_sums(None, h, labels, head_weight(params, cfg), cfg=cfg, ready=True)
        n = n.clamp(min=1.0)
    loss = total / n
    return loss, {"ce": loss, "tokens": n}


def _head_sums(_, h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor, *,
               cfg: ModelConfig, ready: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(the summed loss of the valid rows, their count) of h against the
    head (`_logits`'s `head` and `ready`); in a region each divided by
    the ranks that hold the same tokens (the region's Partial outputs)."""
    if not ready:
        head = head.to(cfg.dtype) if cfg.tie_embeddings else head.to(cfg.dtype).t()
    labels = labels.reshape(-1)
    n = (labels >= 0).float().sum()
    total = HeadLoss.apply(h.reshape(-1, h.shape[-1]), head, labels, cfg.logit_softcap)
    sh = seq_shard()
    if sh is not None and sh.replicas > 1:
        total, n = total / sh.replicas, n / sh.replicas
    return total, n


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
        for i in steps(-(-h.shape[0] // HEAD_CHUNK)):
            lo = i * HEAD_CHUNK
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
        for i in steps(-(-h.shape[0] // HEAD_CHUNK)):
            lo = i * HEAD_CHUNK
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
# Encoder-decoder (whisper backbone; the conv frontend is a stub)
# ---------------------------------------------------------------------------
class EncoderLayer(nn.Module):
    """A whisper encoder layer's parameters: layer norms, attention, MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.ln_attn = LayerNorm(cfg, device=device)
        self.attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_mlp = LayerNorm(cfg, device=device)
        self.mlp: MLP = init_mlp(cfg, generator=generator, device=device)


class CrossDecoderLayer(nn.Module):
    """A whisper decoder layer's parameters: causal self-attention,
    cross-attention over the encoder's output, MLP, each after a layer
    norm."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.ln_self = LayerNorm(cfg, device=device)
        self.self_attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_cross = LayerNorm(cfg, device=device)
        self.cross_attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_mlp = LayerNorm(cfg, device=device)
        self.mlp: MLP = init_mlp(cfg, generator=generator, device=device)


class EncDec(nn.Module):
    """Whisper's parameters: the encoder's learned positions (encoder_seq
    rows), its layers and final norm, the tied token embedding, the
    decoder's learned positions (`max_dec_len` rows), its layers and final
    norm; the arithmetic is `encoder_forward` and `encdec_forward`. Every
    norm is a layer norm, whatever `cfg.norm_type` says, as in the JAX
    package."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device, max_dec_len: int = 0):
        super().__init__()
        d = cfg.d_model

        def table(rows):
            return nn.Parameter(dense_init(generator, (rows, d), cfg.param_dtype, device,
                                           scale=0.02))

        self.enc_pos = table(cfg.encoder_seq)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, generator=generator, device=device)
            for _ in range(cfg.encoder_layers))
        self.enc_ln_final = LayerNorm(cfg, device=device)
        self.embed = table(cfg.vocab_size)
        self.dec_pos = table(max_dec_len or 4096)
        self.dec_layers = nn.ModuleList(
            CrossDecoderLayer(cfg, generator=generator, device=device)
            for _ in range(cfg.n_layers))
        self.dec_ln_final = LayerNorm(cfg, device=device)


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator | None,
                device: torch.device, max_dec_len: int = 0) -> EncDec:
    """Whisper's parameters drawn from `generator` on `device` (the JAX
    initialisers' distributions, not their numbers), or left empty for
    `load_numpy` when generator is None; max_dec_len 0 means 4,096 decoder
    positions, as in the JAX package."""
    return EncDec(cfg, generator=generator, device=device, max_dec_len=max_dec_len)


def _ln(p: LayerNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, p.scale, p.bias, cfg.norm_eps)


def encoder_layer(p: EncoderLayer, h: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm non-causal self-attention (no RoPE) and MLP, each added."""
    a, _ = attention_block(p.attn, _ln(p.ln_attn, h, cfg), cfg, positions=positions,
                           causal=False, use_rope=False)
    h = h + a
    return h + mlp_block(p.mlp, _ln(p.ln_mlp, h, cfg), cfg)


def encoder_forward(params: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, D), the conv frontend's stub output -> the encoder's
    output (B, S_enc, D) in the activation dtype, after its final norm."""
    remat = remat_on(cfg)
    if in_region(frames):
        def add_pos(_, f, pos):
            sh = seq_shard()
            pos = pos.to(cfg.dtype)
            return f.to(cfg.dtype) + (seq_chunk(pos, 0) if sh.seq else pos)[None]

        h = region(add_pos, None, (frames,), tuple(frames.placements), whole=(params.enc_pos,))
        for layer in params.enc_layers:
            h = constrain(h, activation_spec())
            if remat:
                h = checkpointed(_encoder_region, layer, h, cfg)
            else:
                h = _encoder_region(layer, h, cfg)
        return _ln(params.enc_ln_final, h, cfg)
    h = frames.to(cfg.dtype) + params.enc_pos.to(cfg.dtype)[None]
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device).expand(h.shape[:2])
    for layer in params.enc_layers:
        if remat:
            h = checkpointed(encoder_layer, layer, h, cfg, positions)
        else:
            h = encoder_layer(layer, h, cfg, positions)
    return _ln(params.enc_ln_final, h, cfg)


def _encoder_region(layer: EncoderLayer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """An encoder layer under a mesh: the rank's frames attend over all of
    them (K and V gathered, `attention_block`); no RoPE reads positions."""
    def fn(p, x):
        pos = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
        return encoder_layer(p, x, cfg, pos)

    return region(fn, layer, (h,), tuple(h.placements))


def crossdec_layer(p: CrossDecoderLayer, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, enc_out: torch.Tensor | None,
                   self_cache: dict | None = None, cross_cache: dict | None = None
                   ) -> torch.Tensor:
    """Pre-norm causal self-attention (no RoPE; a decode cache where given),
    cross-attention over enc_out or the static cross cache, and MLP, each
    added. The self cache is written in place."""
    a, _ = attention_block(p.self_attn, _ln(p.ln_self, h, cfg), cfg, positions=positions,
                           causal=True, cache=self_cache, use_rope=False)
    h = h + a
    c_in = _ln(p.ln_cross, h, cfg)
    if cross_cache is not None:
        c, _ = attention_block(p.cross_attn, c_in, cfg, positions=positions, causal=False,
                               cache=cross_cache, use_rope=False)
    else:
        c, _ = attention_block(p.cross_attn, c_in, cfg, positions=positions, causal=False,
                               kv_src=enc_out, use_rope=False)
    h = h + c
    return h + mlp_block(p.mlp, _ln(p.ln_mlp, h, cfg), cfg)


def encdec_hidden(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor | None, *, pos_offset: torch.Tensor | int = 0,
                  caches: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (the decoder's final norm output (B, S, D), new
    caches or None). The decoder positions start at `pos_offset` (its rows
    of `dec_pos` clamped into the table, as `jax.lax.dynamic_slice_in_dim`
    clamps them). With `caches` ({"k", "v", "pos", "ck", "cv"}) the
    self-attention K/V are written in place and the cross-attention reads
    "ck"/"cv" (enc_out is not read); without, it attends over enc_out.
    Under a mesh the positions start at caches["pos"][0] (which is every
    caller's pos_offset), or at 0 without caches."""
    b, s = tokens.shape
    dev = tokens.device
    if in_region(tokens):
        if caches is None and not (isinstance(pos_offset, int) and pos_offset == 0):
            raise ValueError("whisper's decoder on a mesh without caches runs from position 0")
        return _encdec_hidden_sharded(params, cfg, tokens, enc_out, caches)
    h = params.embed.to(cfg.dtype)[tokens] + _dec_pos_rows(params.dec_pos, pos_offset, s, cfg)
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    positions = (pos_offset + steps).expand(b, s)
    remat = caches is None and remat_on(cfg)
    for i, layer in enumerate(params.dec_layers):
        if caches is not None:
            h = crossdec_layer(layer, h, cfg, positions, None,
                               {"k": caches["k"][i], "v": caches["v"][i], "pos": caches["pos"][i]},
                               {"k": caches["ck"][i], "v": caches["cv"][i]})
        elif remat:
            h = checkpointed(crossdec_layer, layer, h, cfg, positions, enc_out)
        else:
            h = crossdec_layer(layer, h, cfg, positions, enc_out)
    h = _ln(params.dec_ln_final, h, cfg)
    new_caches = None
    if caches is not None:
        new_caches = dict(caches, pos=caches["pos"] + s)
    return h, new_caches


def _dec_pos_rows(table: torch.Tensor, pos_offset: torch.Tensor | int, s: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Rows pos_offset .. pos_offset + s - 1 of the decoder's position table
    as (1, s, D) in the activation dtype, the start clamped into the table
    as `jax.lax.dynamic_slice_in_dim` clamps it."""
    steps = torch.arange(s, dtype=torch.int32, device=table.device)
    start = torch.as_tensor(pos_offset, device=table.device).clamp(0, table.shape[0] - s)
    return table.to(cfg.dtype).index_select(0, (start + steps).long())[None]


def _encdec_hidden_sharded(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                           enc_out: torch.Tensor | None, caches: dict | None
                           ) -> tuple[torch.Tensor, dict | None]:
    """`encdec_hidden` under a mesh: each rank's tokens with their rows of
    the position table, from position 0 without caches (the loss) and
    from caches["pos"][0] with them (a prefill's is 0; the callers' pos_offset
    is it), clamped as the mesh-free path clamps them; each layer a region.
    Cache-free, the cross-attention's K and V come from the encoder's
    output, whole over the sequence axis. With caches (a prefill, or a
    decode step: tokens and caches placed by `input_pspecs` and
    `cache_pspecs`), the self-attention writes the tokens' K/V in their
    slots (the rank that holds each) and takes the split softmax over the
    cache's shards of the sequence (`attention_block`); the
    cross-attention reads "ck"/"cv" at their placements, the batch over
    the batch axes, the sequence sharded where "model" divides the frames
    (joined by the split softmax without causality) or whole (1,500 at full
    width). Where a prefill's activations shard their sequence, each rank
    of it holds other queries, so there the cross caches are taken whole
    over the sequence. No cache is gathered, nor the cross-attention's K
    and V weights, which the cached step does not read."""
    s = tokens.shape[1]
    at = () if caches is None else (caches["pos"],)

    def embed(_, toks, *rest):
        sh = seq_shard()
        start = sh.index * toks.shape[1] if sh.seq else 0
        if at:
            start = rest[0][0] + start
        emb, table = rest[-2:]
        return emb.to(cfg.dtype)[toks] + _dec_pos_rows(table, start, toks.shape[1], cfg)

    h = region(embed, None, (tokens, *at), tuple(tokens.placements),
               whole=(params.embed, params.dec_pos))
    if caches is not None:
        ck, cv = caches["ck"], caches["cv"]
        if sharded_axes(constrain(h, activation_spec()), 1):
            whole = (None, BATCH_AXES, None, None, None)
            ck, cv = constrain(ck, whole), constrain(cv, whole)
        axes, cross = sharded_axes(caches["k"], 2), sharded_axes(ck, 2)

        def cached(p, x, k, v, pos, xk, xv):
            pp = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
            return crossdec_layer(p, x, cfg, pp, None, {"k": k, "v": v, "pos": pos, "axes": axes},
                                  {"k": xk, "v": xv, "axes": cross})

        unread = tuple(f"cross_attn.{n}" for n, _ in
                       params.dec_layers[0].cross_attn.named_parameters()
                       if n in ("wk", "wv", "bk", "bv"))
        for i, layer in enumerate(params.dec_layers):
            h = constrain(h, activation_spec())
            h = region(cached, layer, (h, caches["k"][i], caches["v"][i], caches["pos"][i],
                                       ck[i], cv[i]), tuple(h.placements), unread=unread)
        return _ln(params.dec_ln_final, h, cfg), dict(caches, pos=caches["pos"] + s)
    enc = constrain(enc_out, (BATCH_AXES, None, None))
    remat = remat_on(cfg)

    def layer_fn(p, x, e):
        pos = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
        return crossdec_layer(p, x, cfg, pos, e)

    def run(p, x, e):
        return region(layer_fn, p, (x, e), tuple(x.placements))

    for layer in params.dec_layers:
        h = constrain(h, activation_spec())
        h = checkpointed(run, layer, h, enc) if remat else run(layer, h, enc)
    return _ln(params.dec_ln_final, h, cfg), None


def encdec_forward(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_out: torch.Tensor | None, *, pos_offset: torch.Tensor | int = 0,
                   caches: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (fp32 logits (B, S, V) against the tied embedding,
    new caches or None): `encdec_hidden`, then the head."""
    h, new_caches = encdec_hidden(params, cfg, tokens, enc_out, pos_offset=pos_offset,
                                  caches=caches)
    if in_region(h):
        return region(functools.partial(_logits, cfg=cfg), None, (h,), tuple(h.placements),
                      whole=(params.embed,)), new_caches
    return matmul_f32(h, params.embed.to(cfg.dtype).t()), new_caches


def init_cross_cache(params: EncDec, cfg: ModelConfig, enc_out: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K and V of the encoder output,
    stacked: two (L, B, S_enc, Hk, hd) tensors in the activation dtype;
    under a mesh each layer's a region, placed as the encoder's output."""
    if in_region(enc_out):
        def kv(p, e):
            return _cross_kv(p, e, cfg)

        pl = tuple(enc_out.placements)
        pairs = [region(kv, layer.cross_attn, (enc_out,), (pl, pl)) for layer in params.dec_layers]
        return torch.stack([k for k, _ in pairs]), torch.stack([v for _, v in pairs])
    pairs = [_cross_kv(layer.cross_attn, enc_out, cfg) for layer in params.dec_layers]
    return torch.stack([k for k, _ in pairs]), torch.stack([v for _, v in pairs])


def _cross_kv(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-attention K and V of the encoder output, each
    (B, S_enc, Hk, hd)."""
    b, se, _ = enc_out.shape
    k = (enc_out @ p.wk.to(cfg.dtype)).reshape(b, se, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p.wv.to(cfg.dtype)).reshape(b, se, cfg.n_kv_heads, cfg.hd)
    if cfg.qkv_bias:
        k = k + p.bk.to(cfg.dtype).reshape(cfg.n_kv_heads, cfg.hd)
        v = v + p.bv.to(cfg.dtype).reshape(cfg.n_kv_heads, cfg.hd)
    return k, v


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
