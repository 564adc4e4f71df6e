"""The Zamba2-style hybrid, ported from `repro/models/zamba.py`: a Mamba2
backbone and one *shared* attention + MLP block applied after every
`attn_every` Mamba2 layers, its weights tied across the applications.

The shared block is the decoder's `attention_block` and `mlp_block`: a
cache-free sequence of at least `chunked_attn_min_len` tokens takes the
flash kernel (zamba2-7b: 32 heads of 112, one launch an application; with
grad one backward launch too, as remat recomputes only the Mamba2 blocks),
a prefill or decode step the direct path. Each application keeps its own
K/V cache ("attn_k", "attn_v": (G, B, T, Hk, hd)), written in place, as
are the stacked Mamba2 states: the states passed in are consumed.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (
    Attention,
    MLP,
    ModelConfig,
    activation_spec,
    attention_block,
    constrain,
    dense_init,
    in_region,
    init_attention,
    init_mlp,
    matmul_f32,
    mlp_block,
    region,
    rms_norm,
    seq_region,
    sharded_axes,
    state_part,
    state_region,
)
from repro_torch.models.mamba import (
    Mamba2Block,
    Mamba2State,
    mamba2_block,
    mamba2_init_state,
)
from repro_torch.models.transformer import (
    RMSNorm,
    apply_norm,
    checkpointed,
    final_logits,
    init_norm,
    remat_on,
    sharded_embed,
)


def zamba_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, Mamba2 layers a group): the shared block follows each group."""
    n_per = cfg.attn_every
    return cfg.n_layers // n_per, n_per


class SharedBlock(nn.Module):
    """The one attention + MLP block every group applies; the arithmetic
    is `shared_block`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        self.ln_attn = init_norm(cfg, device=device)
        self.attn: Attention = init_attention(cfg, generator=generator, device=device)
        self.ln_mlp = init_norm(cfg, device=device)
        self.mlp: MLP = init_mlp(cfg, generator=generator, device=device)


class Zamba(nn.Module):
    """The hybrid's parameters: the tied embedding, `mamba[g][i]`, the one
    `shared` block and the final norm; the arithmetic is `zamba_forward`."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None,
                 device: torch.device):
        super().__init__()
        n_groups, n_per = zamba_groups(cfg)
        self.embed = nn.Parameter(dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                             cfg.param_dtype, device, scale=0.02))
        self.mamba = nn.ModuleList(
            nn.ModuleList(Mamba2Block(cfg, generator=generator, device=device)
                          for _ in range(n_per))
            for _ in range(n_groups))
        self.shared = SharedBlock(cfg, generator=generator, device=device)
        self.ln_final = RMSNorm(cfg, device=device)


def init_zamba(cfg: ModelConfig, *, generator: torch.Generator | None,
               device: torch.device) -> Zamba:
    """Parameters drawn from `generator` on `device` (the JAX initialisers'
    distributions, not their numbers), or left empty for
    `params_from_numpy` when generator is None."""
    return Zamba(cfg, generator=generator, device=device)


def shared_block(p: SharedBlock, h: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, cache: dict | None = None
                 ) -> tuple[torch.Tensor, dict | None]:
    """One application of the shared block: pre-norm causal attention (no
    window), then the pre-norm MLP, each added to h."""
    a, new_cache = attention_block(p.attn, apply_norm(p.ln_attn, h, cfg), cfg,
                                   positions=positions, cache=cache)
    h = h + a
    return h + mlp_block(p.mlp, apply_norm(p.ln_mlp, h, cfg), cfg), new_cache


def zamba_forward(params: Zamba, cfg: ModelConfig, tokens: torch.Tensor, *,
                  positions: torch.Tensor, states: dict | None = None,
                  chunk: int | None = None, prefill: bool = False
                  ) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> (fp32 logits (B, S, V), new states or None).

    With `states` (`zamba_init_states`'s layout) each Mamba2 layer starts
    from its state and conv cache and each application of the shared block
    attends over its own group's K/V cache from its position; all are
    updated in place, and the returned dict carries "attn_pos" + S.
    Without states, under grad with `cfg.remat`, each Mamba2 block (its
    residual add included) runs under torch.utils.checkpoint and is
    recomputed in the backward, the JAX package's `jax.checkpoint(m_body)`;
    the shared block stays outside it, as there.

    Under a mesh (tokens a DTensor) each Mamba2 block is a `seq_region`
    (its scan over the whole sequence on every rank of the sequence axis)
    and each application of the shared block a region whose queries are
    the rank's; a prefill's Mamba2 states come from the regions (`prefill`
    says the states given are `zamba_init_states`' zeros). A decode step
    on a mesh takes the states at their placements: each Mamba2 block a
    `state_region` that updates the rank's pieces in place, each
    application of the shared block the split softmax over its K/V cache's
    shards (`_zamba_decode_sharded`)."""
    if in_region(tokens):
        if states is not None and not prefill:
            return _zamba_decode_sharded(params, cfg, tokens, positions, states)
        return _zamba_sharded(params, cfg, tokens, positions, states, chunk)
    h = params.embed.to(cfg.dtype)[tokens]
    decode = states is not None
    remat = not decode and remat_on(cfg)
    for g, group in enumerate(params.mamba):
        for i, block in enumerate(group):
            if remat:
                h = checkpointed(_mamba_residual, block, h, cfg, chunk)
                continue
            st = None
            if decode:
                st = Mamba2State(h=states["mamba_h"][g, i], conv=states["mamba_conv"][g, i])
            out, new_st = mamba2_block(block, h, cfg, st, chunk=chunk)
            h = h + out
            if decode:
                states["mamba_h"][g, i].copy_(new_st.h)
                states["mamba_conv"][g, i].copy_(new_st.conv)
        cache = None
        if decode:
            cache = {"k": states["attn_k"][g], "v": states["attn_v"][g],
                     "pos": states["attn_pos"][g]}
        h, _ = shared_block(params.shared, h, cfg, positions=positions, cache=cache)
    h = rms_norm(h, params.ln_final.scale, cfg.norm_eps)
    logits = matmul_f32(h, params.embed.to(cfg.dtype).t())
    new_states = None
    if decode:
        new_states = dict(states, attn_pos=states["attn_pos"] + tokens.shape[1])
    return logits, new_states


def _zamba_sharded(params: Zamba, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, states: dict | None, chunk: int | None
                   ) -> tuple[torch.Tensor, dict | None]:
    """`zamba_forward` under a mesh from zero states: the loss's forward, or a
    prefill (`states`: `zamba_init_states`' zeros), which writes the shared
    block's K/V caches in place and returns the Mamba2 states."""
    prefill = states is not None
    remat = not prefill and remat_on(cfg)
    h = sharded_embed(params.embed, tokens, cfg)
    new_m: list = []

    def m_fn(blk, x):
        if not prefill:
            return (mamba2_block(blk, x, cfg, None, chunk=chunk)[0],)
        out, nst = mamba2_block(blk, x, cfg, mamba2_init_state(cfg, x.shape[0], device=x.device),
                                chunk=chunk)
        return out, nst.h, nst.conv

    def m_step(blk, x):
        return seq_region(m_fn, blk, x)[0]

    axes = sharded_axes(states["attn_k"], 2) if prefill else ()

    def shared(p, x, pp, *cache):
        c = dict(zip(("k", "v", "pos"), cache), axes=axes) if cache else None
        return shared_block(p, x, cfg, positions=pp, cache=c)[0]

    for g, group in enumerate(params.mamba):
        for block in group:
            h = constrain(h, activation_spec())
            if remat:
                h = checkpointed(m_step, block, h)
                continue
            h, *st = seq_region(m_fn, block, h, 2 if prefill else 0)
            new_m.append(st)
        h = constrain(h, activation_spec())
        cache = (states["attn_k"][g], states["attn_v"][g], states["attn_pos"][g]) \
            if prefill else ()
        h = region(shared, params.shared, (h, positions, *cache), tuple(h.placements))
    logits = final_logits(h, params.ln_final.scale, params.embed, cfg)
    if not prefill:
        return logits, None
    n_groups, n_per = zamba_groups(cfg)
    stack = [torch.stack([torch.stack([new_m[g * n_per + i][j] for i in range(n_per)])
                          for g in range(n_groups)]) for j in range(2)]
    return logits, dict(states, mamba_h=stack[0], mamba_conv=stack[1],
                        attn_pos=states["attn_pos"] + tokens.shape[1])


def _zamba_decode_sharded(params: Zamba, cfg: ModelConfig, tokens: torch.Tensor,
                          positions: torch.Tensor, states: dict) -> tuple[torch.Tensor, dict]:
    """One decode step of `zamba_forward` under a mesh: tokens (B, 1) and
    positions placed by `input_pspecs`, the states by `cache_pspecs`. Each
    Mamba2 block is a `state_region` (`ssd_step`, `conv_step` on the
    rank's pieces of "mamba_h" and "mamba_conv", in place); each
    application of the shared block attends over its group's K/V cache,
    sharded on its sequence over SEQ_AXIS, or over ("data", SEQ_AXIS) for
    one long sequence, by the split softmax, the new token's K/V written
    in its slot by the rank that holds it. "attn_pos" advances by one, as
    the mesh-free step's."""
    h = sharded_embed(params.embed, tokens, cfg)
    leaves = (states["mamba_h"], states["mamba_conv"])
    axes = sharded_axes(states["attn_k"], 2)

    def m_fn(g, i):
        def fn(blk, x, dims, *local):
            parts = tuple(state_part(t, (g, i), d) for t, d in zip(local, dims))
            return x + mamba2_block(blk, x, cfg, None, parts=parts)[0]
        return fn

    def shared(p, x, pp, k, v, pos):
        return shared_block(p, x, cfg, positions=pp,
                            cache={"k": k, "v": v, "pos": pos, "axes": axes})[0]

    for g, group in enumerate(params.mamba):
        for i, block in enumerate(group):
            h = state_region(m_fn(g, i), block, constrain(h, activation_spec()), leaves, 2)
        h = constrain(h, activation_spec())
        h = region(shared, params.shared, (h, positions, states["attn_k"][g],
                                           states["attn_v"][g], states["attn_pos"][g]),
                   tuple(h.placements))
    logits = final_logits(h, params.ln_final.scale, params.embed, cfg)
    return logits, dict(states, attn_pos=states["attn_pos"] + tokens.shape[1])


def _mamba_residual(block: Mamba2Block, h: torch.Tensor, cfg: ModelConfig,
                    chunk: int | None) -> torch.Tensor:
    """h plus a stateless Mamba2 block's output: the function a checkpoint
    wraps."""
    return h + mamba2_block(block, h, cfg, None, chunk=chunk)[0]


def zamba_init_states(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: torch.device | str = "cpu") -> dict:
    """{"mamba_h": (G, n_per, B, H, N, P) fp32, "mamba_conv": (G, n_per, B,
    W - 1, C), "attn_k" / "attn_v": (G, B, max_len, Hk, hd) in the
    activation dtype, "attn_pos": (G,) int32}, as the JAX package lays them
    out."""
    n_groups, n_per = zamba_groups(cfg)
    m0 = mamba2_init_state(cfg, batch, device=device)
    kv = (n_groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "mamba_h": m0.h.expand((n_groups, n_per) + m0.h.shape).clone(),
        "mamba_conv": m0.conv.expand((n_groups, n_per) + m0.conv.shape).clone(),
        "attn_k": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "attn_pos": torch.zeros(n_groups, dtype=torch.int32, device=device),
    }
