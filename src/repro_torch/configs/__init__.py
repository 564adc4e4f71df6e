"""Architecture registry of the port.

`get_config(name)` returns the full published config of a ported
architecture; `reduced(cfg)` shrinks it to a CPU-runnable size of the same
family, as `repro.configs.reduced` does. The dense configs, the MoE
granite-moe-3b-a800m, the SSM xlstm-350m, the hybrid zamba2-7b, the audio
whisper-medium, the VLM qwen2-vl-7b and the trillion-parameter MoE
kimi-k2-1t-a32b (which runs only on the meta device here: the dry-run,
`launch/dryrun.py`) are ported; any other name raises NotImplementedError.
`apply_variant(cfg, "opt")` applies the JAX package's perf overlay
(`configs/variants.py`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.gemma2_2b import CONFIG as gemma2_2b
from repro_torch.configs.granite_20b import CONFIG as granite_20b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl_7b
from repro_torch.configs.smollm_360m import CONFIG as smollm_360m
from repro_torch.configs.stablelm_1_6b import CONFIG as stablelm_1_6b
from repro_torch.configs.variants import VARIANTS, apply_variant, optimized
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.xlstm_350m import CONFIG as xlstm_350m
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.models.layers import ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (granite_moe_3b_a800m, kimi_k2_1t_a32b, granite_20b, gemma2_2b, stablelm_1_6b,
              smollm_360m, xlstm_350m, whisper_medium, zamba2_7b, qwen2_vl_7b)
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in REGISTRY:
        raise NotImplementedError(
            f"{name} is not an architecture of repro_torch (ported: {sorted(REGISTRY)}); "
            "ROADMAP.md lists what is left to port")
    return REGISTRY[key]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU tests: the JAX package's rules. Dense
    and MoE: 2 layers, and for an MoE config 8 experts, top 2, expert d_ff
    64, capacity factor 8 (no replica is dropped). SSM: 4 layers in groups
    of 2 (one mLSTM and one sLSTM). Hybrid: 4 Mamba2 layers with the shared
    block every 2, d_ff 256, SSM state 16, SSD heads of 32. Audio: 2
    encoder and 2 decoder layers, 24 frames, d_ff 256. VLM: 2 layers, d_ff
    256, 8 patches, M-RoPE sections (4, 6, 6) (hd / 2 = 16)."""
    upd: dict = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        vocab_size=512,
        remat=False,
        chunked_attn_min_len=64,
        attn_chunk=32,
    )
    if cfg.family == "ssm":
        upd.update(n_layers=4, slstm_every=2, d_ff=0)
    elif cfg.family == "hybrid":
        upd.update(n_layers=4, attn_every=2, d_ff=256, ssm_state=16, ssm_headdim=32)
    elif cfg.family == "audio":
        upd.update(n_layers=2, encoder_layers=2, encoder_seq=24, d_ff=256)
    else:
        upd.update(n_layers=2, d_ff=256)
    if cfg.is_moe:
        upd.update(n_experts=8, n_experts_pad=8, n_experts_active=2, moe_d_ff=64,
                   d_ff=0, capacity_factor=8.0)
    if cfg.family == "vlm":
        upd.update(n_patches=8)
    if cfg.mrope_sections:
        upd.update(mrope_sections=(4, 6, 6))  # sums to head_dim / 2 = 16
    if cfg.sliding_window:
        upd.update(sliding_window=16, local_global_period=cfg.local_global_period)
    return dataclasses.replace(cfg, **upd)


__all__ = ["REGISTRY", "VARIANTS", "ModelConfig", "apply_variant", "get_config",
           "optimized", "reduced"]
