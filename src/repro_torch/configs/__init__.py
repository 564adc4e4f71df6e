"""Architecture registry of the port.

`get_config(name)` returns the full published config of a ported
architecture; `reduced(cfg)` shrinks it to a CPU-runnable size of the same
family, as `repro.configs.reduced` does. Only gemma2-2b is ported so far;
any other name raises NotImplementedError, naming ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.gemma2_2b import CONFIG as gemma2_2b
from repro_torch.models.layers import ModelConfig

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in (gemma2_2b,)}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in REGISTRY:
        raise NotImplementedError(
            f"{name} is not an architecture of repro_torch (ported: "
            f"{sorted(REGISTRY)}); ROADMAP.md (queue 1, item 12) lists the LM "
            f"modules left to port, in order")
    return REGISTRY[key]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU tests: the JAX package's dense rule."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family} is not ported; see ROADMAP.md")
    upd: dict = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        vocab_size=512,
        remat=False,
        chunked_attn_min_len=64,
        attn_chunk=32,
        n_layers=2,
        d_ff=256,
    )
    if cfg.sliding_window:
        upd.update(sliding_window=16, local_global_period=cfg.local_global_period)
    return dataclasses.replace(cfg, **upd)


__all__ = ["REGISTRY", "get_config", "reduced", "ModelConfig"]
