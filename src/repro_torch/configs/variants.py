"""Perf variants: the overlay `optimized` of `repro/configs/variants.py`,
field for field.

`optimized(cfg)` sets:
  - `attn_probs_bf16`: the direct attention path's probabilities (and v)
    in bf16 before P V. The flash kernel writes no probability tensor, so
    the flag changes nothing where the kernel runs;
  - for an MoE config, `moe_group_dispatch` (per-sequence dispatch groups:
    routing, sort and capacity per sequence) and `moe_ep_shard_map`, which
    acts only on a device mesh whose "model" axis is wider than one (the
    expert-parallel region, `models/layers.py::_moe_sharded`): elsewhere
    it falls through to the grouped dispatch, as the JAX package's does
    without a mesh;
  - for the hybrid, the SSD scan at a chunk of 64 with its decay folded
    into B and C (`ssd_fold_decay`).
remat_policy stays "nothing", and chunked_attn_min_len where it is, as in
the JAX overlay. "base" is the config as it is.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.layers import ModelConfig


def optimized(cfg: ModelConfig) -> ModelConfig:
    upd: dict = dict(attn_probs_bf16=True)
    if cfg.is_moe:
        upd["moe_group_dispatch"] = True
        upd["moe_ep_shard_map"] = True
    if cfg.family in ("hybrid",):
        upd.update(ssm_chunk=64, ssd_fold_decay=True)
    return dataclasses.replace(cfg, **upd)


VARIANTS = {
    "base": lambda c: c,
    "opt": optimized,
}


def apply_variant(cfg: ModelConfig, name: str) -> ModelConfig:
    return VARIANTS[name](cfg)
