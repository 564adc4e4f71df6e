"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8, head_dim 112) expert d_ff=2048,
vocab 163840, 384 experts top-8. [arXiv:2501.kimi2; unverified].
Deviations noted: the real K2 uses MLA and one dense layer + shared expert;
the assigned spec pins GQA kv=8 and uniform MoE, which we follow.
bf16 AdamW moments; `fsdp_pod` shards the JAX package's parameters over
its pod axis too and has no effect without a mesh. 1.03 T parameters: on
one H100 it runs only on the meta device (`launch/dryrun.py`), which
reports that it does not fit. A copy of `repro/configs/kimi_k2_1t_a32b.py`,
field for field.
"""
import torch

from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=0,
    moe_d_ff=2048,
    n_experts=384,
    n_experts_active=8,
    vocab_size=163_840,
    tie_embeddings=False,
    rope_theta=50_000.0,
    moment_dtype=torch.bfloat16,
    fsdp_pod=True,
)
