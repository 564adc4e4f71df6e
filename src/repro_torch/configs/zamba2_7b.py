"""zamba2-7b [hybrid]: Mamba2 backbone + a shared attention block.

81L d_model=3584 32H (kv=32, head_dim 112) d_ff=14336 vocab 32000,
ssm_state=64. [arXiv:2411.15242; unverified]. 3 groups of 27 Mamba2
layers, each followed by one application of a weight-tied attention + MLP
block. Mamba2: expand 2 -> d_inner 7168, headdim 64 -> 112 SSD heads. A
copy of `repro/configs/zamba2_7b.py`, field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=27,
    tie_embeddings=True,
)
