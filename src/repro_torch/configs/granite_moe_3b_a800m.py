"""granite-moe-3b-a800m [moe]: IBM Granite 3.0 MoE family.

32L d_model=1536 24H (GQA kv=8, head_dim 64) expert d_ff=512, vocab
49155, 40 experts top-8, tied embeddings. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
Experts are padded 40 -> 48 so that the expert axis divides the JAX
package's 16-wide model mesh axis (the 8 pad experts are never routed to;
17% more expert weights). A copy of `repro/configs/granite_moe_3b_a800m.py`,
field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    moe_d_ff=512,
    n_experts=40,
    n_experts_pad=48,
    n_experts_active=8,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
