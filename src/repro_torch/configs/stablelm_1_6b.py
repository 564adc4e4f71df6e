"""stablelm-1.6b [dense]: full MHA (kv=32), LayerNorm.

24L d_model=2048 32H (kv=32, head_dim 64) d_ff=5632 vocab 100352, layer
norm, untied head, gated SiLU MLP, no QKV bias.
[hf:stabilityai/stablelm-2-1_6b; unverified]. A copy of
`repro/configs/stablelm_1_6b.py`, field for field, with its deviations
from the HF config: full rotary over all 64 dimensions of a head (HF
rotates a quarter of them), and the default norm_eps of 1e-6 (HF's
layer_norm_eps is 1e-5).
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    norm_type="layer",
    tie_embeddings=False,
    qkv_bias=False,
)
