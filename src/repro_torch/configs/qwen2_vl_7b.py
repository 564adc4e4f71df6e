"""qwen2-vl-7b [vlm]: M-RoPE; the vision tower is a stub.

28L d_model=3584 28H (GQA kv=4, head_dim 128) d_ff=18944 vocab 152064.
[arXiv:2409.12191; hf]. The vision tower is a stub: a batch carries
precomputed patch embeddings (1024 patches) that are put before the text
tokens, and (B, 3, S) positions carry the (t, h, w) M-RoPE channels with
sections (16, 24, 24) over the 64 rotary frequency lanes. A copy of
`repro/configs/qwen2_vl_7b.py`, field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    n_patches=1024,
)
