"""whisper-medium [audio]: encoder-decoder backbone; the conv frontend is a stub.

24+24L d_model=1024 16H (head_dim 64) d_ff=4096 vocab 51865, encoder of
1500 frames. [arXiv:2212.04356; unverified]. The mel and conv frontend
is a stub: a batch carries precomputed (B, 1500, d) frame embeddings.
Layer norms, GELU and QKV biases, as the original; the MLP is gated, as
the JAX config's default leaves it. A copy of
`repro/configs/whisper_medium.py`, field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    norm_type="layer",
    mlp_act="gelu",
    qkv_bias=True,
    tie_embeddings=True,
)
