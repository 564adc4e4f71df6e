"""granite-20b [dense]: GPT-BigCode-style code model, MQA.

52L d_model=6144 48H (MQA kv=1, head_dim 128) d_ff=24576 vocab 49152,
untied head, classic (ungated) GELU MLP: with a gated MLP the parameter
count lands at 28B, not 20B. [arXiv:2405.04324; hf]. A copy of
`repro/configs/granite_20b.py`, field for field, with its deviations from
GPT-BigCode: RMS norm and rotary positions (the default norm_type and
RoPE) where GPT-BigCode has layer norm and learned absolute positions.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    tie_embeddings=False,
    mlp_act="gelu",
    mlp_gated=False,
)
