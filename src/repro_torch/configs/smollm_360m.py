"""smollm-360m [dense]: llama-arch small.

32L d_model=960 15H (GQA kv=5, head_dim 64) d_ff=2560 vocab 49152, tied
embeddings, RMS norm, gated SiLU MLP. [hf:HuggingFaceTB/SmolLM-135M; hf].
A copy of `repro/configs/smollm_360m.py`, field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    tie_embeddings=True,
)
