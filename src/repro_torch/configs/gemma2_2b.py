"""gemma2-2b [dense]: local/global alternating attention and logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab 256000.
Sliding window 4096 on the even layer indices (0, 2, ...) and full
attention on the odd ones (`models/transformer.py::layer_windows`); attn
softcap 50, final logit softcap 30; sandwich (post) norms; embeddings
scaled by sqrt(d_model). [arXiv:2408.00118; hf]. A copy of
`repro/configs/gemma2_2b.py`.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    sliding_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    mlp_act="gelu",
)
