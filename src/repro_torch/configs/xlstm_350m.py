"""xlstm-350m [ssm]: sLSTM + mLSTM blocks, 7:1 ratio.

24L d_model=1024 4H vocab 50304. [arXiv:2405.04517; unverified].
Grouped as 3 x (7 mLSTM + 1 sLSTM); the matrix-memory mLSTM runs the
chunkwise-parallel form for a sequence, the exact recurrence for a decode
step. A copy of `repro/configs/xlstm_350m.py`, field for field.
"""
from repro_torch.models.layers import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
    ssm_conv=4,
    tie_embeddings=True,
)
