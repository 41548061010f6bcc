"""xlstm-125m [ssm] — alternating mLSTM/sLSTM blocks, no FFN (d_ff=0).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    vocab_size=50_304,
    d_model=768,
    n_layers=12,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                # xLSTM blocks carry their own projections
    xlstm=True,
    tie_embeddings=True,
    rope_theta=0.0,
    source="arXiv:2405.04517",
)
