"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    vocab_size=151_936,
    d_model=896,
    n_layers=24,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4_864,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="arXiv:2407.10671",
)
