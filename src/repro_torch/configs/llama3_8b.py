"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    vocab_size=128_256,
    d_model=4_096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    rope_theta=500_000.0,
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="arXiv:2407.21783",
)
