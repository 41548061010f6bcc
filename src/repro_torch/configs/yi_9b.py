"""yi-9b [dense] — llama-arch GQA kv=4. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    vocab_size=64_000,
    d_model=4_096,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    rope_theta=10_000.0,
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="arXiv:2403.04652",
)
