"""codeqwen1.5-7b [dense] — qwen1.5 arch, MHA (kv=32), QKV bias.
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    vocab_size=92_416,
    d_model=4_096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13_440,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="hf:Qwen/CodeQwen1.5-7B",
)
