"""llava-next-mistral-7b [vlm] — mistral-7B backbone + anyres vision tiling.

The vision tower + anyres tiling is a STUB per the assignment: input_specs
provides precomputed patch embeddings (n_patches = 2880 = 576 base + 4x576
anyres tiles at 672px) that are prepended to the text sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    vocab_size=32_000,
    d_model=4_096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    rope_theta=1_000_000.0,
    n_patches=2_880,
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
