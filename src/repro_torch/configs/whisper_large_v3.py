"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB (input_specs
feeds precomputed frame embeddings, 1500 frames = 30s at 50Hz).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    vocab_size=51_866,
    d_model=1_280,
    n_layers=32,           # decoder layers
    encoder_layers=32,
    n_frames=1_500,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5_120,
    rope_theta=0.0,        # learned/sinusoidal absolute positions
    train_parallelism="fsdp",  # dense <=9B: ZeRO-3 beats TP-16 (EXPERIMENTS §Perf)
    source="arXiv:2212.04356",
)
