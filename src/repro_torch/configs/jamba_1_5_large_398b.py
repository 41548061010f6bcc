"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer. 72 layers, d_model 8192. FSDP required (398B params).
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    vocab_size=65_536,
    d_model=8_192,
    n_layers=72,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24_576, every=2),
    mamba=MambaConfig(d_state=16, expand=2, d_conv=4, chunk=256),
    attn_every=8,          # 1 attention layer per 8 (1:7 with mamba)
    attn_layer_offset=4,
    rope_theta=0.0,        # jamba uses no positional encoding
    fsdp=True,
    source="arXiv:2403.19887",
)
