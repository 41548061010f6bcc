"""dbrx-132b [moe] — 16 experts top-4 fine-grained MoE, every layer.
FSDP required (132B params). [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    vocab_size=100_352,
    d_model=6_144,
    n_layers=40,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,           # per-expert hidden size
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10_752, every=1),
    rope_theta=500_000.0,
    fsdp=True,
    source="hf:databricks/dbrx-base",
)
