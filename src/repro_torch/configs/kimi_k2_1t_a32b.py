"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts top-8 + 1 shared,
per-expert d_ff 2048, 61 layers, d_model 7168. FSDP + 8-bit optimizer moments
required to fit 512 chips (see repro.optim). [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    vocab_size=163_840,
    d_model=7_168,
    n_layers=61,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2_048,            # per-expert hidden size (fine-grained experts)
    moe=MoEConfig(
        n_experts=384, top_k=8, d_ff=2_048, every=1, n_shared_experts=1,
        capacity_factor=1.0,
    ),
    rope_theta=50_000.0,
    fsdp=True,
    source="arXiv:2501.kimi2",
)
