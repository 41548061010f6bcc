"""Model/architecture config system and the assigned input-shape suite.
Mirrors ``repro/configs/base.py``.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.registry`` maps ``--arch``
ids to them. The dataclasses are data only and copied field for field.
``param_count`` counts the shapes of the port's own parameter layout
(``abstract_params`` of the model :func:`build_model` gives), which is the
reference's. ``input_specs`` gives meta tensors where the reference gives
``jax.ShapeDtypeStruct``: the same keys, shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                # per-expert hidden size
    every: int = 1               # MoE FFN every `every`-th layer (others dense)
    capacity_factor: float = 1.25
    n_shared_experts: int = 0    # dense experts always applied (kimi-style)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    chunk: int = 256             # chunked selective-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    # hybrid (jamba): one attention layer per `attn_every` layers (rest mamba);
    # 0 -> all layers are attention.
    attn_every: int = 0
    attn_layer_offset: int = 4
    # xlstm: alternate mLSTM / sLSTM blocks (family == "ssm")
    xlstm: bool = False
    # encoder-decoder (whisper): encoder layer count; frontend is a stub that
    # feeds precomputed frame embeddings of length `n_frames`.
    encoder_layers: int = 0
    n_frames: int = 0
    # vlm (llava-next): `n_patches` precomputed anyres patch embeddings are
    # prepended to the text sequence by the (stub) vision frontend.
    n_patches: int = 0
    # numerics / distribution
    dtype: str = "bfloat16"
    fsdp: bool = False           # shard params over `data` too (big archs)
    # "tp" (Megatron TP over model) | "fsdp" (ZeRO-3 over data x model; for
    # <=13B dense models where TP activation ARs dominate — see §Perf).
    # Serving (prefill/decode) always uses `parallelism`; training uses
    # `train_parallelism` — dense <=9B archs train FSDP-only (4.6x fewer
    # collective bytes than TP-16) but must serve with TP (FSDP would
    # re-gather all params every decoded token).
    parallelism: str = "tp"
    train_parallelism: str = "tp"
    remat: bool = True
    attn_chunk: int = 1024       # kv-chunked (flash-style) attention block
    window: int = 0              # 0 -> full attention; >0 -> local window
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is runnable (SSM/hybrid/linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def layer_kinds(self) -> list[str]:
        """Per-layer mixer kind within one period ('attn' | 'mamba' |
        'mlstm' | 'slstm'), plus the FFN kind ('dense' | 'moe' | 'none')."""
        if self.xlstm:
            return ["mlstm", "slstm"]
        if self.attn_every:
            return [
                "attn" if i == self.attn_layer_offset % self.attn_every else "mamba"
                for i in range(self.attn_every)
            ]
        return ["attn"]

    def ffn_kinds(self) -> list[str]:
        period = self.period
        kinds = []
        for i in range(period):
            if self.d_ff == 0 and not self.moe.n_experts:
                kinds.append("none")
            elif self.moe.n_experts and (i % self.moe.every == self.moe.every - 1):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds

    @property
    def period(self) -> int:
        if self.xlstm:
            return 2
        if self.attn_every:
            # period must also be a multiple of moe.every so the FFN pattern
            # is stationary across periods
            import math

            return (
                self.attn_every * self.moe.every
                // math.gcd(self.attn_every, self.moe.every)
                if self.moe.n_experts
                else self.attn_every
            )
        if self.moe.n_experts:
            return self.moe.every
        return 1

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    def param_count(self) -> int:
        """Total parameter count (exact for our parameterization)."""
        from repro_torch.models.lm import build_model
        from repro_torch.tree import tree_leaves

        return sum(t.numel() for t in tree_leaves(build_model(self).abstract_params()))

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE archs; == param_count otherwise."""
        if not self.moe.n_experts:
            return self.param_count()
        total = self.param_count()
        per_expert = 3 * self.d_model * self.moe.d_ff
        n_moe_layers = self.n_layers // self.moe.every
        inactive = n_moe_layers * per_expert * (
            self.moe.n_experts - self.moe.top_k
        )
        return total - inactive


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell, and the skip reason if not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic mixer"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input of this cell.

    Modality frontends are stubs, as in the reference: the VLM takes
    precomputed anyres patch embeddings, the audio arch precomputed
    conv-frontend frame embeddings.
    """
    import torch

    B, S = shape.global_batch, shape.seq_len
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    def tok(b, s):
        return spec((b, s), torch.int32)

    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.n_patches if cfg.n_patches else S
        batch["tokens"] = tok(B, s_text)
        if shape.kind == "train":
            batch["targets"] = tok(B, s_text if cfg.encoder_layers else S)
        if cfg.n_patches:
            batch["patch_embeds"] = spec((B, cfg.n_patches, cfg.d_model), act)
        if cfg.encoder_layers:
            batch["frames"] = spec((B, cfg.n_frames, cfg.d_model), act)
    else:  # decode: one new token against a cache of length S
        batch["tokens"] = tok(B, 1)
        batch["pos"] = spec((B,), torch.int32)
    return batch


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    small = dict(
        vocab_size=min(cfg.vocab_size, 512),
        d_model=64,
        n_layers=cfg.period * 2,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        fsdp=False,
        remat=False,
        attn_chunk=64,
    )
    if cfg.moe.n_experts:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64
        )
    if cfg.attn_every:
        small["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=32)
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
        small["n_frames"] = 16
    if cfg.n_patches:
        small["n_patches"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
