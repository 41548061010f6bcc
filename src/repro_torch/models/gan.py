"""GAN generators of the paper's Table 4 on the unified kernel-segregated
transpose convolution. Mirrors the generator half of ``repro/models/gan.py``.

Each generator projects a latent ``z`` to a ``(h0, h0, c0)`` NHWC map and
runs a stack of stride-2 4x4 transpose-conv layers, each
``act(tconv(x, W) + b)``: relu mid-stack, tanh at the output. Parameters are
a plain dict in the reference's layout: ``{"proj": {"w": (z_dim,
h0*h0*c0)}, "tconv{i}": {"w": (4, 4, cin, cout) HWIO, "b": (cout,)}}``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core.segregation import (
    flop_count,
    memory_savings_bytes,
    output_size,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.plan import compile_plan
from repro_torch.models.layers import tconv_apply, tconv_init


@dataclass(frozen=True)
class GANConfig:
    name: str
    z_dim: int
    # (input_hw, cin, cout) per transpose conv layer; kernel 4x4 stride 2
    layers: tuple
    kernel: int = 4
    # paper-convention padding on the upsampled map (Fig. 5: P=2 for 4x4):
    # out = 2N - n + 2P = 2N, i.e. resolution doubles per layer
    padding: int = 2


# Table 4 layer stacks (input size / kernel columns).
DCGAN = GANConfig(
    "dcgan", 100,
    ((4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)),
)
ARTGAN = GANConfig(
    "artgan", 100,
    ((4, 512, 256), (8, 256, 128), (16, 128, 128), (32, 128, 3)),
)
GPGAN = GANConfig(
    "gpgan", 100,
    ((4, 512, 256), (8, 256, 128), (16, 128, 64), (32, 64, 3)),
)
EBGAN = GANConfig(
    "ebgan", 100,
    ((4, 2048, 1024), (8, 1024, 512), (16, 512, 256), (32, 256, 128),
     (64, 128, 64), (128, 64, 64)),
)
GAN_ZOO = {g.name: g for g in (DCGAN, ARTGAN, GPGAN, EBGAN)}


def reduced_config(cfg: GANConfig, scale: int = 16) -> GANConfig:
    """Channel-reduced copy of a zoo config (floor of 2 channels a layer):
    the same layer stack and spatial geometry at 1/``scale`` the width."""
    return replace(
        cfg,
        layers=tuple((hw, max(cin // scale, 2), max(cout // scale, 2))
                     for hw, cin, cout in cfg.layers),
    )


def generator_act(cfg: GANConfig, i: int) -> str:
    """Activation of generator layer ``i``: relu mid-stack, tanh output."""
    return "tanh" if i == len(cfg.layers) - 1 else "relu"


def generator_epilogues(cfg: GANConfig) -> tuple:
    """Per-layer epilogues: every layer adds its bias, then its activation."""
    return tuple(
        Epilogue(bias=True, act=generator_act(cfg, i))
        for i in range(len(cfg.layers))
    )


def generator_plan(cfg: GANConfig, batch: int, *, method: str = "auto",
                   epilogues=None):
    """The whole generator's :class:`~repro_torch.kernels.plan.TconvPlan`,
    with each layer's bias + activation baked in (:func:`generator_epilogues`)."""
    if epilogues is None:
        epilogues = generator_epilogues(cfg)
    return compile_plan(cfg, batch, method=method, epilogues=epilogues)


def generator_init(generator: torch.Generator, cfg: GANConfig, *,
                   device=None) -> dict:
    """Generator parameters drawn from ``generator``, placed on ``device``
    (the CUDA card unless the caller names another)."""
    dev = resolve_device(device)
    h0, c0, _ = cfg.layers[0]
    proj = torch.randn((cfg.z_dim, h0 * h0 * c0), generator=generator,
                       device=generator.device) * 0.02
    params = {"proj": {"w": proj.to(dev)}}
    for i, (_, cin, cout) in enumerate(cfg.layers):
        params[f"tconv{i}"] = tconv_init(generator, cfg.kernel, cin, cout,
                                         device=dev)
    return params


def project(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``z @ w`` one row at a time. Each row then goes through the same
    matmul call whatever the batch, so a request's output does not depend
    on the bucket it was packed into. A batched call is not such: on an
    H100, cuBLAS runs 2-8 rows through another kernel than one row, and
    the rows differ from their one-row results by up to 3.6e-7
    (``chip_smoke.py`` phase 5 prints the comparison)."""
    return torch.cat([z[i : i + 1] @ w for i in range(z.shape[0])])


def generator_apply(params: dict, cfg: GANConfig, z, *, method: str = "auto",
                    plan=None, device=None) -> torch.Tensor:
    """z: (B, z_dim) -> image (B, H, W, C_last) in [-1, 1], on ``device``
    (the CUDA card unless the caller names another); ``params`` must be
    there already, ``z`` (a tensor or array) is moved there.

    ``plan=`` (a compiled :class:`~repro_torch.kernels.plan.TconvPlan` from
    :func:`generator_plan`) runs every layer as the plan resolved it;
    without one each layer resolves a memoized plan for ``method``.
    """
    dev = resolve_device(device)
    if plan is not None and len(plan) != len(cfg.layers):
        raise ValueError(
            f"plan has {len(plan)} layers, generator has {len(cfg.layers)}"
        )
    w = params["proj"]["w"]
    if w.device != dev:
        raise ValueError(f"params live on {w.device}, asked to run on {dev}")
    z = torch.as_tensor(z, dtype=w.dtype).to(dev)
    h0, c0, _ = cfg.layers[0]
    x = torch.relu(project(z, w)).reshape(z.shape[0], h0, h0, c0)
    for i in range(len(cfg.layers)):
        x = tconv_apply(
            params[f"tconv{i}"], x, cfg.padding, method=method,
            plan=None if plan is None else plan[i], act=generator_act(cfg, i),
        )
    return x


def generator_flops(cfg: GANConfig, *, method: str,
                    include_epilogue: bool = True) -> int:
    """Analytic op count across the stack; ``include_epilogue`` adds one
    bias-add and one activation op per output element."""
    total = 0
    for hw, cin, cout in cfg.layers:
        total += flop_count(hw, cfg.kernel, cin, cout, cfg.padding,
                            method=method)
        if include_epilogue:
            m = output_size(hw, cfg.kernel, cfg.padding)
            total += 2 * m * m * cout
    return total


def generator_memory_savings(cfg: GANConfig, *,
                             include_epilogue: bool = False) -> int:
    """Bytes of avoidable traffic the unified method eliminates (Table 4:
    the whole padded upsampled buffer, EB-GAN ~35 MB). ``include_epilogue``
    adds the 2 reads + 2 writes of the fp32 output map that separate bias
    and activation passes would cost."""
    total = sum(
        memory_savings_bytes(hw, cin, 4, cfg.padding, mode="buffer")
        for hw, cin, _ in cfg.layers
    )
    if include_epilogue:
        for hw, _, cout in cfg.layers:
            m = output_size(hw, cfg.kernel, cfg.padding)
            total += 4 * m * m * cout * 4
    return total
