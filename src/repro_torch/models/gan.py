"""GAN generators of the paper's Table 4 on the unified kernel-segregated
transpose convolution, and the small conv discriminator that trains them.
Mirrors ``repro/models/gan.py``.

Each generator projects a latent ``z`` to a ``(h0, h0, c0)`` NHWC map and
runs a stack of stride-2 4x4 transpose-conv layers, each
``act(tconv(x, W) + b)``: relu mid-stack, tanh at the output. Parameters are
a plain dict in the reference's layout: ``{"proj": {"w": (z_dim,
h0*h0*c0)}, "tconv{i}": {"w": (4, 4, cin, cout) HWIO, "b": (cout,)}}``; the
discriminator's are ``{"conv{i}": {"w": (4, 4, cin, cout) HWIO}, "head":
{"w": (hw*hw*c, 1)}}``.

Beyond the reference: a generator may end in an RGB head (``GANConfig.head``
output channels): every transpose conv then takes relu, and a per-pixel
``tanh(x @ W + b)`` (:mod:`repro_torch.kernels.rgb_head`, params ``"head":
{"w": (c_last, head), "b": (head,)}``) makes the image, as the published
EB-GAN's does (:data:`EBGAN_PUBLISHED`, arXiv:1609.03126). EB-GAN trains
against an auto-encoder (:func:`autoencoder_init`): stride-2 4x4 convs down
to a code, stride-2 4x4 transpose convs on the port's kernels back up, and
a sample's energy is its reconstruction's mean squared error
(:func:`energy`); params ``{"enc{i}": {"w": HWIO}, "dec": {"tconv{i}":
{"w", "b"}}}``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from repro_torch.core.segregation import (
    flop_count,
    memory_savings_bytes,
    output_size,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import plan as planlib
from repro_torch.kernels import project as projlib
from repro_torch.kernels import rgb_head as headlib
from repro_torch.kernels.epilogue import Epilogue
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
    # output channels of an RGB head after the last layer (0: none, the
    # last transpose conv makes the image)
    head: int = 0

    def out_hw(self, in_hw: int) -> int:
        return 2 * in_hw - self.kernel + 2 * self.padding

    @property
    def image_hw(self) -> int:
        return self.out_hw(self.layers[-1][0])

    @property
    def image_channels(self) -> int:
        return self.head or self.layers[-1][2]


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
# EB-GAN as published (arXiv:1609.03126, ImageNet 256x256): Table 4's six
# layers, relu on each, then a 64 -> 3 RGB head with tanh
EBGAN_PUBLISHED = GANConfig("ebgan_published", 100, EBGAN.layers, head=3)


def reduced_config(cfg: GANConfig, scale: int = 16) -> GANConfig:
    """Channel-reduced copy of a zoo config (floor of 2 channels a layer):
    the same layer stack and spatial geometry at 1/``scale`` the width."""
    return replace(
        cfg,
        layers=tuple((hw, max(cin // scale, 2), max(cout // scale, 2))
                     for hw, cin, cout in cfg.layers),
    )


def generator_act(cfg: GANConfig, i: int) -> str:
    """Activation of generator layer ``i``: relu mid-stack, tanh output
    (relu there too where an RGB head follows)."""
    return "tanh" if i == len(cfg.layers) - 1 and not cfg.head else "relu"


def generator_epilogues(cfg: GANConfig) -> tuple:
    """Per-layer epilogues: every layer adds its bias, then its activation."""
    return tuple(
        Epilogue(bias=True, act=generator_act(cfg, i))
        for i in range(len(cfg.layers))
    )


def generator_plan(cfg: GANConfig, batch: int, *, train: bool = False,
                   method: str = "auto", epilogues=None, bwd: str = "auto",
                   fuse="auto"):
    """The whole generator's :class:`~repro_torch.kernels.plan.TconvPlan`,
    with each layer's bias + activation baked in (:func:`generator_epilogues`).
    ``train=True`` resolves ``auto`` from the autotuner's training entries.
    ``bwd`` is the backward: ``auto`` (the autotune cache, ``segregated``
    on a miss), ``segregated`` or ``autograd``. ``fuse`` runs the pair pass
    (:func:`~repro_torch.kernels.plan.fuse_pairs`): ``"auto"`` fuses the
    pairs whose race the pair kernel won, ``"force"`` every legal adjacent
    pair, ``"off"`` none; train-mode plans stay unfused."""
    if epilogues is None:
        epilogues = generator_epilogues(cfg)
    return planlib.compile_plan(cfg, batch, train=train, method=method,
                                epilogues=epilogues, bwd=bwd, fuse=fuse)


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
    if cfg.head:
        c_last = cfg.layers[-1][2]
        w = torch.randn((c_last, cfg.head), generator=generator,
                        device=generator.device) * c_last ** -0.5
        params["head"] = {"w": w.to(dev), "b": torch.zeros((cfg.head,), device=dev)}
    return params


def project(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The projection's ``relu(z @ w)``, batch-invariant: a row's bits do not
    depend on the batch it is computed in, so a request's output does not
    depend on the bucket it was packed into. A batched cuBLAS call is not
    such (on an H100 its rows differ from their one-row results by up to
    3.6e-7, ``chip_smoke.py`` phase 5), so the card runs the hand-written
    kernels of :mod:`repro_torch.kernels.project`: one launch for the whole
    batch, each output one fp32 sum in ascending k with relu on the
    accumulator, and the backward with relu's derivative folded in. The CPU
    runs one matmul call a row (:func:`~repro_torch.kernels.project.project_rows`)
    and ``torch.relu``, as it always has."""
    if z.device.type == "cpu":
        return torch.relu(projlib.project_rows(z, w))
    return projlib.ProjectReLU.apply(z, w)


def rgb_head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The RGB head ``tanh(x @ w + b)`` over each pixel of the NHWC map
    ``x``, batch-invariant as :func:`project` is: the card runs the
    hand-written kernels of :mod:`repro_torch.kernels.rgb_head` (one fmaf
    chain an output, tanh's derivative folded into the backward), the CPU
    one matmul a sample (:func:`~repro_torch.kernels.rgb_head.head_rows`)."""
    if x.device.type == "cpu":
        return headlib.head_rows(x, w, b)
    return headlib.RgbHead.apply(x, w, b)


def _tconv_stack(params: dict, cfg: GANConfig, x, plan, method: str,
                 train: bool) -> torch.Tensor:
    """``cfg``'s transpose-conv layers on ``x`` (NHWC), each as ``plan``
    resolved it (a fused pair as one pair-kernel launch) or by ``method``."""
    entries = plan.entries if plan is not None else (None,) * len(cfg.layers)
    i = 0
    for entry in entries:
        if isinstance(entry, planlib.FusedPairPlan):
            p1, p2 = params[f"tconv{i}"], params[f"tconv{i + 1}"]
            x = planlib.execute_pair(entry, x, p1["w"], p2["w"],
                                     bias1=p1["b"], bias2=p2["b"])
            i += 2
        else:
            x = tconv_apply(params[f"tconv{i}"], x, cfg.padding, method=method,
                            train=train, plan=entry, act=generator_act(cfg, i))
            i += 1
    return x


def generator_apply(params: dict, cfg: GANConfig, z, *, method: str = "auto",
                    train: bool = False, plan=None,
                    device=None) -> torch.Tensor:
    """z: (B, z_dim) -> image (B, H, W, C) in [-1, 1], on ``device``
    (the CUDA card unless the caller names another); ``params`` must be
    there already, ``z`` (a tensor or array) is moved there.

    ``plan=`` (a compiled :class:`~repro_torch.kernels.plan.TconvPlan` from
    :func:`generator_plan`) runs every entry as the plan resolved it, a
    fused pair as one pair-kernel launch
    (:func:`~repro_torch.kernels.plan.execute_pair`); without one each layer
    runs ``transpose_conv2d`` with ``method`` (``auto``: a memoized plan
    from the autotune cache, its training entries with ``train=True``, or by
    the cold rule on a miss; or any other name the entry takes).
    Differentiable in ``params``.
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
    x = project(z, w).reshape(z.shape[0], h0, h0, c0)
    x = _tconv_stack(params, cfg, x, plan, method, train)
    if cfg.head:
        x = rgb_head(x, params["head"]["w"], params["head"]["b"])
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
                             include_epilogue: bool = False,
                             plan=None) -> int:
    """Bytes of avoidable traffic the unified method eliminates (Table 4:
    the whole padded upsampled buffer, EB-GAN ~35 MB). ``include_epilogue``
    adds the 2 reads + 2 writes of the fp32 output map that separate bias
    and activation passes would cost. ``plan=`` (a compiled, possibly
    pair-fused plan) adds, for each fused pair, the fp32 interface plane the
    pair kernel keeps on chip: its write and read back, ``2 * M1^2 * C1 * 4``
    bytes a sample."""
    total = sum(
        memory_savings_bytes(hw, cin, 4, cfg.padding, mode="buffer")
        for hw, cin, _ in cfg.layers
    )
    if include_epilogue:
        for hw, _, cout in cfg.layers:
            m = output_size(hw, cfg.kernel, cfg.padding)
            total += 4 * m * m * cout * 4
    if plan is not None:
        for entry in plan.entries:
            if isinstance(entry, planlib.FusedPairPlan):
                lp1 = entry.first
                m1 = output_size(lp1.n_in, lp1.n_k, lp1.padding)
                total += 2 * m1 * m1 * lp1.cout * 4
    return total


# ------------------------------------------------------- small discriminator

def discriminator_init(generator: torch.Generator, in_hw: int, cin: int,
                       width: int = 64, *, device=None) -> dict:
    """Three stride-2 4x4 convs (``cin -> width -> 2 width -> 4 width``, HWIO,
    fan-in scaled) and a linear head, drawn from ``generator`` and placed on
    ``device`` (the CUDA card unless the caller names another)."""
    dev = resolve_device(device)
    chans = [cin, width, width * 2, width * 4]

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=generator.device)
                * scale).to(dev)

    params = {
        f"conv{i}": {"w": normal((4, 4, chans[i], chans[i + 1]),
                                 (16 * chans[i]) ** -0.5)}
        for i in range(3)
    }
    hw = in_hw // 8
    params["head"] = {"w": normal((hw * hw * chans[3], 1), 0.02)}
    return params


def discriminator_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC images -> (B,) logits. Each conv is stride 2 with
    padding 1 and a 0.2 leaky relu (``F.conv2d``, as the reference computes
    them outside any kernel). The head flattens in NHWC order, as the
    reference's ``reshape(B, -1)`` does."""
    h = x.permute(0, 3, 1, 2)
    for i in range(3):
        w = params[f"conv{i}"]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.leaky_relu(F.conv2d(h, w, stride=2, padding=1), 0.2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return (h @ params["head"]["w"])[:, 0]


# ------------------------------------------- EB-GAN's auto-encoder discriminator

# the encoder's stride-2 4x4 convs (256^2 -> 16^2 for EB-GAN's images)
AE_DEPTH = 4


def autoencoder_widths(cfg: GANConfig) -> tuple:
    """The encoder's widths for the generator ``cfg``: the input widths of
    its last :data:`AE_DEPTH` layers, last first (64, 128, 256, 512 for
    :data:`EBGAN_PUBLISHED`), as DCGAN's discriminator mirrors its
    generator; a :func:`reduced_config` gives them reduced alike."""
    return tuple(cin for _, cin, _ in reversed(cfg.layers[-AE_DEPTH:]))


def decoder_config(in_hw: int, cin: int, widths) -> GANConfig:
    """The auto-encoder's decoder as a transpose-conv stack: from the code
    (``in_hw / 2^len(widths)`` square, ``widths[-1]`` channels) back up to
    ``in_hw`` and ``cin``, stride 2, 4x4, relu mid-stack and tanh out, so
    :func:`generator_plan` plans it as it plans a generator's layers."""
    hw = in_hw >> len(widths)
    if hw << len(widths) != in_hw or hw < 1:
        raise ValueError(f"{len(widths)} stride-2 convs do not divide {in_hw}")
    chans = tuple(reversed(widths)) + (cin,)
    layers = tuple((hw << i, chans[i], chans[i + 1]) for i in range(len(widths)))
    return GANConfig("decoder", 0, layers)


def autoencoder_init(generator: torch.Generator, in_hw: int, cin: int,
                     widths, *, device=None) -> dict:
    """The encoder's convs (``cin -> widths``, HWIO, fan-in scaled, no bias)
    and the decoder's transpose convs (:func:`decoder_config`, as
    :func:`tconv_init` draws them), from ``generator``, on ``device``."""
    dev = resolve_device(device)
    chans = (cin,) + tuple(widths)
    params = {}
    for i in range(len(widths)):
        w = torch.randn((4, 4, chans[i], chans[i + 1]), generator=generator,
                        device=generator.device) * (16 * chans[i]) ** -0.5
        params[f"enc{i}"] = {"w": w.to(dev)}
    dcfg = decoder_config(in_hw, cin, widths)
    params["dec"] = {f"tconv{i}": tconv_init(generator, dcfg.kernel, ci, co, device=dev)
                     for i, (_, ci, co) in enumerate(dcfg.layers)}
    return params


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> the NHWC code: stride-2 4x4 convs, padding 1, each
    followed by a 0.2 leaky relu (``F.conv2d``, as the discriminator's)."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    while f"enc{i}" in params:
        w = params[f"enc{i}"]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.leaky_relu(F.conv2d(h, w, stride=2, padding=1), 0.2)
        i += 1
    return h.permute(0, 2, 3, 1).contiguous()


def energy(params: dict, dcfg: GANConfig, x: torch.Tensor, *, plan=None) -> tuple:
    """``(energy (B,), code)``: each sample's energy, the mean squared error
    of its reconstruction ``Dec(Enc(x))``, and the NHWC code. The decoder
    runs ``plan`` (:func:`generator_plan` of ``dcfg``, train mode where it
    is differentiated), or each layer's memoized plan."""
    code = encode(params, x)
    recon = _tconv_stack(params["dec"], dcfg, code, plan, "auto", False)
    return (recon - x).square().mean((1, 2, 3)), code


def pulling_away(code: torch.Tensor) -> torch.Tensor:
    """EB-GAN's pulling-away term of a batch's codes (one flattened row a
    sample): the mean squared cosine over the ordered pairs of distinct
    rows, ``sum_{i != j} cos(S_i, S_j)^2 / (N (N - 1))``."""
    s = code.reshape(code.shape[0], -1)
    n = s.shape[0]
    if n < 2:
        raise ValueError("the pulling-away term needs at least two samples")
    s = s / s.norm(dim=1, keepdim=True)
    cos2 = (s @ s.t()).square()
    off = 1.0 - torch.eye(n, device=s.device, dtype=s.dtype)
    return (cos2 * off).sum() / (n * (n - 1))
