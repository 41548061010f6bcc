"""Plain PyTorch reference of the benchmark's GAN cells: the generator,
the discriminator, the synthetic images and latents a training step is fed,
and the first steps of the GAN training loop with Adam. It imports nothing of
the program: it follows the published equations and the benchmark's
configuration file, and is given only the benchmark's weights and inputs.

Layouts follow the configuration: images and feature maps NHWC, kernels
HWIO. A stride-2 ``n x n`` transpose convolution with padding ``P`` on the
upsampled map (output ``2N - n + 2P``) is ``F.conv_transpose2d`` of the
spatially flipped kernel with padding ``n - 1 - P``.

``tf32=True`` computes every matrix product and convolution on operands
rounded to TF32 (10 mantissa bits, round to nearest even), gradients
included, with fp32 sums: the precision below the configuration's fp32,
which is the control that the comparison has to fail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to the nearest TF32 value, ties to even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32).view(t.shape)


class _RoundIn(torch.autograd.Function):
    """TF32 operand in the forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity in the forward; the incoming gradient, an operand of the
    backward products, rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _product(fn, a, b, tf32: bool):
    if not tf32:
        return fn(a, b)
    return _RoundGrad.apply(fn(_RoundIn.apply(a), _RoundIn.apply(b)))


# ------------------------------------------------------------- generator

def tconv(x, w, b, padding: int, act: str, *, tf32: bool = False):
    """``act(tconv(x, w) + b)``: x NCHW, w HWIO, stride 2."""
    n = w.shape[0]
    if n - 1 - padding < 0:
        raise ValueError("padding above n - 1 is not part of the configurations")
    wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)      # (Cin, Cout, n, n)
    y = _product(lambda a, k: F.conv_transpose2d(a, k, stride=2, padding=n - 1 - padding),
                 x, wt, tf32)
    y = y + b[None, :, None, None]
    return torch.tanh(y) if act == "tanh" else torch.relu(y)


def generator(gp: dict, cfg: dict, z: torch.Tensor, *, tf32: bool = False):
    """z ``(B, z_dim)`` -> images ``(B, H, W, C)``: a linear projection to
    the first map (NHWC order), relu, then the stride-2 layers, relu between
    them and tanh at the output."""
    n0, c0, _ = cfg["layers"][0]
    h = torch.relu(_product(torch.matmul, z, gp["proj"]["w"], tf32))
    x = h.reshape(z.shape[0], n0, n0, c0).permute(0, 3, 1, 2)
    last = len(cfg["layers"]) - 1
    for i in range(len(cfg["layers"])):
        p = gp[f"tconv{i}"]
        x = tconv(x, p["w"], p["b"], cfg["padding"], "tanh" if i == last else "relu",
                  tf32=tf32)
    return x.permute(0, 2, 3, 1)


# --------------------------------------------------------- discriminator

def discriminator(dp: dict, x: torch.Tensor, *, tf32: bool = False):
    """NHWC images -> ``(B,)`` logits: three stride-2 4x4 convs (padding 1,
    leaky relu 0.2) and a linear head over the NHWC-flattened map."""
    h = x.permute(0, 3, 1, 2)
    for i in range(3):
        w = dp[f"conv{i}"]["w"].permute(3, 2, 0, 1)      # HWIO -> OIHW
        h = F.leaky_relu(_product(lambda a, k: F.conv2d(a, k, stride=2, padding=1),
                                  h, w, tf32), 0.2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return _product(torch.matmul, h, dp["head"]["w"], tf32)[:, 0]


# ------------------------------------------------------- training inputs

def _generator_for(seed: int, step: int, device) -> torch.Generator:
    """The seeded stream of one step's draws, as the configuration's
    synthetic data defines it."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63))


def _bilinear(n_out: int, n_in: int, device) -> torch.Tensor:
    """1-D bilinear resampling weights, half-pixel centres, source index
    clamped to the edges."""
    a = torch.zeros((n_out, n_in), dtype=torch.float64)
    for i in range(n_out):
        src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
        lo = int(src)
        hi = min(lo + 1, n_in - 1)
        a[i, lo] += 1 - (src - lo)
        a[i, hi] += src - lo
    return a.to(device=device, dtype=torch.float32)


def images(seed: int, step: int, batch: int, hw: int, channels: int, device, *,
           tf32: bool = False) -> torch.Tensor:
    """One step's NHWC images in [-1, 1]: noise at 1/8 the resolution,
    bilinearly upsampled, plus 0.1 of full-resolution noise, through tanh."""
    gen = _generator_for(seed, step, device)
    base = torch.randn((batch, channels, hw // 8, hw // 8), generator=gen, device=device)
    up = _bilinear(hw, hw // 8, device)
    img = _product(torch.matmul, _product(torch.matmul, up, base, tf32), up.T, tf32)
    img = img + 0.1 * torch.randn(img.shape, generator=gen, device=device)
    return torch.tanh(img).permute(0, 2, 3, 1).contiguous()


def latents(seed: int, step: int, batch: int, z_dim: int, device) -> torch.Tensor:
    return torch.randn((batch, z_dim), generator=_generator_for(seed, step, device),
                       device=device)


# --------------------------------------------------------------- training

def _leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def _rebuild(tree: dict, values: dict, prefix: str = "") -> dict:
    return {k: (_rebuild(v, values, f"{prefix}{k}.") if isinstance(v, dict)
                else values[prefix + k]) for k, v in tree.items()}


class Adam:
    """Adam with decoupled weight decay on matrices and optional clipping
    by the global gradient norm, one state per named leaf."""

    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.count = 0
        self.m = {k: torch.zeros_like(v) for k, v in _leaves(params)}
        self.v = {k: torch.zeros_like(v) for k, v in _leaves(params)}

    def step(self, params: dict, grads: dict) -> dict:
        o = self.opt
        self.count += 1
        scale = 1.0
        if o["clip_norm"] is not None:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        bc1 = 1 - o["b1"] ** self.count
        bc2 = 1 - o["b2"] ** self.count
        new = {}
        for k, p in _leaves(params):
            g = grads[k] * scale
            self.m[k] = o["b1"] * self.m[k] + (1 - o["b1"]) * g
            self.v[k] = o["b2"] * self.v[k] + (1 - o["b2"]) * g * g
            step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o["eps"])
            if p.ndim >= 2:
                step = step + o["weight_decay"] * p
            new[k] = p - o["lr"] * step
        return _rebuild(params, new)


def _grads(loss_fn, params: dict) -> tuple:
    named = [(k, v.detach().requires_grad_(True)) for k, v in _leaves(params)]
    live = _rebuild(params, dict(named))
    loss = loss_fn(live)
    gs = torch.autograd.grad(loss, [v for _, v in named])
    return loss.detach(), {k: g for (k, _), g in zip(named, gs)}


def train(gp: dict, dp: dict, cfg: dict, feed, steps: int, *, tf32: bool = False,
          half_batch: bool = False) -> dict:
    """``steps`` GAN training steps from ``gp``/``dp``: each the
    discriminator's update against the current generator (fakes without
    gradient), then the generator's against the updated discriminator,
    non-saturating softplus losses, the mean over the batch. ``feed(t)``
    gives step ``t``'s ``(images, latents)``. ``half_batch`` leaves out the
    second half of every batch (a fault the comparison has to catch).

    Returns each step's ``(g_loss, d_loss)``, the optimizers' first moments
    after the first step (``m1``, by leaf name, prefixed ``g.``/``d.``),
    and the parameters after the last step (``params``, likewise)."""
    opt = cfg["train"]["optimizer"]
    g_adam, d_adam = Adam(gp, opt), Adam(dp, opt)
    losses, m1 = [], None
    for t in range(steps):
        real, z = feed(t)
        if half_batch:
            real, z = real[: real.shape[0] // 2], z[: z.shape[0] // 2]
        with torch.no_grad():
            fake = generator(gp, cfg, z, tf32=tf32)
        d_loss, d_g = _grads(
            lambda d: (F.softplus(-discriminator(d, real, tf32=tf32)).mean()
                       + F.softplus(discriminator(d, fake, tf32=tf32)).mean()), dp)
        dp = d_adam.step(dp, d_g)
        g_loss, g_g = _grads(
            lambda g: F.softplus(-discriminator(dp, generator(g, cfg, z, tf32=tf32),
                                                tf32=tf32)).mean(), gp)
        gp = g_adam.step(gp, g_g)
        losses.append((float(g_loss), float(d_loss)))
        if t == 0:
            m1 = {**{f"g.{k}": v.clone() for k, v in g_adam.m.items()},
                  **{f"d.{k}": v.clone() for k, v in d_adam.m.items()}}
    params = {**{f"g.{k}": v for k, v in _leaves(gp)},
              **{f"d.{k}": v for k, v in _leaves(dp)}}
    return {"losses": losses, "m1": m1, "params": params}
