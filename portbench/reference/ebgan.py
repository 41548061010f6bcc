"""Plain PyTorch reference of EB-GAN as published (Zhao, Mathieu and LeCun,
"Energy-based Generative Adversarial Network", arXiv:1609.03126): the
generator with its RGB head, the auto-encoder discriminator and its energy,
both losses with the margin's hinge and the pulling-away term, the synthetic
images and latents a training step is fed, and the first steps of the
training loop with Adam. It imports nothing of the program: it follows the
published equations and the configuration file, and is given only the
benchmark's weights and inputs. The CPU tests
(``tests/test_torch_ebgan.py``) hold the program to this same file.

Layouts follow the configuration: images and feature maps NHWC, kernels
HWIO. A stride-2 ``n x n`` transpose convolution with padding ``P`` on the
upsampled map (output ``2N - n + 2P``) is ``F.conv_transpose2d`` of the
spatially flipped kernel with padding ``n - 1 - P``.

The equations (section 2 of the paper; the energy in its per-sample mean
squared form):

    D(x)  = mean over pixels and channels of (Dec(Enc(x)) - x)^2
    L_D   = mean D(real) + mean max(0, m - D(G(z)))
    L_G   = mean D(G(z)) + pt_weight * f_PT(S)
    f_PT  = sum_{i != j} (S_i . S_j / (|S_i| |S_j|))^2 / (N (N - 1))

with ``S`` the batch's codes ``Enc(G(z))``, one NHWC-flattened row a
sample. Both nets take Adam; a step updates the discriminator against the
current generator (fakes without gradient), then the generator against the
updated discriminator.

Every matrix product and convolution runs in fp32 with TF32 off
(:func:`train` turns PyTorch's TF32 switches off). ``tf32=True``
computes each of them on operands rounded to TF32 (10 mantissa bits, round
to nearest even), gradients included, with fp32 sums: the precision below
the configuration's fp32, the control the comparison has to fail.
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
    """z ``(B, z_dim)`` -> images ``(B, H, W, 3)`` in [-1, 1]: a linear
    projection to the first map (NHWC order) and relu, the stride-2
    transpose convs each with relu, then the RGB head, ``tanh(x @ W + b)``
    at each pixel."""
    n0, c0, _ = cfg["layers"][0]
    h = torch.relu(_product(torch.matmul, z, gp["proj"]["w"], tf32))
    x = h.reshape(z.shape[0], n0, n0, c0).permute(0, 3, 1, 2)
    for i in range(len(cfg["layers"])):
        p = gp[f"tconv{i}"]
        x = tconv(x, p["w"], p["b"], cfg["padding"], "relu", tf32=tf32)
    x = x.permute(0, 2, 3, 1)
    return torch.tanh(_product(torch.matmul, x, gp["head"]["w"], tf32) + gp["head"]["b"])


# ------------------------------------------------- the auto-encoder's energy

def encode(dp: dict, x: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """NHWC images -> the code, NCHW: stride-2 4x4 convs, padding 1, no
    bias, each followed by a 0.2 leaky relu."""
    h = x.permute(0, 3, 1, 2)
    for i in range(len(widths(dp))):
        w = dp[f"enc{i}"]["w"].permute(3, 2, 0, 1)      # HWIO -> OIHW
        h = F.leaky_relu(_product(lambda a, k: F.conv2d(a, k, stride=2, padding=1),
                                  h, w, tf32), 0.2)
    return h


def widths(dp: dict) -> list:
    """The encoder's widths, read from its weights."""
    out, i = [], 0
    while f"enc{i}" in dp:
        out.append(dp[f"enc{i}"]["w"].shape[3])
        i += 1
    return out


def energy(dp: dict, cfg: dict, x: torch.Tensor, *, tf32: bool = False) -> tuple:
    """``(D(x) (B,), S (B, code size))``: each sample's mean squared
    reconstruction error, and its code flattened in NHWC order. The decoder
    mirrors the encoder with stride-2 transpose convs, relu mid-stack and
    tanh at the output."""
    code = encode(dp, x, tf32=tf32)
    h = code
    n = len(widths(dp))
    for i in range(n):
        p = dp["dec"][f"tconv{i}"]
        h = tconv(h, p["w"], p["b"], cfg["padding"], "tanh" if i == n - 1 else "relu",
                  tf32=tf32)
    recon = h.permute(0, 2, 3, 1)
    e = (recon - x).square().mean((1, 2, 3))
    return e, code.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def pulling_away(s: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """The mean squared cosine over the ordered pairs of distinct rows."""
    n = s.shape[0]
    s = s / s.norm(dim=1, keepdim=True)
    cos = _product(torch.matmul, s, s.t(), tf32)
    off = 1.0 - torch.eye(n, device=s.device, dtype=s.dtype)
    return (cos.square() * off).sum() / (n * (n - 1))


def d_loss(dp: dict, cfg: dict, real, fake, *, tf32: bool = False) -> tuple:
    """``(L_D, D(real), D(fake))``."""
    e_real, _ = energy(dp, cfg, real, tf32=tf32)
    e_fake, _ = energy(dp, cfg, fake, tf32=tf32)
    return e_real.mean() + torch.relu(cfg["margin"] - e_fake).mean(), e_real, e_fake


def g_loss(dp: dict, cfg: dict, fake, *, tf32: bool = False) -> tuple:
    """``(L_G, f_PT)``."""
    e, s = energy(dp, cfg, fake, tf32=tf32)
    pt = pulling_away(s, tf32=tf32)
    return e.mean() + cfg["pt_weight"] * pt, pt


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
    loss, aux = loss_fn(live)
    gs = torch.autograd.grad(loss, [v for _, v in named])
    return loss.detach(), aux, {k: g for (k, _), g in zip(named, gs)}


def train(gp: dict, dp: dict, cfg: dict, feed, steps: int, *, tf32: bool = False,
          half_batch: bool = False) -> dict:
    """``steps`` EB-GAN training steps from ``gp``/``dp``. ``feed(t)``
    gives step ``t``'s ``(images, latents)``; ``half_batch`` leaves out the
    second half of every batch (a fault the comparison has to catch).

    Returns each step's ``(g_loss, d_loss)``, each step's ``(mean D(real),
    mean D(fake), share of fake rows under the margin, f_PT)`` (``stats``),
    the optimizers' first moments after the first step (``m1``, by leaf
    name, prefixed ``g.``/``d.``), and the parameters after the last step
    (``params``, likewise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = cfg["train"]["optimizer"]
    g_adam, d_adam = Adam(gp, opt), Adam(dp, opt)
    losses, stats, m1 = [], [], None
    for t in range(steps):
        real, z = feed(t)
        if half_batch:
            real, z = real[: real.shape[0] // 2], z[: z.shape[0] // 2]
        with torch.no_grad():
            fake = generator(gp, cfg, z, tf32=tf32)

        def d_phase(d):
            loss, e_real, e_fake = d_loss(d, cfg, real, fake, tf32=tf32)
            return loss, (e_real.detach(), e_fake.detach())

        d_l, (e_real, e_fake), d_g = _grads(d_phase, dp)
        dp = d_adam.step(dp, d_g)

        def g_phase(g):
            loss, pt = g_loss(dp, cfg, generator(g, cfg, z, tf32=tf32), tf32=tf32)
            return loss, pt.detach()

        g_l, pt, g_g = _grads(g_phase, gp)
        gp = g_adam.step(gp, g_g)
        losses.append((float(g_l), float(d_l)))
        stats.append((float(e_real.mean()), float(e_fake.mean()),
                      float((e_fake < cfg["margin"]).float().mean()), float(pt)))
        if t == 0:
            m1 = {**{f"g.{k}": v.clone() for k, v in g_adam.m.items()},
                  **{f"d.{k}": v.clone() for k, v in d_adam.m.items()}}
    params = {**{f"g.{k}": v for k, v in _leaves(gp)},
              **{f"d.{k}": v for k, v in _leaves(dp)}}
    return {"losses": losses, "stats": stats, "m1": m1, "params": params}
