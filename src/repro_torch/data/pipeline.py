"""Deterministic synthetic tokens and images. Mirrors ``SyntheticTokens``
and ``SyntheticImages`` of ``repro/data/pipeline.py``.

Each batch is a pure function of ``(seed, step)`` (and, for tokens, the
host's index): restarts and elastic re-shards regenerate any step's data
with no loader state to checkpoint. Tokens follow a Zipfian marginal, and
every other one (in expectation) is a fixed function of the rank drawn
before it, so an LM's loss falls as it trains. The images are band-limited noise in [-1, 1]: Gaussian noise at 1/8 the
resolution, bilinearly upsampled, plus a little full-resolution noise,
through tanh. The upsampling is two products with a fixed interpolation
matrix, the function of ``jax.image.resize(..., "bilinear")`` and of
``F.interpolate(..., align_corners=False)``: on CUDA in deterministic mode,
which a bit-exact resume needs, ``F.interpolate`` takes a path that costs
more than the rest of the batch together. The draws come from a ``torch.Generator`` on the batch's
own device, seeded from both numbers, so the work is the device's (the
CPU's and the card's streams differ). They cannot match JAX's threefry
stream, so parity tests feed the reference's arrays to both packages.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import resolve_device


def step_generator(seed: int, step: int, device, host_index: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` that is a pure function of
    ``(seed, step, host_index)``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + step + host_index * 0xBF58476D1CE4E5B9)
        % (1 << 63))


@functools.lru_cache(maxsize=None)
def bilinear_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """``(n_out, n_in)`` weights of 1-D bilinear resampling with half-pixel
    centres, the source index clamped at the edges."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
           - 0.5).clamp(min=0)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = src - lo
    a = torch.zeros((n_out, n_in), dtype=torch.float64)
    rows = torch.arange(n_out)
    a.index_put_((rows, lo), 1 - frac, accumulate=True)
    a.index_put_((rows, hi), frac, accumulate=True)
    return a.to(device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: object = None   # the CUDA card unless the caller names another

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1) -> dict:
        """``{"tokens", "targets"}``, each ``(global_batch // host_count,
        seq_len)`` int64: the host's rows of ``step``'s batch, the targets
        the tokens shifted by one."""
        gen = step_generator(self.seed, step, self.device, host_index)
        b, v = self.global_batch // host_count, self.vocab_size
        shape = (b, self.seq_len + 1)
        u = torch.rand(shape, generator=gen, device=self.device) * (1 - 1e-6) + 1e-6
        # zipf-ish marginal: an exponential transform of the uniforms (the
        # clamp keeps a rank that rounds up to V in range)
        ranks = torch.floor((v ** u - 1.0) / (v - 1) * (v - 1)).long().clamp(max=v - 1)
        # every other token (in expectation) a fixed function of the rank
        # drawn before it
        shifted = torch.roll(ranks, 1, dims=1)
        mix = torch.rand(shape, generator=gen, device=self.device) < 0.5
        toks = torch.where(mix, ranks, (shifted * 31 + 7) % v)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    hw: int
    channels: int
    global_batch: int
    seed: int = 0
    device: object = None   # the CUDA card unless the caller names another

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def batch(self, step: int) -> torch.Tensor:
        """``(global_batch, hw, hw, channels)`` NHWC images of ``step``."""
        gen = step_generator(self.seed, step, self.device)
        b, hw, c = self.global_batch, self.hw, self.channels
        base = torch.randn((b, c, hw // 8, hw // 8), generator=gen,
                           device=self.device)
        up = bilinear_matrix(hw, hw // 8, self.device)
        img = up @ base @ up.T
        img = img + 0.1 * torch.randn(img.shape, generator=gen, device=self.device)
        return torch.tanh(img).permute(0, 2, 3, 1).contiguous()
