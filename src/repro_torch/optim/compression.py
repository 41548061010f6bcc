"""int8 gradient compression with error feedback. Mirrors
``repro/optim/compression.py`` (``compress_int8``, ``decompress_int8``,
``error_feedback_compress``, ``zero_error_state``).

    q_t = Q(g_t + e_{t-1});  e_t = (g_t + e_{t-1}) - D(q_t)

``Q`` is block-wise absmax int8 over the flattened tensor, 256 values a
block. ``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q``
matches the reference bit for bit. The error trees ride in the optimizer
state, so a checkpoint captures them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

_BLOCK = 256


def compress_int8(x: torch.Tensor):
    """``(q (nb, 256) int8, scale (nb, 1) float32)`` of ``x`` flattened."""
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale * 127.0), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q, scale, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (q.to(torch.float32) * scale / 127.0).reshape(-1)
    return flat[:n].reshape(shape)


def error_feedback_compress(grads, err=None):
    """One error-feedback round over a gradient tree: ``(dequantized
    grads, new error tree)``, both fp32 and shaped like ``grads``;
    ``err=None`` starts from a zero error."""
    def one(g, e=None):
        c = g.to(torch.float32)
        if e is not None:
            c = c + e.to(torch.float32)
        deq = decompress_int8(*compress_int8(c), tuple(c.shape))
        return deq, c - deq

    pairs = tree_map(one, grads) if err is None else tree_map(one, grads, err)
    return tree_map(lambda pr: pr[0], pairs), tree_map(lambda pr: pr[1], pairs)


def zero_error_state(params):
    """A fresh all-zero fp32 error tree shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
