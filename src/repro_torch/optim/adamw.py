"""AdamW with global-norm clipping and quantized moments. Mirrors
``repro/optim/adamw.py``.

``moment_dtype`` sets the memory of the first and second moments:
  "float32"  standard
  "bfloat16" half-size moments (the update math stays fp32)
  "int8"     block-wise 8-bit absmax second moment, blocked along the last
             axis (256 a block); first moment bf16

Functions over nested dicts and lists of tensors (:mod:`repro_torch.tree`); they
allocate new tensors and never update their inputs in place, so a caller
can keep the old state (the trainer's NaN guard does).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8


_Q_BLOCK = 256
_M_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.bfloat16}


def _blocked_shape(shape) -> tuple:
    """int8 moments are blocked along the last axis only: (..., nb, 256)."""
    if not shape:
        return (1, _Q_BLOCK)
    nb = -(-shape[-1] // _Q_BLOCK)
    return tuple(shape[:-1]) + (nb, _Q_BLOCK)


def _quantize_blockwise(x: torch.Tensor):
    """int8 absmax quantization, blocked along the last axis."""
    if x.ndim == 0:
        x = x.reshape(1)
    pad = (-x.shape[-1]) % _Q_BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, _Q_BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_blockwise(q, scale, shape) -> torch.Tensor:
    x = q.to(torch.float32) * scale
    if not shape:
        return x.reshape(-1)[0]
    x = x.reshape(*x.shape[:-2], x.shape[-2] * _Q_BLOCK)
    return x[..., : shape[-1]].reshape(shape)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"m", "v", "count"}``: zero moments shaped like ``params`` (on
    their devices) and an int32 step count."""
    if cfg.moment_dtype not in _M_DTYPES:
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")

    def m_init(p):
        return torch.zeros(p.shape, dtype=_M_DTYPES[cfg.moment_dtype],
                           device=p.device)

    def v_init(p):
        if cfg.moment_dtype == "int8":
            bs = _blocked_shape(tuple(p.shape))
            return {"q": torch.zeros(bs, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(bs[:-1] + (1,), device=p.device)}
        return m_init(p)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(m_init, params), "v": tree_map(v_init, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def adamw_update(grads, state, params, cfg: AdamWConfig, lr_t):
    """One AdamW step: ``(new params, new state, grad norm)``. Gradients
    are clipped to ``cfg.clip_norm`` by their global norm; weight decay is
    decoupled and applies to tensors of two or more dims only."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** count.to(torch.float32)
    bc2 = 1 - cfg.b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        if cfg.moment_dtype == "int8":
            v_f = _dequantize_blockwise(v["q"], v["scale"], tuple(p.shape))
        else:
            v_f = v.to(torch.float32)
        v_new = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr_t * step).to(p.dtype)
        if cfg.moment_dtype == "int8":
            q, s = _quantize_blockwise(v_new)
            v_out = {"q": q, "scale": s}
        else:
            v_out = v_new.to(_M_DTYPES[cfg.moment_dtype])
        return p_new, m_new.to(m.dtype), v_out

    new_p, new_m, new_v = _update_tree(params, grads, state["m"], state["v"], upd)
    return new_p, {"m": new_m, "v": new_v, "count": count}, gnorm


def _update_tree(p, g, m, v, upd):
    """``upd`` over matching leaves, split into three trees. ``v`` is walked
    beside ``p``: its int8 leaves are ``{"q", "scale"}`` dicts."""
    if isinstance(p, dict):
        outs = {k: _update_tree(p[k], g[k], m[k], v[k], upd) for k in sorted(p)}
        return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
    if isinstance(p, list):
        outs = [_update_tree(*args, upd) for args in zip(p, g, m, v)]
        return tuple([o[i] for o in outs] for i in range(3))
    return upd(p, g, m, v)
