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

Over placed parameters (``DTensor``s,
:func:`repro_torch.distributed.sharding.distribute_params`) the moments are
placed like their parameters, and an int8 ``{q, scale}`` moment as the
reference's ``opt_specs_from`` places it (its parameter's leading axes, the
two block axes whole). The update runs elementwise on each rank's local
shards; the global norm sums each rank's local squares, each weighted by
one over the ranks that hold the same shard, with one all-reduce over the
mesh. An int8 moment's parameter, gradient and first moment are laid out
as the moment (their last axis whole) for the update, and the new
parameter cut back to its own placement.
"""
from __future__ import annotations

from dataclasses import dataclass

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

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
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=_M_DTYPES[cfg.moment_dtype])
        return torch.zeros(p.shape, dtype=_M_DTYPES[cfg.moment_dtype],
                           device=p.device)

    def v_init(p):
        if cfg.moment_dtype == "int8":
            if isinstance(p, DTensor):   # blocked over the whole last axis
                pl = _v_placements(p)
                local = _blocked_shape(tuple(
                    n // math.prod(p.device_mesh.size(i) for i, x in enumerate(pl)
                                   if isinstance(x, Shard) and x.dim == d)
                    for d, n in enumerate(p.shape)))
                mk = lambda shape, dt: DTensor.from_local(  # noqa: E731
                    torch.zeros(shape, dtype=dt, device=p.device), p.device_mesh, pl,
                    run_check=False)
                return {"q": mk(local, torch.int8), "scale": mk(local[:-1] + (1,), torch.float32)}
            bs = _blocked_shape(tuple(p.shape))
            return {"q": torch.zeros(bs, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(bs[:-1] + (1,), device=p.device)}
        return m_init(p)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(m_init, params), "v": tree_map(v_init, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _v_placements(p: DTensor) -> tuple:
    """The placements of an int8 moment's blocks beside its placed
    parameter ``p``: ``p``'s, with a split of its last axis made whole."""
    last = p.ndim - 1
    return tuple(Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
                 for pl in p.placements)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in fp32. Placed leaves
    sum their local squares, each over the number of ranks that hold the
    same shard, and the ranks' sums are all-reduced once."""
    leaves = tree_leaves(tree)
    if not any(isinstance(x, DTensor) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves))
    mesh = next(x for x in leaves if isinstance(x, DTensor)).device_mesh
    total = None
    for x in leaves:
        local = x.to_local() if isinstance(x, DTensor) else x
        sq = torch.sum(torch.square(local.to(torch.float32)))
        copies = math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                           if not isinstance(pl, Shard)) if isinstance(x, DTensor) else mesh.size()
        sq = sq / copies
        total = sq if total is None else total + sq
    return torch.sqrt(funcol.all_reduce(total, "sum", _world_group(mesh)))


def _world_group(mesh):
    """The process group over every rank of ``mesh``."""
    return mesh.get_group() if mesh.ndim == 1 else mesh._flatten().get_group()


def adamw_update(grads, state, params, cfg: AdamWConfig, lr_t):
    """One AdamW step: ``(new params, new state, grad norm)``. Gradients
    are clipped to ``cfg.clip_norm`` by their global norm; weight decay is
    decoupled and applies to tensors of two or more dims only."""
    placed = any(isinstance(x, DTensor) for x in tree_leaves(params))
    if placed:   # each gradient as its parameter is placed (no partial sums)
        grads = tree_map(lambda g, p: g if tuple(g.placements) == tuple(p.placements)
                         else g.redistribute(p.device_mesh, p.placements), grads, params)
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

    if placed:
        upd = _on_local_shards(upd)
    new_p, new_m, new_v = _update_tree(params, grads, state["m"], state["v"], upd)
    return new_p, {"m": new_m, "v": new_v, "count": count}, gnorm


def _on_local_shards(upd):
    """``upd`` over placed leaves, on each rank's local shards (the
    gradient already laid out as its parameter); for an int8 moment, the
    parameter, gradient and first moment laid out as the moment's blocks
    and the new parameter and first moment cut back to the parameter's
    placement. The new leaves come back placed as the old ones."""
    def placed(p, g, m, v):
        mesh, pl = p.device_mesh, tuple(p.placements)
        lay = _v_placements(p) if isinstance(v, dict) else pl
        if lay != pl:   # an int8 moment over a parameter split on its last axis
            p, g, m = (t.redistribute(mesh, lay) for t in (p, g, m))
        local_v = ({k: t.to_local() for k, t in v.items()} if isinstance(v, dict)
                   else v.to_local())
        p_new, m_new, v_new = upd(p.to_local(), g.to_local(), m.to_local(), local_v)
        wrap = lambda t: DTensor.from_local(t, mesh, lay, run_check=False)  # noqa: E731
        p_new, m_new = wrap(p_new), wrap(m_new)
        if lay != pl:
            p_new, m_new = p_new.redistribute(mesh, pl), m_new.redistribute(mesh, pl)
        v_new = ({k: DTensor.from_local(t, mesh, lay, run_check=False)
                  for k, t in v_new.items()} if isinstance(v_new, dict) else wrap(v_new))
        return p_new, m_new, v_new

    return placed



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
