"""Shared layers. Mirrors ``repro/models/layers.py``: the transpose-conv
layers of the GAN generators (``tconv_init``, ``tconv_apply``) and the LM
layers (RMSNorm, RoPE, GQA attention with a KV cache and cross-attention,
SwiGLU MLP, capacity-based mixture-of-experts).

Parameters are plain dicts of tensors with the reference's names and
layouts (a dense weight is ``(d_in, d_out)``, applied as ``x @ w``), or the
same trees placed over a mesh as ``DTensor``s
(:func:`repro_torch.distributed.sharding.distribute_params`). The
reference's sharding hints (``constrain``) stand where it has them; they
change nothing unplaced, and placed they keep Megatron's layout: heads and
the MLP's hidden units over ``model``, each block's output replicated over
``model`` again by one all-reduce after its row-parallel projection. A
placed weight is used through :func:`~repro_torch.distributed.sharding.
gather_param` (the explicit FSDP gather). The attention core and the
decode branch run on each rank's local shards (``to_local``); the decode
branch runs the kernel on this rank's slice of a sequence-sharded cache
and combines the ranks' partial outputs over ``model`` by their
log-sum-exp (:func:`_decode_placed`). The decode branch of :func:`attention` runs the hand-written
flash-decode kernel (:mod:`repro_torch.kernels.decode_attention`) where
the reference calls its jnp oracle ``_grouped_decode_attention``; the two
compute the same function (the reference's tests hold its Pallas kernel,
which the CUDA kernel replaces, to the oracle at 2e-4/2e-5), except that
the kernel keeps scores and probabilities in fp32 where the oracle rounds
them to a bf16 model's dtype.

:func:`moe` has the reference's two paths: the grouped one (one group of
tokens with no mesh, a group a data-parallel rank under a mesh) and the
expert-parallel one under a ``DeviceMesh`` with a ``model`` dimension
(:func:`_moe_shard_map`, bracketed by the collectives of
:mod:`repro_torch.distributed.collectives`). Their dispatch and combine are
gathers: nothing is scattered, so no sum depends on the order of atomic
adds. Each token's ``k`` expert outputs are added in ascending expert order
starting from zero, where the reference scatter-adds them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.transpose_conv import transpose_conv2d
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import enter, gather, gather_shards, reduce
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.tree import tree_map

NEG_INF = -1e30


def tconv_init(generator: torch.Generator, n: int, cin: int, cout: int, *,
               device) -> dict:
    """``n x n`` HWIO transpose-conv kernel (fan-in scaled normal, drawn
    from ``generator``) and a zero bias, on ``device``."""
    w = torch.randn((n, n, cin, cout), generator=generator,
                    device=generator.device) * (n * n * cin) ** -0.5
    return {
        "w": w.to(device),
        "b": torch.zeros((cout,), device=device),
    }


def tconv_apply(p: dict, x: torch.Tensor, padding: int, *,
                method: str = "auto", train: bool = False, plan=None,
                act: str = "none"):
    """Stride-2 transpose convolution + bias + activation as one unit,
    differentiable in ``x``, ``p["w"]`` and ``p["b"]``: the entry
    :func:`~repro_torch.core.transpose_conv.transpose_conv2d` with the
    layer's bias and activation.

    ``plan=`` (a :class:`~repro_torch.kernels.plan.LayerPlan` compiled
    with this layer's epilogue) runs exactly what the plan resolved;
    without one, ``method`` is any name the entry takes (``train`` as the
    entry reads it).
    """
    return transpose_conv2d(x, p["w"], padding, method=method, train=train,
                            plan=plan, bias=p["b"], act=act)


# ------------------------------------------------------------ dense layers

def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _normal(generator: torch.Generator, shape, std: float, dtype, device):
    """A normal draw from ``generator`` in fp32, scaled, then cast: one
    tensor at a time, on the generator's device, then moved to ``device``.
    On the meta device nothing is drawn (shapes only; ``generator`` may be
    None)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device) * std
    return w.to(device=device, dtype=dtype)


def stack_layers(make, n: int):
    """``n`` layers drawn by ``make()`` in turn, their leaves stacked over a
    new leading axis (filled one layer at a time, so at most one unstacked
    layer exists at once; with ``n == 1`` the layer itself, as a view)."""
    out = None
    for i in range(n):
        one = make()
        if n == 1:
            return tree_map(lambda t: t.unsqueeze(0), one)
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
        del one   # before the next layer's draw
    return out


def dense_init(generator, d_in, d_out, dtype, *, bias=False, std=None,
               device) -> dict:
    std = std if std is not None else d_in ** -0.5
    p = {"w": _normal(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ sharding.gather_param(p["w"])
    if "b" in p:
        y = y + sharding.gather_param(p["b"])
    return y


def rmsnorm_init(d: int, *, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-5):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * sharding.gather_param(p["scale"])).to(x.dtype)


def rope(x, positions, theta):
    """x: (..., S, n, hd); positions: (S,) or broadcastable to x[..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].to(device=x.device, dtype=torch.float32) * freq
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    if isinstance(x, DTensor):   # the tables, replicated, meet a placed x
        cos, sin = (sharding.replicate(t, x.device_mesh) for t in (cos, sin))
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < hd:  # odd head_dim tail passes through
        rot = torch.cat([rot, x[..., 2 * half :].to(rot.dtype)], dim=-1)
    return rot.to(x.dtype)


# --------------------------------------------------------------- attention

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd); stacked over periods in an LM cache
    v: torch.Tensor


def attn_init(generator, cfg, *, cross=False, device) -> dict:
    """Query, key, value and output projections. ``cross`` (a
    cross-attention layer) changes nothing, as in the reference."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    return {
        "wq": dense_init(generator, d, H * hd, dt, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(generator, d, KV * hd, dt, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(generator, d, KV * hd, dt, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(generator, H * hd, d, dt, std=(H * hd) ** -0.5,
                         device=device),
    }


def _direct_attention(q, k, v, *, causal, q_positions):
    """q: (B,Sq,H,hd); k,v: (B,Skv,H,hd) (KV heads pre-expanded). fp32 softmax.

    q_positions: (Sq,) or (B,Sq) absolute positions.
    """
    B, Sq = q.shape[:2]
    hd = q.shape[-1]
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bthd->bhqt", q, k).float() * hd ** -0.5
    kv_pos = torch.arange(Skv, device=q.device)
    qp = (q_positions.expand(B, Sq) if q_positions.ndim == 1 else q_positions)
    mask = torch.ones((B, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp[:, None, :, None] >= kv_pos)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype), v)


def _chunked_attention(q, k, v, *, causal, q_positions, chunk):
    """Flash-style online-softmax attention, blocked over q and kv chunks.

    q: (B,Sq,H,hd); k,v: (B,Skv,H,hd). The reference's two ``lax.scan``
    loops become Python loops over the chunks, in the same order.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    cq = min(chunk, Sq)
    ck = min(chunk, Skv)
    if Sq % cq or Skv % ck:
        raise ValueError(f"chunk {chunk} does not divide Sq={Sq} and Skv={Skv}")
    scale = hd ** -0.5
    outs = []
    for qi in range(Sq // cq):
        qc = q[:, qi * cq : (qi + 1) * cq]
        qp = q_positions[qi * cq : (qi + 1) * cq]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=q.device)
        lsum = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=q.device)
        for kj in range(Skv // ck):
            kc = k[:, kj * ck : (kj + 1) * ck]
            vc = v[:, kj * ck : (kj + 1) * ck]
            s = torch.einsum("bqhd,bthd->bhqt", qc, kc).float() * scale
            if causal:
                kp = kj * ck + torch.arange(ck, device=q.device)
                s = torch.where(qp[None, None, :, None] >= kp, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqt,bthd->bhqd", p, vc.float())
            m = m_new
        o = acc / torch.clamp(lsum, min=1e-30)[..., None]
        outs.append(o.transpose(1, 2))  # (B,cq,H,hd)
    return torch.cat(outs, dim=1)


def _scatter_kv(cache, kv, pos):
    """Write this step's row in place: ``cache[b, pos[b]] = kv[b, 0]``.

    cache: (B,Smax,KV,hd); kv: (B,1,KV,hd); pos: (B,) int. The reference
    rewrites the whole cache with a one-hot ``where`` (JAX arrays are
    immutable); the values are the same.
    """
    b = torch.arange(cache.shape[0], device=cache.device)
    cache[b, pos] = kv[:, 0].to(cache.dtype)


def attention(p, cfg, x, *, positions, causal=True, cache: KVCache | None = None,
              cache_pos=None, kv_override=None, prefill=False):
    """GQA attention. Returns (out, new_cache).

    cache + cache_pos: decode mode -- writes this step's K/V into the cache
    at cache_pos, in place, and attends over the cache through the decode
    kernel. kv_override: cross-attention over the given ``(k, v)`` (B, Skv,
    KV, hd), with no RoPE and no cache write; ``cache`` comes back as given.
    prefill: also return this call's full K/V as a KVCache.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    q = _heads(dense(p["wq"], x), H, hd)
    if kv_override is not None:
        k, v = kv_override
        return _prefill_attention(p, cfg, x, q, k, v, causal=causal,
                                  positions=positions), cache
    k = _heads(dense(p["wk"], x), KV, hd)
    v = _heads(dense(p["wv"], x), KV, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None and isinstance(q, DTensor):
        # decode, placed: keep GQA grouped, the heads whole on every model
        # rank and the batch as it is (reference line 241)
        q = sharding.constrain(q, sharding.BATCH, None, None, None)
        o = _decode_placed(q, k, v, cache, cache_pos, cfg)
        return dense(p["wo"], o.reshape(B, S, H * hd)), cache
    if cache is not None:
        _scatter_kv(cache.k, k, cache_pos)
        _scatter_kv(cache.v, v, cache_pos)
        kv_len = (cache_pos + 1).to(torch.int32)
        o = decode_attention(q.reshape(B, KV, G, hd).contiguous(), cache.k,
                             cache.v, kv_len)
        o = o.to(x.dtype).reshape(B, S, H * hd)
        return dense(p["wo"], o), cache
    new_cache = KVCache(k, v) if prefill else None
    return _prefill_attention(p, cfg, x, q, k, v, causal=causal,
                              positions=positions), new_cache


def _heads(y, n: int, hd: int):
    """``y`` (B, S, n * hd) as (B, S, n, hd). A placed ``y`` whose last
    dimension is split over more ranks than there are heads (8 KV heads
    over a 16-way ``model``: half a head a rank) is gathered over those
    ranks first, as the reference's partitioner must."""
    B, S = y.shape[:2]
    if isinstance(y, DTensor):
        mesh = y.device_mesh
        ways = [i for i, pl in enumerate(y.placements) if isinstance(pl, Shard) and pl.dim == 2]
        if n % math.prod(mesh.size(i) for i in ways):
            y = y.redistribute(mesh, tuple(Replicate() if i in ways else pl
                                           for i, pl in enumerate(y.placements)))
    return y.reshape(B, S, n, hd)


def _prefill_attention(p, cfg, x, q, k, v, *, causal, positions):
    """Attention of every query over ``k``/``v`` (KV heads expanded to
    H): chunked where the reference chunks, direct otherwise; the output
    projection applied. Placed, the heads are constrained over ``model``
    (reference lines 252-254 and 264) and the core runs on each rank's
    local heads and batch rows (:func:`_local_core`)."""
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    chunked = (S * Skv > cfg.attn_chunk ** 2 and S > 1
               and S % min(cfg.attn_chunk, S) == 0
               and Skv % min(cfg.attn_chunk, Skv) == 0)

    def core(q, k, v):
        if k.shape[2] != q.shape[2]:  # expand KV -> H heads (no-op for MHA)
            k = torch.repeat_interleave(k, q.shape[2] // k.shape[2], dim=2)
            v = torch.repeat_interleave(v, q.shape[2] // v.shape[2], dim=2)
        if chunked:
            return _chunked_attention(q, k, v, causal=causal, q_positions=positions,
                                      chunk=cfg.attn_chunk)
        return _direct_attention(q, k, v, causal=causal, q_positions=positions)

    if isinstance(q, DTensor):
        q = sharding.constrain(q, sharding.BATCH, None, sharding.MODEL, None)
        o = _local_core(core, q, k, v)
        o = sharding.constrain(o.to(x.dtype), sharding.BATCH, None, sharding.MODEL, None)
    else:
        o = core(q, k, v).to(x.dtype)
    o = o.reshape(B, S, H * hd)
    return dense(p["wo"], o)


def _kv_placements(q, kv_heads: int) -> tuple:
    """Placements for K or V beside a placed ``q`` (B, S, H, hd): the batch
    as ``q``'s, and the heads split as ``q``'s where the KV heads divide the
    mesh dimension, else whole."""
    mesh = q.device_mesh
    out = []
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 2 and kv_heads % mesh.size(i):
            out.append(Replicate())
        else:
            out.append(pl)
    return tuple(out)


def _head_range(q) -> tuple:
    """``(first, count)`` of this rank's query heads of a placed ``q``."""
    H = q.shape[2]
    n, first = H, 0
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            n //= q.device_mesh.size(i)
            first = first + q.device_mesh.get_local_rank(i) * n
    return first, n


def _local_core(core, q, k, v):
    """``core(q, k, v)`` on this rank's local shards of a placed ``q``
    (B, S, H, hd) and ``k``, ``v`` (B, Skv, KV, hd): K and V are laid out
    beside ``q`` (:func:`_kv_placements`), and where they stay whole over a
    dimension that splits ``q``'s heads, expanded to H heads and cut to
    this rank's. The output comes back placed as ``q``."""
    KV = k.shape[2]
    want = _kv_placements(q, KV)
    k = k.redistribute(k.device_mesh, want) if tuple(k.placements) != want else k
    v = v.redistribute(v.device_mesh, want) if tuple(v.placements) != want else v
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if kl.shape[2] == KV and ql.shape[2] != q.shape[2]:   # whole KV, split heads
        first, n = _head_range(q)
        G = q.shape[2] // KV
        kl = torch.repeat_interleave(kl, G, dim=2)[:, :, first:first + n]
        vl = torch.repeat_interleave(vl, G, dim=2)[:, :, first:first + n]
    o = core(ql, kl, vl)
    return DTensor.from_local(o, q.device_mesh, q.placements, run_check=False)


def _decode_placed(q, k, v, cache: KVCache, cache_pos, cfg):
    """The decode branch over a placed cache (B, S, KV, hd) whose sequence
    may be split over ``model`` (:func:`~repro_torch.distributed.sharding.
    cache_specs`), as the reference's partitioner splits it.

    Each rank holds ``q``, ``k`` and ``v`` with every head, for its batch
    rows, and the cache slice ``[s0, s0 + S_l)``. It writes this step's K/V
    only where ``cache_pos`` falls in its slice (a ``where`` on the row the
    position maps to, clamped into the slice, so no rank reads back or
    syncs), runs the decode kernel on its slice with ``kv_len`` clipped to
    it and the log-sum-exp asked for, and the ranks' partial outputs are
    combined over ``model``: ``m = max_r lse_r``, ``o = sum_r e^(lse_r - m)
    o_r / sum_r e^(lse_r - m)``. A rank whose slice holds no valid key has
    ``lse = -inf`` and weight 0, and calls every collective all the same.
    Returns ``(B, 1, H, hd)`` in ``q``'s dtype, placed as ``q``."""
    mesh = q.device_mesh
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    k = k.redistribute(mesh, q.placements) if tuple(k.placements) != tuple(q.placements) else k
    v = v.redistribute(mesh, q.placements) if tuple(v.placements) != tuple(q.placements) else v
    ck, cv = cache.k.to_local(), cache.v.to_local()
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    Bl, S_l = ck.shape[0], ck.shape[1]
    if ql.shape[0] != Bl:
        raise ValueError(f"the cache holds {Bl} batch rows a rank, the step {ql.shape[0]}")
    # this rank's batch rows of cache_pos, and its sequence slice's start
    _, row0 = sharding.split_group(cache.k, 0)
    seq_group, s0 = sharding.split_group(cache.k, 1)
    pos = torch.as_tensor(cache_pos, device=ck.device).long()[row0 * Bl:(row0 + 1) * Bl]
    s0 *= S_l
    rel = pos - s0
    inside = ((rel >= 0) & (rel < S_l))[:, None, None]
    idx = rel.clamp(0, S_l - 1)
    b = torch.arange(Bl, device=ck.device)
    ck[b, idx] = torch.where(inside, kl[:, 0].to(ck.dtype), ck[b, idx])
    cv[b, idx] = torch.where(inside, vl[:, 0].to(cv.dtype), cv[b, idx])
    kv_len = (pos + 1 - s0).clamp(0, S_l).to(torch.int32)
    o, lse = decode_attention(ql.reshape(Bl, KV, G, hd).contiguous(), ck, cv, kv_len,
                              return_lse=True)
    if seq_group is not None:
        m = funcol.all_reduce(lse, "max", seq_group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = torch.exp(lse - m)
        both = funcol.all_reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1),
                                 "sum", seq_group)
        o = both[..., :hd] / both[..., hd:].clamp(min=1e-30)
    o = o.to(q.dtype).reshape(Bl, 1, H, hd)
    return DTensor.from_local(o, mesh, q.placements, run_check=False)


def init_kv_cache(cfg, batch: int, seq_len: int, *, device) -> KVCache:
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    dt = _dtype(cfg)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


# ------------------------------------------------------------- dense SwiGLU

def mlp_init(generator, cfg, d_ff=None, *, device) -> dict:
    d, ff, dt = cfg.d_model, d_ff or cfg.d_ff, _dtype(cfg)
    return {
        "w_gate": dense_init(generator, d, ff, dt, device=device),
        "w_up": dense_init(generator, d, ff, dt, device=device),
        "w_down": dense_init(generator, ff, d, dt, std=ff ** -0.5, device=device),
    }


def mlp(p, x):
    h = torch.nn.functional.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    h = sharding.constrain(h, sharding.BATCH, None, sharding.MODEL)
    return dense(p["w_down"], h)


# ------------------------------------------------------------------- MoE

def moe_init(generator, cfg, *, device) -> dict:
    """Router (fp32 ``w``, used in the model dtype), the experts' stacked
    SwiGLU weights and, for a config with shared experts, one dense MLP
    of their summed width."""
    d, E, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
    dt, std = _dtype(cfg), d ** -0.5
    p = {
        "router": {"w": _normal(generator, (d, E), std, torch.float32, device)},
        "experts": {
            "w_gate": _normal(generator, (E, d, ff), std, dt, device),
            "w_up": _normal(generator, (E, d, ff), std, dt, device),
            "w_down": _normal(generator, (E, ff, d), ff ** -0.5, dt, device),
        },
    }
    if cfg.moe.n_shared_experts:
        p["shared"] = mlp_init(generator, cfg, d_ff=ff * cfg.moe.n_shared_experts,
                               device=device)
    return p


def _router(p, cfg, x2d):
    """Router logits in the model dtype, softmax and top-k in fp32; returns
    ``(top_p, top_e, probs)`` with ``top_p`` renormalised. Among equal
    probabilities the lower expert comes first, as ``lax.top_k`` takes it
    (a stable descending sort; ``torch.topk`` promises no order)."""
    logits = (x2d @ p["router"]["w"].to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e, probs


def _dp_groups(batch: int) -> int:
    """Number of data-parallel groups the batch dim is split into: the
    ambient mesh's ``pod x data`` when it divides ``batch``, else 1."""
    sizes = sharding.mesh_axis_sizes(sharding.get_abstract_mesh())
    g = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    return g if (g > 1 and batch % g == 0) else 1


def _dispatch_compute_combine(xt, top_p, top_e, experts, E, k, C, e0=0):
    """Dispatch ``Tl`` tokens' ``(token, slot)`` pairs into ``(E, C, d)``
    slabs, run the experts and combine: pure local computation (no
    collectives). The expert-parallel path calls it a model rank with its
    expert slice and ``e0`` offset.

    Pairs are sorted stably by expert; each expert takes at most ``C`` of
    them in that order. Its slab is gathered from the sorted pairs (rows
    past its count are zero), the experts run as batched matmuls, and each
    token gathers its ``k`` weighted outputs back and adds them in fp32 in
    ascending expert order from zero. A pair routed outside ``[e0, e0+E)``
    or beyond capacity reads the zero sentinel row. Every shape follows
    from ``Tl``, so a decode step captures as a graph."""
    Tl, d = xt.shape
    flat_e = top_e.reshape(Tl * k) - e0
    in_range = (flat_e >= 0) & (flat_e < E)
    sort_key = torch.where(in_range, flat_e, E)
    order = torch.argsort(sort_key, stable=True)        # group pairs by expert
    sorted_e = sort_key[order]
    experts_ids = torch.arange(E, device=xt.device)
    start = torch.searchsorted(sorted_e, experts_ids, side="left")     # (E,)
    count = torch.searchsorted(sorted_e, experts_ids, side="right") - start
    token_of = order // k                                # (Tl*k,)

    # dispatch: row c of expert e is sorted pair start[e] + c, if c < count[e]
    c = torch.arange(C, device=xt.device)
    src = torch.clamp(start[:, None] + c, max=Tl * k - 1)           # (E, C)
    buf = torch.where((c < count[:, None])[..., None], xt[token_of[src]],
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    h = torch.nn.functional.silu(torch.bmm(buf, experts["w_gate"]))
    h = h * torch.bmm(buf, experts["w_up"])
    y = torch.bmm(h, experts["w_down"]).reshape(E * C, d)
    y = torch.cat([y, y.new_zeros((1, d))])              # the sentinel row

    # combine: pair i of the sorted order reads its slot (or the sentinel)
    in_e = sorted_e < E
    pos_in_e = (torch.arange(Tl * k, device=xt.device)
                - start[torch.clamp(sorted_e, max=E - 1)])
    slot = torch.where((pos_in_e < C) & in_e, sorted_e * C + pos_in_e, E * C)
    wts = top_p.reshape(Tl * k)[order][:, None]
    contrib = y[slot].float() * wts                      # (Tl*k, d), sorted order
    # each token's k positions in the sorted order, ascending: ascending expert
    rows = torch.sort(torch.argsort(order).reshape(Tl, k), dim=-1).values
    out = torch.zeros((Tl, d), dtype=torch.float32, device=xt.device)
    for j in range(k):
        out = out + contrib[rows[:, j]]
    return out.to(xt.dtype)


def _expert_counts(top_e, E: int):
    """Routed pairs an expert over every token (integers, as sorted
    counts, so no sum depends on an atomic order)."""
    flat = torch.sort(top_e.reshape(-1)).values
    experts = torch.arange(E, device=top_e.device)
    return (torch.searchsorted(flat, experts, side="right")
            - torch.searchsorted(flat, experts, side="left"))


def _aux_loss(top_e, probs, E: int):
    """The Switch balance loss ``E * sum(frac_tokens * frac_probs)``."""
    frac_tokens = _expert_counts(top_e, E).float() / top_e.numel()
    return E * torch.sum(frac_tokens * probs.mean(0))


def _moe_shard_map(p, cfg, x):
    """Expert-parallel MoE over the ambient ``DeviceMesh``: rank ``(d, m)``
    takes its data-parallel slice of the tokens and the expert weights
    ``[e0, e0 + E // model)``, dispatches its tokens to its experts with
    the capacity of its local token count (as the reference's
    ``shard_map`` body does), then ``reduce`` sums the partial outputs over
    ``model`` in the model dtype and ``gather`` joins the data-parallel
    slices. The tokens, router weights and expert weights enter through
    ``enter`` over every rank of the region. Under ``fsdp`` each expert
    slice is first taken as its ``data`` shard and gathered over ``data``
    (``gather_shards``), as the reference's FSDP gather is."""
    mesh = sharding.get_concrete_mesh()
    sizes = sharding.mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    B, S, d = x.shape
    E, k, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    E_local = E // sizes["model"]
    fsdp = cfg.fsdp and "data" in sizes

    x2d = x.reshape(B * S, d)
    top_p, top_e, probs = _router(p, cfg, x2d)

    everyone, _ = sharding.mesh_group(mesh, dp + ("model",))
    model_group, m = sharding.mesh_group(mesh, ("model",))
    e0 = m * E_local
    Tl, r = B * S, 0
    if dp:
        dp_group, r = sharding.mesh_group(mesh, dp)
        Tl = (B // math.prod(sizes[a] for a in dp)) * S
    rows = slice(r * Tl, (r + 1) * Tl)
    xl = enter(x2d, everyone)[rows]
    tpl = enter(top_p, everyone)[rows]
    tel = top_e[rows]
    wl = {name: enter(w, everyone)[e0:e0 + E_local]
          for name, w in p["experts"].items()}
    if fsdp:   # the FSDP gather of this rank's expert slice over data
        data_group, dr = sharding.mesh_group(mesh, ("data",))
        for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            n = wl[name].shape[dim] // sizes["data"]
            wl[name] = gather_shards(wl[name].narrow(dim, dr * n, n), data_group, dim)
    C = max(int(cf * k * Tl / E), 1)    # capacity per (global) expert
    out = _dispatch_compute_combine(xl, tpl, tel, wl, E_local, k, C, e0=e0)
    out = reduce(out, model_group)
    if dp:
        out = gather(out, dp_group)
    if "shared" in p:
        out = out + mlp(p["shared"], x2d)
    return out.reshape(B, S, d), _aux_loss(top_e, probs, E)


def _moe_placed(p, cfg, x):
    """The MoE over placed parameters and a placed ``x`` (B, S, d), on the
    local shards: DTensor has no sharding strategy for ``searchsorted``, so
    the layer takes ``to_local`` at its boundary and keeps the
    expert-parallel path's collectives (:mod:`repro_torch.distributed.
    collectives`).

    This rank's tokens are ``x``'s local rows; the router runs on them
    (its weight gathered whole) as on every rank of ``model``; the experts
    this rank holds (its ``model`` slice, gathered over ``data`` under
    ``fsdp`` by ``gather_shards``) run the dispatch of
    :func:`_dispatch_compute_combine` with the capacity of the local token
    count, and ``reduce`` sums the partial outputs over ``model``. The
    region's inputs enter over ``model`` (the experts' partial gradients)
    and the router and expert weights over the batch's ranks (each rank's
    tokens' partial gradients). The balance loss is the reference's over
    every token: the expert counts and summed probabilities reduced over
    the batch's ranks. Returns ``(out placed as x, aux)``, ``aux`` a plain
    scalar, the same on every rank."""
    B, S, d = x.shape
    E, k, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    x2d = x.reshape(B * S, d)
    xl = x2d.to_local()
    Tl = xl.shape[0]
    tok_group, _ = sharding.split_group(x2d, 0)
    model_group, m = sharding.split_group(p["experts"]["w_gate"], 0)
    rw = sharding.gather_param(p["router"]["w"]).to_local()
    if tok_group is not None:
        rw = enter(rw, tok_group)
    top_p, top_e, probs = _router({"router": {"w": rw}}, cfg, xl)
    if model_group is not None:
        xe, tpe = enter(xl, model_group), enter(top_p, model_group)
    else:
        xe, tpe = xl, top_p
    wl = {}
    for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        data_group, _ = sharding.split_group(p["experts"][name], dim)   # fsdp
        w = p["experts"][name].to_local()
        if data_group is not None:   # the FSDP gather of this rank's expert slice
            w = gather_shards(w, data_group, dim)
        elif tok_group is not None:
            w = enter(w, tok_group)
        wl[name] = w
    E_local = wl["w_gate"].shape[0]
    C = max(int(cf * k * Tl / E), 1)    # capacity per (global) expert
    out = _dispatch_compute_combine(xe, tpe, top_e, wl, E_local, k, C, e0=m * E_local)
    if model_group is not None:
        out = reduce(out, model_group)
    out = DTensor.from_local(out, x2d.device_mesh, x2d.placements, run_check=False)
    if "shared" in p:
        shared = sharding.constrain(mlp(p["shared"], x), sharding.BATCH, None, None)
        out = out + shared.reshape(B * S, d)
    # the balance loss over every token
    counts, psum = _expert_counts(top_e, E), probs.sum(0)
    if tok_group is not None:
        counts = funcol.all_reduce(counts, "sum", tok_group)
        psum = reduce(psum, tok_group)
    n_tok = B * S
    aux = E * torch.sum(counts.float() / (n_tok * k) * (psum / n_tok))
    return out.reshape(B, S, d), aux


def _moe_supported_by_shard_map(cfg, batch) -> bool:
    """Whether the expert-parallel path runs: an ambient ``DeviceMesh``
    with a ``model`` dimension that divides the experts, and data-parallel
    ranks that divide the batch. (An abstract mesh has no ranks: there the
    grouped path runs, whose values the expert-parallel path equals.)"""
    sizes = sharding.mesh_axis_sizes(sharding.get_concrete_mesh())
    if "model" not in sizes:
        return False
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    return cfg.moe.n_experts % sizes["model"] == 0 and batch % dp == 0


def moe(p, cfg, x):
    """Top-k capacity-based MoE over ``x`` (B, S, d); returns ``(out,
    aux)``.

    Under a ``DeviceMesh`` with a ``model`` dimension this is the
    expert-parallel path (:func:`_moe_shard_map`); otherwise the grouped
    path below, the same math. The tokens are grouped by the data-parallel
    shard they live on (``G = _dp_groups(B)`` groups of ``Tl = B*S / G``;
    one group with no mesh), and each group dispatches its own tokens
    (:func:`_dispatch_compute_combine`) with the capacity ``C = max(int(cf
    * k * Tl / E), 1)``: tokens beyond an expert's capacity in their group
    are dropped (Switch semantics). ``aux`` is the Switch balance loss
    ``E * sum(frac_tokens * frac_probs)``."""
    if isinstance(x, DTensor):
        return _moe_placed(p, cfg, x)
    if _moe_supported_by_shard_map(cfg, x.shape[0]):
        return _moe_shard_map(p, cfg, x)
    B, S, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    G = _dp_groups(B)
    T = B * S
    Tl = T // G                                          # tokens per DP group
    xt = x.reshape(T, d)
    top_p, top_e, probs = _router(p, cfg, xt)
    C = max(int(cfg.moe.capacity_factor * k * Tl / E), 1)
    out = torch.cat([
        _dispatch_compute_combine(xt[g * Tl:(g + 1) * Tl], top_p[g * Tl:(g + 1) * Tl],
                                  top_e[g * Tl:(g + 1) * Tl], p["experts"], E, k, C)
        for g in range(G)])
    if "shared" in p:
        out = out + mlp(p["shared"], xt)
    return out.reshape(B, S, d), _aux_loss(top_e, probs, E)
