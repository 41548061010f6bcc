"""Mamba (S6) mixer: chunked selective scan for training and prefill, an
O(1)-state recurrent step for decode. Mirrors ``repro/models/ssm.py``.

The ``(B, L, d_inner, d_state)`` discretised transition is only ever built
one chunk at a time (``cfg.mamba.chunk``); across chunks the ``(B,
d_inner, d_state)`` state is carried in a Python loop, where the reference
runs ``lax.scan``. Within a chunk the first-order recurrence ``h_t = a_t *
h_{t-1} + b_t`` is solved by a doubling (Hillis-Steele) scan of
``log2(L)`` steps, where the reference calls ``lax.associative_scan``:
the same function, its products taken in another order.

A decode step writes the cache in place (the reference returns a new one):
the conv buffer rolls by one row and the new ``ssm`` state replaces the
old, so a CUDA graph captured over the cache stays valid.

A prefill shorter than ``d_conv - 1`` tokens keeps its conv state
left-padded with zeros, the inputs the causal conv saw before the prompt;
the reference keeps fewer rows there, and its next decode step raises.

Placed (a ``DTensor`` input), the mixer runs on each rank's shards with the
inner dimension ``di`` over ``model``
(:func:`repro_torch.models.mixer_split.run_placed`): ``w_in``'s product
regrouped into this rank's ``x`` and ``z`` channels, the depthwise conv and
the scan local per channel, ``w_bcdt``'s partial sums all-reduced before
the softplus and the ``B``/``C`` split, and ``w_out`` row-parallel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor

from repro_torch.models.layers import _dtype, _normal
from repro_torch.models.mixer_split import WHOLE, run_placed


def _uniform(generator, shape, lo: float, hi: float, device):
    """A uniform fp32 draw in ``[lo, hi)`` from ``generator``, moved to
    ``device``; nothing is drawn on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).to(device)


def mamba_init(generator, cfg, *, device) -> dict:
    d = cfg.d_model
    di = cfg.mamba.expand * d
    ds = cfg.mamba.d_state
    dtr = cfg.mamba.dt_rank or -(-d // 16)
    k = cfg.mamba.d_conv
    dt, std = _dtype(cfg), d ** -0.5
    log_dt = _uniform(generator, (di,), math.log(1e-3), math.log(1e-1), device)
    return {
        "mamba": {
            "w_in": _normal(generator, (d, 2 * di), std, dt, device),
            "conv_w": _normal(generator, (k, di), k ** -0.5, dt, device),
            "conv_b": torch.zeros((di,), dtype=dt, device=device),
            "w_bcdt": _normal(generator, (di, 2 * ds + dtr), di ** -0.5, dt, device),
            "dt_w": _normal(generator, (dtr, di), dtr ** -0.5, dt, device),
            # the inverse softplus of a dt drawn log-uniform in [1e-3, 1e-1)
            "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
            "a_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                            device=device).expand(di, ds).contiguous()),
            "d": torch.ones((di,), dtype=torch.float32, device=device),
            "w_out": _normal(generator, (di, d), di ** -0.5, dt, device),
        }
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,di); w: (k,di)."""
    k, S = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(k):
        shift = k - 1 - t
        xs = F.pad(x, (0, 0, shift, 0))[:, :S, :]
        out = out + xs.float() * w[t].float()
    return (out + b.float()).to(x.dtype)


def _ssm_proj(p, xc, tp):
    """Shared projections: xc (B,L,di) -> (dt, Bc, Cc), fp32."""
    m = p["mamba"]
    ds = m["a_log"].shape[1]
    bcdt = tp.rows(xc @ m["w_bcdt"])
    Bc = bcdt[..., :ds].float()
    Cc = bcdt[..., ds : 2 * ds].float()
    dt = F.softplus((bcdt[..., 2 * ds :] @ m["dt_w"]).float() + m["dt_bias"])
    return dt, Bc, Cc


def mamba(p, cfg, x, *, cache=None, want_cache=False):
    """x: (B,S,d). Returns (out, new_cache). cache != None -> decode (S ==
    1; ``cache`` written in place and returned); want_cache -> prefill
    (returns the final conv/ssm states). A placed ``x`` runs placed (see
    the module docstring)."""
    if isinstance(x, DTensor):
        return run_placed(_mamba, "mamba", p, cfg, x, cache=cache, want_cache=want_cache,
                          out="w_out", state_dims={"conv": 2, "ssm": 1})
    return _mamba(p, cfg, x, cache, want_cache, WHOLE)


def _mamba(p, cfg, x, cache, want_cache, tp):
    """The mixer on plain tensors, split as ``tp`` says
    (:class:`~repro_torch.models.mixer_split.Split`)."""
    m = p["mamba"]
    di = m["conv_w"].shape[1]
    k_conv = m["conv_w"].shape[0]
    xz = tp.columns(x @ m["w_in"], "w_in", 2)
    xin, z = xz[..., :di], xz[..., di:]

    if cache is None:
        xc = F.silu(_causal_conv(xin, m["conv_w"], m["conv_b"]))
        y, h_last = _chunked_scan(p, cfg, xc, tp)
        # the conv state is the last k_conv - 1 inputs, left-padded with the
        # zeros the causal conv saw before a prompt shorter than that
        # (the reference keeps S rows and its next decode step raises)
        conv = F.pad(xin, (0, 0, max(k_conv - 1 - xin.shape[1], 0), 0))
        new_cache = ({"conv": conv[:, -(k_conv - 1):, :], "ssm": h_last}
                     if want_cache else None)
    else:
        # decode: roll the conv buffer, one step of the SSM recurrence
        conv_buf = torch.cat([cache["conv"], xin], dim=1)        # (B,k,di)
        xc = F.silu(torch.einsum("bkd,kd->bd", conv_buf.float(), m["conv_w"].float())
                    + m["conv_b"])[:, None, :].to(x.dtype)
        dt, Bc, Cc = _ssm_proj(p, xc, tp)
        A = -torch.exp(m["a_log"])
        dA = torch.exp(dt[:, 0, :, None] * A)                    # (B,di,ds)
        dBx = dt[:, 0, :, None] * xc[:, 0, :, None].float() * Bc[:, 0, None, :]
        h = dA * cache["ssm"] + dBx
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None, :]
        y = y + m["d"] * xc.float()
        cache["conv"].copy_(conv_buf[:, 1:, :])
        cache["ssm"].copy_(h)
        new_cache = cache

    y = (y * F.silu(z.float())).to(x.dtype)
    return tp.out(y, m["w_out"]), new_cache


def _doubling_scan(a, b):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along dim 1 from
    ``h = 0``: ``(prod a_1..t, h_t)``, in ``ceil(log2(L))`` doubling steps."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return a, b


def _chunk_step(p, A, h0, xk, tp):
    """One chunk of the selective scan from state ``h0``: ``(h_last, y)``."""
    m = p["mamba"]
    dt, Bc, Cc = _ssm_proj(p, xk, tp)                                # (B,L,*)
    dA = torch.exp(dt[..., None] * A)                            # (B,L,di,ds)
    dBx = dt[..., None] * xk[..., None].float() * Bc[:, :, None, :]
    a_cum, b_cum = _doubling_scan(dA, dBx)
    h = b_cum + a_cum * h0[:, None]                              # (B,L,di,ds)
    y = torch.einsum("blds,bls->bld", h, Cc)
    return h[:, -1], y + m["d"] * xk.float()


def _chunked_scan(p, cfg, xc, tp=WHOLE):
    """Chunked selective scan. xc: (B,S,di) post-conv. Returns ``((B,S,di)
    fp32, final state)``. Under autograd each chunk runs under a
    checkpoint, as the reference's ``jax.checkpoint`` body: only the
    ``(B, di, ds)`` carries persist. Raises ``ValueError`` when the chunk
    ``min(cfg.mamba.chunk, S)`` does not divide ``S`` (the reference
    asserts it)."""
    m = p["mamba"]
    B, S, di = xc.shape
    L = min(cfg.mamba.chunk, S)
    if S % L:
        raise ValueError(f"the Mamba chunk {L} does not divide the sequence length {S}")
    A = -torch.exp(m["a_log"])                                   # (di,ds)
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=xc.device)
    ys = []
    for c0 in range(0, S, L):
        xk = xc[:, c0 : c0 + L]
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk_step, p, A, h, xk, tp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _chunk_step(p, A, h, xk, tp)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def init_mamba_cache(cfg, batch: int, *, device) -> dict:
    di = cfg.mamba.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di), dtype=_dtype(cfg),
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba.d_state), dtype=torch.float32,
                           device=device),
    }
