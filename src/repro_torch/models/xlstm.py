"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, a sequential scan with block-diagonal recurrence). Mirrors
``repro/models/xlstm.py``.

mLSTM training and prefill use the reference's chunked linear-attention
form (a ``(B, nh, hd, hd)`` state carried across chunks in a Python loop,
where the reference runs ``lax.scan``; the intra-chunk term is ``(B, L, L,
nh)``). Decode is one O(1) state update. sLSTM is a Python loop over time
at prefill, as the reference's ``lax.scan`` is sequential. Gates are
stabilised by the paper's running log-space maximum ``m``.

A decode step writes its state in place (the reference returns a new one),
so a CUDA graph captured over the cache stays valid.

Placed (a ``DTensor`` input), both blocks run on each rank's shards
(:func:`repro_torch.models.mixer_split.run_placed`) with their heads over
``model`` where ``n_heads`` divides it, whole on every rank otherwise:
mLSTM's ``w_qkv`` and ``w_if`` products regrouped into this rank's heads
(gathered whole where the heads stay whole), sLSTM's ``w_in`` read
head-major, so its contiguous split is whole heads, and ``w_rec`` this
rank's heads; ``w_out`` and ``w_down`` row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor

from repro_torch.models.layers import _dtype, _normal
from repro_torch.models.mixer_split import WHOLE, run_placed

NEG = -1e30


# --------------------------------------------------------------------- mLSTM

def mlstm_init(generator, cfg, *, device) -> dict:
    d, nh = cfg.d_model, cfg.n_heads
    dt, std = _dtype(cfg), d ** -0.5
    return {
        "mlstm": {
            "w_qkv": _normal(generator, (d, 3 * d), std, dt, device),
            "w_if": _normal(generator, (d, 2 * nh), std, torch.float32, device),
            "w_out": _normal(generator, (d, d), std, dt, device),
        }
    }


def mlstm(p, cfg, x, *, cache=None, want_cache=False):
    """x: (B,S,d) -> (out, new_cache). cache != None -> decode (S == 1;
    the state written in place and returned); want_cache -> prefill
    (returns the final (C, n, m) state). A placed ``x`` runs placed (see
    the module docstring)."""
    if isinstance(x, DTensor):
        return run_placed(_mlstm, "mlstm", p, cfg, x, cache=cache, want_cache=want_cache,
                          out="w_out", state_dims={"C": 1, "n": 1, "m": 1},
                          n_heads=cfg.n_heads)
    return _mlstm(p, cfg, x, cache, want_cache, WHOLE)


def _mlstm(p, cfg, x, cache, want_cache, tp):
    """The block on plain tensors, its heads split as ``tp`` says
    (:class:`~repro_torch.models.mixer_split.Split`)."""
    m = p["mlstm"]
    B, S, _ = x.shape
    hd = cfg.d_model // cfg.n_heads
    qkv = tp.columns(x @ m["w_qkv"], "w_qkv", 3)
    nh = qkv.shape[-1] // (3 * hd)            # this rank's heads
    q, k, v = (a.reshape(B, S, nh, hd).float() for a in torch.chunk(qkv, 3, dim=-1))
    k = k * hd ** -0.5
    gates = tp.columns(x.float() @ m["w_if"], "w_if", 2)
    ig = gates[..., :nh]                       # (B,S,nh) log input gate
    fg = F.logsigmoid(gates[..., nh:])         # (B,S,nh) log forget gate

    if cache is None:
        y, state = _mlstm_chunked(cfg, q, k, v, ig, fg)
        new_cache = state if want_cache else None
    else:
        C, n, mstate = cache["C"], cache["n"], cache["m"]
        i0, f0 = ig[:, 0], fg[:, 0]                       # (B,nh)
        m_new = torch.maximum(f0 + mstate, i0)
        i_ = torch.exp(i0 - m_new)[..., None]
        f_ = torch.exp(f0 + mstate - m_new)[..., None]
        k0, v0, q0 = k[:, 0], v[:, 0], q[:, 0]            # (B,nh,hd)
        C_new = f_[..., None] * C + i_[..., None] * k0[..., :, None] * v0[..., None, :]
        n_new = f_ * n + i_ * k0
        num = torch.einsum("bhd,bhde->bhe", q0, C_new)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q0, n_new)),
                            torch.exp(-m_new))[..., None]
        y = (num / den)[:, None].reshape(B, 1, nh * hd)
        C.copy_(C_new)
        n.copy_(n_new)
        mstate.copy_(m_new)
        new_cache = cache

    return tp.out(y.to(x.dtype), m["w_out"]), new_cache


def _mlstm_chunk(C, n, m0, qc, kc, vc, ic, fc):
    """One chunk from state ``(C, n, m0)``: ``(C_new, n_new, m_new, y)``."""
    L = qc.shape[1]
    cum_f = torch.cumsum(fc, dim=1)                              # (B,L,nh)
    # log weight of source s as seen at the chunk's end / at step t:
    #   b_s = i_s + (cum_f_L - cum_f_s);  a_ts = i_s + cum_f_t - cum_f_s, s <= t
    total = cum_f[:, -1]                                         # (B,nh)
    m_intra = (ic + cum_f[:, -1:] - cum_f).amax(dim=1)           # (B,nh)
    m_new = torch.maximum(m0 + total, m_intra)

    # inter-chunk: y_t += (q_t * exp(cum_f_t + m0 - m_new)) @ C
    decay_q = torch.exp(cum_f + m0[:, None] - m_new[:, None])    # (B,L,nh)
    y_inter = torch.einsum("blhd,bhde,blh->blhe", qc, C, decay_q)
    n_inter = torch.einsum("bhd,blh->blhd", n, decay_q)

    # intra-chunk quadratic term
    diff = cum_f[:, :, None, :] - cum_f[:, None, :, :]           # (B,L,L,nh) t,s
    a = ic[:, None, :, :] + diff - m_new[:, None, None, :]
    tmask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=qc.device))
    a = torch.where(tmask[None, :, :, None], a, NEG)
    w = torch.exp(a)                                             # (B,L,L,nh)
    s_qk = torch.einsum("blhd,bmhd->blmh", qc, kc)
    y_intra = torch.einsum("blmh,blmh,bmhd->blhd", w, s_qk, vc)
    n_intra = torch.einsum("blmh,bmhd->blhd", w, kc)

    n_t = n_inter + n_intra
    den = torch.maximum(torch.abs(torch.einsum("blhd,blhd->blh", qc, n_t)),
                        torch.exp(-m_new)[:, None])[..., None]
    y = (y_inter + y_intra) / den                                # (B,L,nh,hd)

    # end-of-chunk state update
    scale_old = torch.exp(m0 + total - m_new)
    wk = torch.exp(ic + total[:, None] - cum_f - m_new[:, None])  # (B,L,nh)
    C_new = scale_old[..., None, None] * C + torch.einsum("blh,blhd,blhe->bhde",
                                                          wk, kc, vc)
    n_new = scale_old[..., None] * n + torch.einsum("blh,blhd->bhd", wk, kc)
    return C_new, n_new, m_new, y


def _mlstm_chunked(cfg, q, k, v, ig, fg):
    """Chunk-parallel mLSTM. All inputs fp32; q,k,v: (B,S,nh,hd). Under
    autograd each chunk runs under a checkpoint, as the reference's
    ``jax.checkpoint`` body. Raises ``ValueError`` when the chunk
    ``min(cfg.attn_chunk, S, 256)`` does not divide ``S`` (the reference
    asserts it)."""
    B, S, nh, hd = q.shape
    L = min(cfg.attn_chunk, S, 256)
    if S % L:
        raise ValueError(f"the mLSTM chunk {L} does not divide the sequence length {S}")
    C = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device)
    mst = torch.zeros((B, nh), dtype=torch.float32, device=q.device)
    ys = []
    for c0 in range(0, S, L):
        args = (C, n, mst) + tuple(a[:, c0 : c0 + L] for a in (q, k, v, ig, fg))
        if torch.is_grad_enabled():
            C, n, mst, y = checkpoint(_mlstm_chunk, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            C, n, mst, y = _mlstm_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, nh * hd)
    return y, {"C": C, "n": n, "m": mst}


# --------------------------------------------------------------------- sLSTM

def slstm_init(generator, cfg, *, device) -> dict:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    dt, std = _dtype(cfg), d ** -0.5
    return {
        "slstm": {
            "w_in": _normal(generator, (d, 4 * d), std, dt, device),
            "w_rec": _normal(generator, (nh, hd, 4 * hd), hd ** -0.5, torch.float32,
                             device),
            "w_down": _normal(generator, (d, d), std, dt, device),
        }
    }


def _slstm_step(w_rec, nh, hd, carry, zx):
    """One sLSTM time step. zx: (B, 4d) input pre-activations."""
    c, n, h, m0 = carry                   # each (B, nh, hd)
    B = zx.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h, w_rec)            # (B,nh,4hd)
    pre = zx.reshape(B, nh, 4 * hd) + rec
    zt = torch.tanh(pre[..., :hd])
    it = pre[..., hd : 2 * hd]                              # log-space input gate
    ft = F.logsigmoid(pre[..., 2 * hd : 3 * hd])            # log forget gate
    ot = torch.sigmoid(pre[..., 3 * hd :])
    m_new = torch.maximum(ft + m0, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m0 - m_new)
    c_new = f_ * c + i_ * zt
    n_new = torch.maximum(f_ * n + i_, torch.exp(-m_new))
    h_new = ot * c_new / n_new
    return (c_new, n_new, h_new, m_new), h_new


def slstm(p, cfg, x, *, cache=None, want_cache=False):
    """x: (B,S,d) -> (out, new_cache). Sequential over S. With ``cache``
    the state is read from it and written back in place. A placed ``x``
    runs placed (see the module docstring)."""
    if isinstance(x, DTensor):
        return run_placed(_slstm, "slstm", p, cfg, x, cache=cache, want_cache=want_cache,
                          out="w_down", state_dims=dict.fromkeys("cnhm", 1),
                          n_heads=cfg.n_heads)
    return _slstm(p, cfg, x, cache, want_cache, WHOLE)


def _slstm(p, cfg, x, cache, want_cache, tp):
    """The block on plain tensors, its heads split as ``tp`` says
    (:class:`~repro_torch.models.mixer_split.Split`)."""
    s = p["slstm"]
    B, S, _ = x.shape
    hd = cfg.d_model // cfg.n_heads
    zx = tp.columns(x @ s["w_in"], "w_in", 1).float()       # (B,S,4 nh hd)
    nh = zx.shape[-1] // (4 * hd)                           # this rank's heads
    names = ("c", "n", "h", "m")
    if cache is None:
        carry = tuple(torch.zeros((B, nh, hd), dtype=torch.float32, device=x.device)
                      for _ in names)
    else:
        carry = tuple(cache[k] for k in names)
    hs = []
    for t in range(S):
        carry, h = _slstm_step(s["w_rec"], nh, hd, carry, zx[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, nh * hd).to(x.dtype)
    if cache is not None:
        for k, t in zip(names, carry):
            cache[k].copy_(t)
        new_cache = cache
    else:
        new_cache = dict(zip(names, carry)) if want_cache else None
    return tp.out(y, s["w_down"]), new_cache


def init_xlstm_cache(cfg, kind: str, batch: int, *, device) -> dict:
    nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    if kind == "mlstm":
        shapes = {"C": (batch, nh, hd, hd), "n": (batch, nh, hd), "m": (batch, nh)}
    else:
        shapes = {k: (batch, nh, hd) for k in ("c", "n", "h", "m")}
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in shapes.items()}
