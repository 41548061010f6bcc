"""Unified decoder LM covering the dense, MoE, hybrid (Mamba + attention),
xLSTM and VLM families. Mirrors ``repro/models/lm.py``.

A model is a stationary *period* of layers repeated ``n_periods`` times.
Parameters keep the reference's layout: ``params["layers"][pos]`` holds
the leaves of period position ``pos`` stacked over periods (a leading
``n_periods`` axis), so weights carry over from the reference as copies.
Where the reference scans the periods with ``lax.scan``, the port walks
them in a Python loop. The serving cache is, likewise, a list over period
positions of mixer states stacked over periods: a
:class:`~repro_torch.models.layers.KVCache` with tensors ``(n_periods, B,
S, KV, hd)`` for an attention layer, a dict of state tensors for a Mamba,
mLSTM or sLSTM layer. :meth:`LM.decode_step` writes it in place.

Modes:
  apply/loss    training forward (+ the VLM's patch embeddings); ``loss``
                is the reference's chunked cross-entropy, whose (B, S, V)
                logits never exist whole, plus ``0.01 * aux / n_layers``
  prefill       forward that also returns the serving cache
  decode_step   one token against a cache: every attention layer runs the
                hand-written flash-decode kernel

With ``cfg.remat`` a training forward runs each period body under
``torch.utils.checkpoint``, as the reference wraps it in ``jax.checkpoint``:
the backward recomputes one period's activations at a time; with a period
of several layers each layer also runs under its own checkpoint inside it.
:func:`build_model` returns :class:`~repro_torch.models.encdec.EncDecLM`
for an encoder-decoder config.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm, xlstm
from repro_torch.tree import tree_map

LOSS_CHUNK = 512   # tokens a cross-entropy chunk, as the reference's


def _checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward. The
    recompute draws no randomness, so the RNG state is not saved: that
    would read the generator's state, which a CUDA graph capture refuses."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _mixer_init(generator, cfg, kind, device) -> dict:
    if kind == "attn":
        return {"attn": L.attn_init(generator, cfg, device=device)}
    if kind == "mamba":
        return ssm.mamba_init(generator, cfg, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_init(generator, cfg, device=device)
    if kind == "slstm":
        return xlstm.slstm_init(generator, cfg, device=device)
    raise ValueError(kind)


def _ffn_init(generator, cfg, kind, device):
    if kind == "dense":
        return L.mlp_init(generator, cfg, device=device)
    if kind == "moe":
        return L.moe_init(generator, cfg, device=device)
    return None


def _stacked(one, n: int):
    """``one`` (a cache entry: a KVCache or a dict of tensors) repeated
    over a new leading axis of ``n`` periods."""
    rep = lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)
    if isinstance(one, L.KVCache):
        return L.KVCache(*(rep(t) for t in one))
    return {k: rep(t) for k, t in one.items()}


def _period_slice(c, rep: int):
    """Period ``rep`` of a stacked cache entry, as views (decode writes
    through them)."""
    if isinstance(c, L.KVCache):
        return L.KVCache(c.k[rep], c.v[rep])
    return {k: t[rep] for k, t in c.items()}


def _stack_periods(cs: list):
    """Per-period cache entries stacked over a new leading axis."""
    if isinstance(cs[0], L.KVCache):
        return L.KVCache(torch.stack([c.k for c in cs]), torch.stack([c.v for c in cs]))
    return {k: torch.stack([c[k] for c in cs]) for k in cs[0]}


class LM:
    """Decoder-only LM (the VLM through its stub patch embeddings)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.mixer_kinds = cfg.layer_kinds() * (cfg.period // len(cfg.layer_kinds()))
        self.ffn_kinds = cfg.ffn_kinds()

    # ------------------------------------------------------------- params

    def _layer_init(self, generator, pos, device) -> dict:
        cfg = self.cfg
        p = {
            "mixer_norm": L.rmsnorm_init(cfg.d_model, device=device),
            "mixer": _mixer_init(generator, cfg, self.mixer_kinds[pos], device),
        }
        ffn = _ffn_init(generator, cfg, self.ffn_kinds[pos], device)
        if ffn is not None:
            p["ffn"] = ffn
            p["ffn_norm"] = L.rmsnorm_init(cfg.d_model, device=device)
        return p

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters with the reference's distributions, drawn from
        ``generator`` (on its device, in fp32, one tensor at a time, then
        cast) and placed on ``device`` (``None`` means the CUDA card). The
        bits differ from the reference's JAX draws: tests carry weights over
        with :func:`repro_torch.weights.from_jax_lm_params`."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L._dtype(cfg)
        params = {
            "embed": {"w": L._normal(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                                     dt, dev)},
            "final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
        }
        params["layers"] = [
            L.stack_layers(lambda pos=pos: self._layer_init(generator, pos, dev),
                           cfg.n_periods)
            for pos in range(cfg.period)]
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": L._normal(
                generator, (cfg.vocab_size, cfg.d_model), 0.02, dt, dev)}
        return params

    def abstract_params(self) -> dict:
        """The params tree as meta tensors: shapes and dtypes, no storage."""
        return self.init(None, device="meta")

    # ------------------------------------------------------------- caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> list:
        """Serving cache: a list (per period position) of mixer states
        stacked over periods (a KVCache of ``seq_len`` rows for attention, a
        dict of recurrent state tensors otherwise), zeros, on ``device``
        (``None`` means the CUDA card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = []
        for kind in self.mixer_kinds:
            if kind == "attn":
                c = L.init_kv_cache(cfg, batch_size, seq_len, device=dev)
            elif kind == "mamba":
                c = ssm.init_mamba_cache(cfg, batch_size, device=dev)
            else:
                c = xlstm.init_xlstm_cache(cfg, kind, batch_size, device=dev)
            caches.append(_stacked(c, cfg.n_periods))
        return caches

    # ------------------------------------------------------------ forward

    def _device(self, params) -> torch.device:
        return params["embed"]["w"].device

    def _embed(self, params, batch, dev):
        h = params["embed"]["w"][torch.as_tensor(batch["tokens"], device=dev).long()]
        if self.cfg.n_patches and "patch_embeds" in batch:
            patches = torch.as_tensor(batch["patch_embeds"], device=dev)
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        return h

    def _layer(self, pp, kind, ffn_kind, h, *, positions, mode, cache, cache_pos):
        """One layer: ``(h, new_cache, aux)``."""
        cfg = self.cfg
        hn = L.rmsnorm(pp["mixer_norm"], h)
        prefill = mode == "prefill"
        decode_cache = cache if mode == "decode" else None
        if kind == "attn":
            out, new_cache = L.attention(
                pp["mixer"]["attn"], cfg, hn, positions=positions,
                cache=decode_cache, cache_pos=cache_pos, prefill=prefill)
        elif kind == "mamba":
            out, new_cache = ssm.mamba(pp["mixer"], cfg, hn, cache=decode_cache,
                                       want_cache=prefill)
        elif kind == "mlstm":
            out, new_cache = xlstm.mlstm(pp["mixer"], cfg, hn, cache=decode_cache,
                                         want_cache=prefill)
        else:
            out, new_cache = xlstm.slstm(pp["mixer"], cfg, hn, cache=decode_cache,
                                         want_cache=prefill)
        h = h + out
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if ffn_kind != "none":
            hn = L.rmsnorm(pp["ffn_norm"], h)
            if ffn_kind == "dense":
                h = h + L.mlp(pp["ffn"], hn)
            else:
                y, aux = L.moe(pp["ffn"], cfg, hn)
                h = h + y
        return h, new_cache, aux

    def _stack(self, params, h, *, positions, mode, caches=None, cache_pos=None):
        """Every layer in order; returns ``(h, aux, caches)``: ``aux`` summed
        over layers, and the prefill's new caches stacked over periods, the
        decode caches as updated in place, or None."""
        cfg = self.cfg
        new = [[] for _ in range(cfg.period)]
        train = mode == "train" and torch.is_grad_enabled()
        nested = cfg.remat and train and cfg.period > 1

        def layer(pp, pos, h, c_in):
            kind, ffn_kind = self.mixer_kinds[pos], self.ffn_kinds[pos]
            if nested:   # each layer under its own checkpoint, inside the period's
                def run(h_):
                    h_, _, a_ = self._layer(pp, kind, ffn_kind, h_, positions=positions,
                                            mode=mode, cache=None, cache_pos=None)
                    return h_, a_
                h, a = _checkpointed(run, h)
                return h, None, a
            return self._layer(pp, kind, ffn_kind, h, positions=positions, mode=mode,
                               cache=c_in, cache_pos=cache_pos)

        def period_body(h, aux, rep):
            out = []
            for pos in range(cfg.period):
                pp = tree_map(lambda t: t[rep], params["layers"][pos])
                c_in = _period_slice(caches[pos], rep) if caches is not None else None
                h, c, a = layer(pp, pos, h, c_in)
                aux = aux + a
                out.append(c)
            return h, aux, out

        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for rep in range(cfg.n_periods):
            if cfg.remat and train:
                h, aux = _checkpointed(lambda h_, a_, r=rep: period_body(h_, a_, r)[:2],
                                       h, aux)
                continue
            h, aux, cs = period_body(h, aux, rep)
            for pos, c in enumerate(cs):
                new[pos].append(c)
        if mode == "decode":
            return h, aux, caches
        if mode == "prefill":
            return h, aux, [_stack_periods(cs) for cs in new]
        return h, aux, None

    def _logits(self, params, h):
        cfg = self.cfg
        w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]
        # the reference's fp32 head: a bf16 head is cast each call (no
        # cached fp32 copy), as the reference does
        return h.float() @ w.float().T

    def apply(self, params, batch, *, mode="train"):
        """Forward over ``batch["tokens"] (B, S)`` (after the VLM's
        ``batch["patch_embeds"]``, when given): ``(logits (B, S, V), aux)``
        for ``mode="train"``, ``(last logits (B, 1, V), caches)`` for
        ``mode="prefill"``. ``aux`` is the MoE layers' summed balance loss
        (zero without MoE)."""
        dev = self._device(params)
        h = self._embed(params, batch, dev)
        positions = torch.arange(h.shape[1], device=dev)
        h, aux, caches = self._stack(params, h, positions=positions, mode=mode)
        h = L.rmsnorm(params["final_norm"], h)
        if mode == "prefill":
            return self._logits(params, h[:, -1:]), caches
        return self._logits(params, h), aux

    def loss(self, params, batch):
        """``(loss, {"ce", "aux"})`` over ``batch["tokens"]`` (and the
        VLM's ``batch["patch_embeds"]``) and ``batch["targets"]`` (B, S); a
        target below 0 is masked out. The cross-entropy runs in chunks of
        ``min(512, S)`` positions (all of ``S`` when 512 does not divide
        it), each computing fp32 logits, a logsumexp and the target's
        log-likelihood under a checkpoint, so only one chunk's ``(B, chunk,
        V)`` logits exist at a time, forward or backward. The chunks' sums
        add in order. The loss adds ``0.01 * aux / n_layers``."""
        cfg = self.cfg
        dev = self._device(params)
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        h = self._embed(params, batch, dev)
        positions = torch.arange(h.shape[1], device=dev)
        h, aux, _ = self._stack(params, h, positions=positions, mode="train")
        h = L.rmsnorm(params["final_norm"], h)
        w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]

        def chunk_ce(h_c, t_c, w_):
            logits = h_c.float() @ w_.float().T
            lse = torch.logsumexp(logits, dim=-1)
            # gather refuses a negative index, which the mask zeroes anyway
            ll = logits.gather(-1, t_c.clamp(min=0)[..., None])[..., 0] - lse
            mask = (t_c >= 0).float()
            return -(ll * mask).sum(), mask.sum()

        S = h.shape[1]
        chunk = min(LOSS_CHUNK, S)
        if S % chunk:
            chunk = S   # odd lengths: one chunk
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = torch.zeros((), dtype=torch.float32, device=dev)
        for c0 in range(0, S, chunk):
            s, n = _checkpointed(chunk_ce, h[:, c0:c0 + chunk],
                                 targets[:, c0:c0 + chunk], w)
            tot, cnt = tot + s, cnt + n
        ce = tot / torch.clamp(cnt, min=1.0)
        return ce + 0.01 * aux / max(cfg.n_layers, 1), {"ce": ce, "aux": aux}

    # ----------------------------------------------------------- serving

    def prefill(self, params, batch):
        """Returns (last_logits, cache-list) for subsequent decode steps."""
        return self.apply(params, batch, mode="prefill")

    def decode_step(self, params, cache, batch):
        """batch: tokens (B,1), pos (B,). Returns ``(logits (B, 1, V),
        cache)``; the cache is written in place (the reference returns a
        new one) and returned."""
        dev = self._device(params)
        pos = torch.as_tensor(batch["pos"], device=dev).long()
        h = params["embed"]["w"][torch.as_tensor(batch["tokens"], device=dev).long()]
        h, _, cache = self._stack(params, h, positions=pos[:, None], mode="decode",
                                  caches=cache, cache_pos=pos)
        h = L.rmsnorm(params["final_norm"], h)
        return self._logits(params, h), cache


@functools.lru_cache(maxsize=64)
def _cached_model(cfg):
    from repro_torch.models.encdec import EncDecLM

    if cfg.encoder_layers:
        return EncDecLM(cfg)
    return LM(cfg)


def build_model(cfg):
    """The model of ``cfg``: an :class:`~repro_torch.models.encdec.EncDecLM`
    for an encoder-decoder config, an :class:`LM` otherwise."""
    return _cached_model(cfg)
