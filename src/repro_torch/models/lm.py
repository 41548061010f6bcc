"""Decoder-only LM of the dense family. Mirrors ``repro/models/lm.py``.

A model is a stationary *period* of layers repeated ``n_periods`` times.
Parameters keep the reference's layout: ``params["layers"][pos]`` holds
the leaves of period position ``pos`` stacked over periods (a leading
``n_periods`` axis), so weights carry over from the reference as copies.
Where the reference scans the periods with ``lax.scan``, the port walks
them in a Python loop. The serving cache is, likewise, a list over period
positions of :class:`~repro_torch.models.layers.KVCache` with tensors
``(n_periods, B, S, KV, hd)``; :meth:`LM.decode_step` writes it in place.

Modes:
  apply         forward over a whole sequence (``mode`` "train" or "prefill")
  prefill       forward that also returns the serving cache
  decode_step   one token against a cache: every layer's attention runs the
                hand-written flash-decode kernel

The MoE, Mamba, xLSTM, encoder-decoder and VLM families and ``loss`` are
not ported yet (ROADMAP queue 1 item 12): :func:`build_model` raises
``NotImplementedError`` for them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 12)"


class LM:
    """Dense decoder-only LM."""

    def __init__(self, cfg):
        self.cfg = cfg

    # ------------------------------------------------------------- params

    def _layer_init(self, generator, device) -> dict:
        cfg = self.cfg
        return {
            "mixer_norm": L.rmsnorm_init(cfg.d_model, device=device),
            "mixer": {"attn": L.attn_init(generator, cfg, device=device)},
            "ffn": L.mlp_init(generator, cfg, device=device),
            "ffn_norm": L.rmsnorm_init(cfg.d_model, device=device),
        }

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
        layers = [None] * cfg.period
        for rep in range(cfg.n_periods):
            for pos in range(cfg.period):
                one = self._layer_init(generator, dev)
                if layers[pos] is None:   # stacked over periods, filled layer by layer
                    layers[pos] = tree_map(
                        lambda t: t.new_empty((cfg.n_periods,) + tuple(t.shape)), one)
                tree_map(lambda dst, src, r=rep: dst[r].copy_(src), layers[pos], one)
        params["layers"] = layers
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": L._normal(
                generator, (cfg.vocab_size, cfg.d_model), 0.02, dt, dev)}
        return params

    def abstract_params(self) -> dict:
        """The params tree as meta tensors: shapes and dtypes, no storage."""
        return self.init(None, device="meta")

    # ------------------------------------------------------------- caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> list:
        """Serving cache: a list (per period position) of KV caches stacked
        over periods, zeros in the config's dtype, on ``device`` (``None``
        means the CUDA card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = []
        for _ in range(cfg.period):
            c = L.init_kv_cache(cfg, batch_size, seq_len, device=dev)
            caches.append(L.KVCache(*(t.unsqueeze(0).repeat(
                (cfg.n_periods,) + (1,) * t.ndim) for t in c)))
        return caches

    # ------------------------------------------------------------ forward

    def _device(self, params) -> torch.device:
        return params["embed"]["w"].device

    def _embed(self, params, tokens):
        return params["embed"]["w"][tokens.long()]

    def _layer(self, pp, h, *, positions, mode, cache, cache_pos):
        cfg = self.cfg
        hn = L.rmsnorm(pp["mixer_norm"], h)
        out, new_cache = L.attention(
            pp["mixer"]["attn"], cfg, hn, positions=positions,
            cache=cache if mode == "decode" else None, cache_pos=cache_pos,
            prefill=mode == "prefill",
        )
        h = h + out
        hn = L.rmsnorm(pp["ffn_norm"], h)
        return h + L.mlp(pp["ffn"], hn), new_cache

    def _stack(self, params, h, *, positions, mode, caches=None, cache_pos=None):
        """Every layer in order; returns ``(h, caches)``: the prefill's new
        caches stacked over periods, the decode caches as updated in place,
        or None."""
        cfg = self.cfg
        new = [[] for _ in range(cfg.period)]
        for rep in range(cfg.n_periods):
            for pos in range(cfg.period):
                pp = tree_map(lambda t, r=rep: t[r], params["layers"][pos])
                c_in = None
                if caches is not None:
                    c_in = L.KVCache(caches[pos].k[rep], caches[pos].v[rep])
                h, c = self._layer(pp, h, positions=positions, mode=mode,
                                   cache=c_in, cache_pos=cache_pos)
                new[pos].append(c)
        if mode == "decode":
            return h, caches
        if mode == "prefill":
            return h, [L.KVCache(torch.stack([c.k for c in cs]),
                                 torch.stack([c.v for c in cs])) for cs in new]
        return h, None

    def _logits(self, params, h):
        cfg = self.cfg
        w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]
        # the reference's fp32 head: a bf16 head is cast each call (no
        # cached fp32 copy), as the reference does
        return h.float() @ w.float().T

    def apply(self, params, batch, *, mode="train"):
        """Forward over ``batch["tokens"] (B, S)``: ``(logits (B, S, V),
        aux)`` for ``mode="train"``, ``(last logits (B, 1, V), caches)``
        for ``mode="prefill"``. ``aux`` (an MoE's balance loss in the
        reference) is zero for the dense family."""
        dev = self._device(params)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        h = self._embed(params, tokens)
        positions = torch.arange(h.shape[1], device=dev)
        h, caches = self._stack(params, h, positions=positions, mode=mode)
        h = L.rmsnorm(params["final_norm"], h)
        if mode == "prefill":
            return self._logits(params, h[:, -1:]), caches
        return self._logits(params, h), torch.zeros((), dtype=torch.float32, device=dev)

    # ----------------------------------------------------------- serving

    def prefill(self, params, batch):
        """Returns (last_logits, cache-list) for subsequent decode steps."""
        return self.apply(params, batch, mode="prefill")

    def decode_step(self, params, cache, batch):
        """batch: tokens (B,1), pos (B,). Returns ``(logits (B, 1, V),
        cache)``; the cache is written in place (the reference returns a
        new one) and returned."""
        dev = self._device(params)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        pos = torch.as_tensor(batch["pos"], device=dev).long()
        h = self._embed(params, tokens)
        h, cache = self._stack(params, h, positions=pos[:, None], mode="decode",
                               caches=cache, cache_pos=pos)
        h = L.rmsnorm(params["final_norm"], h)
        return self._logits(params, h), cache


@functools.lru_cache(maxsize=64)
def _cached_model(cfg) -> LM:
    return LM(cfg)


def build_model(cfg) -> LM:
    """The model of ``cfg``. Raises ``NotImplementedError`` for a config the
    port does not cover yet: an encoder-decoder, a VLM or any family other
    than ``dense``."""
    if cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder LM {_NOT_PORTED}")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: the VLM's patch embeddings {_NOT_PORTED}")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family {_NOT_PORTED}")
    return _cached_model(cfg)
