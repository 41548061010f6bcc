"""Encoder-decoder LM (the whisper-large-v3 backbone). Mirrors
``repro/models/encdec.py``.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(B, n_frames, d_model)``.

Encoder: bidirectional attention and sinusoidal positions. Decoder: causal
self-attention (KV-cached for decode, through the hand-written flash-decode
kernel), cross-attention over the encoder output (its K/V computed once at
prefill and carried in the cache) and a SwiGLU FFN. Layers are stacked
over a leading axis, walked in a Python loop where the reference scans
them. The decode step writes the self-attention cache in place.

**Placed.** A parameter tree placed over a mesh
(:func:`~repro_torch.distributed.sharding.distribute_params`) runs placed,
as :class:`~repro_torch.models.lm.LM` does, with the reference's hints: the
frames and the decoder's embeddings enter split over the batch axes
(``shard_batch``), every layer's input and output are constrained to
``(BATCH, None, None)``, the token and position lookups are vocab-parallel
(the reference's rules put ``decoder/pos_embed/w``'s rows over ``model``:
its path matches the embedding's rule first), the logits come out
``(BATCH, None, MODEL)`` and the loss is the vocab-parallel cross-entropy.
The cross attention takes the attention core's route
(``attention(kv_override=)``): its K/V, from the prefill or from a placed
cross cache, are laid out beside the queries, the sequence whole.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import BATCH, MODEL, constrain, shard_batch
from repro_torch.models import layers as L
from repro_torch.models.lm import _embed_placed, _vocab_parallel_ce, lookup_placed
from repro_torch.tree import tree_map


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    MAX_DEC_SEQ = 32_768  # learned decoder position table extent

    def __init__(self, cfg):
        self.cfg = cfg

    # ------------------------------------------------------------- params

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters with the reference's layout and distributions,
        drawn from ``generator`` and placed on ``device`` (``None`` means
        the CUDA card); the bits differ from the reference's draws."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L._dtype(cfg)
        d = cfg.d_model

        def enc_layer():
            return {
                "mixer_norm": L.rmsnorm_init(d, device=dev),
                "mixer": {"attn": L.attn_init(generator, cfg, device=dev)},
                "ffn_norm": L.rmsnorm_init(d, device=dev),
                "ffn": L.mlp_init(generator, cfg, device=dev),
            }

        def dec_layer():
            return {
                "self_norm": L.rmsnorm_init(d, device=dev),
                "self": {"attn": L.attn_init(generator, cfg, device=dev)},
                "cross_norm": L.rmsnorm_init(d, device=dev),
                "cross": {"attn": L.attn_init(generator, cfg, cross=True, device=dev)},
                "ffn_norm": L.rmsnorm_init(d, device=dev),
                "ffn": L.mlp_init(generator, cfg, device=dev),
            }

        return {
            "encoder": {
                "layers": L.stack_layers(enc_layer, cfg.encoder_layers),
                "final_norm": L.rmsnorm_init(d, device=dev),
            },
            "decoder": {
                "embed": {"w": L._normal(generator, (cfg.vocab_size, d), 0.02, dt, dev)},
                "pos_embed": {"w": L._normal(generator, (self.MAX_DEC_SEQ, d), 0.02,
                                             dt, dev)},
                "layers": L.stack_layers(dec_layer, cfg.n_layers),
                "final_norm": L.rmsnorm_init(d, device=dev),
            },
        }

    def abstract_params(self) -> dict:
        """The params tree as meta tensors: shapes and dtypes, no storage."""
        return self.init(None, device="meta")

    def _device(self, params) -> torch.device:
        return self.embed_weight(params).device

    def embed_weight(self, params):
        """The token embedding table (the LM head's weight too)."""
        return params["decoder"]["embed"]["w"]

    # ------------------------------------------------------------ encoder

    def encode(self, params, frames):
        """The encoder over ``frames`` (B, n_frames, d): bidirectional
        attention, sinusoidal positions, the final norm. With ``cfg.remat``
        under autograd each layer runs under a checkpoint."""
        with sharding.placement_of(self.embed_weight(params)):
            return self._encode(params, frames)

    def _encode(self, params, frames):
        cfg = self.cfg
        dev = self._device(params)
        frames = torch.as_tensor(frames, device=dev)
        h = frames + _sinusoid(frames.shape[1], cfg.d_model, dev).to(frames.dtype)
        h = shard_batch(h)
        positions = torch.arange(h.shape[1], device=dev)

        def body(h, lp):
            h = constrain(h, BATCH, None, None)
            hn = constrain(L.rmsnorm(lp["mixer_norm"], h), BATCH, None, None)
            out, _ = L.attention(lp["mixer"]["attn"], cfg, hn, positions=positions,
                                 causal=False)
            h = constrain(h + out, BATCH, None, None)
            hn = constrain(L.rmsnorm(lp["ffn_norm"], h), BATCH, None, None)
            return constrain(h + L.mlp(lp["ffn"], hn), BATCH, None, None)

        layers = params["encoder"]["layers"]
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.encoder_layers):
            lp = tree_map(lambda t: t[i], layers)
            h = (checkpoint(body, h, lp, use_reentrant=False, preserve_rng_state=False)
                 if remat else body(h, lp))
        return L.rmsnorm(params["encoder"]["final_norm"], h)

    # ------------------------------------------------------------ decoder

    def _dec_embed(self, params, tokens, pos0):
        """Token plus learned position embeddings: positions ``pos0 ..``
        for an int ``pos0``, each sequence's own ``pos0[b]`` for a (B,)
        tensor (decode). Placed, both lookups are vocab-parallel
        (:func:`~repro_torch.models.lm.lookup_placed`) on this rank's batch
        rows."""
        dec = params["decoder"]
        if isinstance(dec["embed"]["w"], DTensor):
            return self._dec_embed_placed(dec, tokens, pos0)
        h = dec["embed"]["w"][tokens.long()]
        if isinstance(pos0, int):
            pe = dec["pos_embed"]["w"][pos0 : pos0 + tokens.shape[1]]
        else:
            pe = dec["pos_embed"]["w"][pos0.long()][:, None, :]
        return h + pe

    def _dec_embed_placed(self, dec, tokens, pos0):
        h = _embed_placed(dec["embed"]["w"], tokens.long())
        group, _ = sharding.split_group(h, 0)
        if isinstance(pos0, int):
            idx = torch.arange(pos0, pos0 + tokens.shape[1], device=tokens.device)
            pe = lookup_placed(dec["pos_embed"]["w"], idx, group)
        else:
            idx = shard_batch(pos0.long()).to_local()
            pe = lookup_placed(dec["pos_embed"]["w"], idx, group)[:, None, :]
        out = DTensor.from_local(h.to_local() + pe, h.device_mesh, h.placements,
                                 run_check=False)
        return shard_batch(out)

    def _decoder_stack(self, params, h, h_enc, *, positions, mode, caches=None,
                       cache_pos=None):
        """Every decoder layer; returns ``(h after the final norm, caches)``:
        the prefill's ``{"self", "cross"}`` KVCaches stacked over layers, the
        decode caches as updated in place, or None."""
        cfg = self.cfg
        KV, hd = cfg.n_kv_heads, cfg.head_dim

        def body(h, lp, i):
            h = constrain(h, BATCH, None, None)
            hn = constrain(L.rmsnorm(lp["self_norm"], h), BATCH, None, None)
            self_cache = None
            if mode == "decode":
                self_cache = L.KVCache(caches["self"].k[i], caches["self"].v[i])
            out, new_self = L.attention(lp["self"]["attn"], cfg, hn, positions=positions,
                                        cache=self_cache, cache_pos=cache_pos,
                                        prefill=mode == "prefill")
            h = constrain(h + out, BATCH, None, None)
            hn = constrain(L.rmsnorm(lp["cross_norm"], h), BATCH, None, None)
            if mode == "decode":
                kv = (caches["cross"].k[i], caches["cross"].v[i])
            else:
                kv = (L._heads(L.dense(lp["cross"]["attn"]["wk"], h_enc), KV, hd),
                      L._heads(L.dense(lp["cross"]["attn"]["wv"], h_enc), KV, hd))
            out, _ = L.attention(lp["cross"]["attn"], cfg, hn, positions=positions,
                                 causal=False, kv_override=kv)
            h = constrain(h + out, BATCH, None, None)
            hn = constrain(L.rmsnorm(lp["ffn_norm"], h), BATCH, None, None)
            h = constrain(h + L.mlp(lp["ffn"], hn), BATCH, None, None)
            return h, new_self, kv

        layers = params["decoder"]["layers"]
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        selfs, crosses = [], []
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], layers)
            if remat:
                h = checkpoint(lambda h_, lp_, i_=i: body(h_, lp_, i_)[0], h, lp,
                               use_reentrant=False, preserve_rng_state=False)
                continue
            h, new_self, kv = body(h, lp, i)
            if mode == "prefill":
                selfs.append(new_self)
                crosses.append(kv)
        h = L.rmsnorm(params["decoder"]["final_norm"], h)
        if mode == "prefill":
            stack = lambda pairs: L.KVCache(torch.stack([p[0] for p in pairs]),
                                            torch.stack([p[1] for p in pairs]))
            return h, {"self": stack(selfs), "cross": stack(crosses)}
        return h, caches if mode == "decode" else None

    def _logits(self, params, h):
        w = sharding.gather_param(self.embed_weight(params))
        return constrain(h.float() @ w.float().T, BATCH, None, MODEL)

    # ------------------------------------------------------------- public

    def apply(self, params, batch, *, mode="train"):
        """``batch["frames"]`` (B, n_frames, d) and ``batch["tokens"]`` (B,
        S): ``(logits (B, S, V), aux = 0)`` for ``mode="train"``, ``(last
        logits (B, 1, V), caches)`` for ``mode="prefill"``."""
        with sharding.placement_of(self.embed_weight(params)):
            h, caches = self._forward(params, batch, mode)
            if mode == "prefill":
                return self._logits(params, h[:, -1:]), caches
            zero = torch.zeros((), dtype=torch.float32, device=self._device(params))
            return self._logits(params, h), zero

    def _forward(self, params, batch, mode):
        """The encoder, then the decoder over ``batch["tokens"]``: ``(h after
        the final norm, caches)``."""
        dev = self._device(params)
        h_enc = self.encode(params, batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        h = self._dec_embed(params, tokens, 0)
        positions = torch.arange(tokens.shape[1], device=dev)
        return self._decoder_stack(params, h, h_enc, positions=positions, mode=mode)

    def loss(self, params, batch):
        """``(ce, {"ce", "aux"})``: the reference's full ``log_softmax``
        cross-entropy over ``batch["targets"]`` (B, S), a target below 0
        masked out. Placed, the vocab-parallel cross-entropy
        (:func:`~repro_torch.models.lm._vocab_parallel_ce`): a plain scalar,
        the same on every rank."""
        w = self.embed_weight(params)
        if not isinstance(w, DTensor):
            logits, aux = self.apply(params, batch)
            targets = torch.as_tensor(batch["targets"], device=logits.device).long()
            logp = torch.log_softmax(logits, dim=-1)
            ll = logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
            mask = (targets >= 0).float()
            ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            return ce, {"ce": ce, "aux": aux}
        with sharding.placement_of(w):
            dev = self._device(params)
            h, _ = self._forward(params, batch, "train")
            targets = shard_batch(torch.as_tensor(batch["targets"], device=dev).long())
            tot, cnt = _vocab_parallel_ce(h, targets, sharding.gather_param(w))
            ce = tot / torch.clamp(cnt, min=1.0)
            return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=dev)}

    def prefill(self, params, batch):
        return self.apply(params, batch, mode="prefill")

    def decode_step(self, params, cache, batch):
        """batch: tokens (B,1), pos (B,). Returns ``(logits (B, 1, V),
        cache)``; the self-attention cache is written in place."""
        with sharding.placement_of(self.embed_weight(params)):
            dev = self._device(params)
            pos = torch.as_tensor(batch["pos"], device=dev).long()
            h = self._dec_embed(params, torch.as_tensor(batch["tokens"], device=dev), pos)
            h, cache = self._decoder_stack(params, h, None, positions=pos[:, None],
                                           mode="decode", caches=cache, cache_pos=pos)
            return self._logits(params, h), cache

    def init_cache(self, batch_size: int, seq_len: int, device=None, *, mesh=None) -> dict:
        """``{"self", "cross"}`` KVCaches stacked over decoder layers: self
        ``seq_len`` rows, cross ``n_frames``; zeros in the config's dtype on
        ``device`` (``None`` means the CUDA card). ``mesh=`` (a
        ``DeviceMesh``) places both by
        :func:`~repro_torch.distributed.sharding.cache_specs`: the slots over
        the data-parallel axes, the sequence over ``model`` where it
        divides."""
        caches = self._init_cache(batch_size, seq_len, device)
        if mesh is None:
            return caches
        shape = type("CacheShape", (), {"global_batch": batch_size})
        with sharding.use_mesh(mesh):
            specs = sharding.cache_specs(self.cfg, caches, shape)
        return sharding.place_tree(caches, mesh, specs)

    def _init_cache(self, batch_size: int, seq_len: int, device) -> dict:
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L._dtype(cfg)
        nl, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

        def kv(rows):
            shape = (nl, batch_size, rows, KV, hd)
            return L.KVCache(torch.zeros(shape, dtype=dt, device=dev),
                             torch.zeros(shape, dtype=dt, device=dev))

        return {"self": kv(seq_len), "cross": kv(cfg.n_frames)}
