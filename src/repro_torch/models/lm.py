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

**Placed.** A parameter tree placed over a mesh
(:func:`~repro_torch.distributed.sharding.distribute_params`) runs placed:
every mode enters its parameters' mesh (``sharding.placement_of``), the
tokens enter it split over the batch axes, the embedding is a
vocab-parallel gather whose partial sums are reduced at once, each layer's
input and output are constrained as the reference's (batch split, replicated
over ``model``), the logits come out ``(BATCH, None, MODEL)``, and the loss
is a vocab-parallel cross-entropy that never gathers a chunk's logits.
The recurrent mixers (Mamba, mLSTM, sLSTM) run on each rank's shards
(:mod:`repro_torch.models.mixer_split`); a prefill returns their states
placed by :func:`~repro_torch.distributed.sharding.cache_specs`, and a
decode step writes them in place in that layout.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import enter, reduce
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


def _layer_leaf(t, rep: int):
    """Period ``rep`` of a stacked parameter; a placed one whose stacked
    axis is split is gathered first."""
    if isinstance(t, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in t.placements):
        t = sharding.gather_param(t)
    return t[rep]


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

    def init_cache(self, batch_size: int, seq_len: int, device=None, *, mesh=None) -> list:
        """Serving cache: a list (per period position) of mixer states
        stacked over periods (a KVCache of ``seq_len`` rows for attention, a
        dict of recurrent state tensors otherwise), zeros, on ``device``
        (``None`` means the CUDA card). ``mesh=`` (a ``DeviceMesh``) places
        each by :func:`~repro_torch.distributed.sharding.cache_specs`: the
        slots over the data-parallel axes, an attention cache's sequence
        over ``model``."""
        caches = self._init_cache(batch_size, seq_len, device)
        if mesh is None:
            return caches
        shape = type("CacheShape", (), {"global_batch": batch_size})
        with sharding.use_mesh(mesh):
            specs = sharding.cache_specs(self.cfg, caches, shape)
        return sharding.place_tree(caches, mesh, specs)

    def _init_cache(self, batch_size: int, seq_len: int, device) -> list:
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
        return self.embed_weight(params).device

    def embed_weight(self, params):
        """The token embedding table (its placement is the model's)."""
        return params["embed"]["w"]

    def _embed(self, params, batch, dev):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        w = params["embed"]["w"]
        h = w[tokens] if not isinstance(w, DTensor) else _embed_placed(w, tokens)
        if self.cfg.n_patches and "patch_embeds" in batch:
            patches = torch.as_tensor(batch["patch_embeds"], device=dev)
            patches = sharding.shard_batch(patches)
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        return h

    def _layer(self, pp, kind, ffn_kind, h, *, positions, mode, cache, cache_pos):
        """One layer: ``(h, new_cache, aux)``."""
        cfg = self.cfg
        h = sharding.constrain(h, sharding.BATCH, None, None)
        hn = sharding.constrain(L.rmsnorm(pp["mixer_norm"], h), sharding.BATCH, None, None)
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
        # placed: the row-parallel projection's partial sums, all-reduced
        h = h + sharding.constrain(out, sharding.BATCH, None, None)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if ffn_kind != "none":
            hn = sharding.constrain(L.rmsnorm(pp["ffn_norm"], h), sharding.BATCH, None, None)
            if ffn_kind == "dense":
                y = L.mlp(pp["ffn"], hn)
            else:
                y, aux = L.moe(pp["ffn"], cfg, hn)
            h = h + sharding.constrain(y, sharding.BATCH, None, None)
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
                pp = tree_map(lambda t: _layer_leaf(t, rep), params["layers"][pos])
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
        logits = h.float() @ sharding.gather_param(w).float().T
        return sharding.constrain(logits, sharding.BATCH, None, sharding.MODEL)

    def apply(self, params, batch, *, mode="train"):
        """Forward over ``batch["tokens"] (B, S)`` (after the VLM's
        ``batch["patch_embeds"]``, when given): ``(logits (B, S, V), aux)``
        for ``mode="train"``, ``(last logits (B, 1, V), caches)`` for
        ``mode="prefill"``. ``aux`` is the MoE layers' summed balance loss
        (zero without MoE)."""
        with sharding.placement_of(self.embed_weight(params)):
            return self._apply(params, batch, mode)

    def _apply(self, params, batch, mode):
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
        add in order. The loss adds ``0.01 * aux / n_layers``. Placed, each
        chunk is a vocab-parallel cross-entropy (:func:`_vocab_parallel_ce`)
        and the loss a plain scalar, the same on every rank."""
        with sharding.placement_of(self.embed_weight(params)):
            return self._loss(params, batch)

    def _loss(self, params, batch):
        cfg = self.cfg
        dev = self._device(params)
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        h = self._embed(params, batch, dev)
        positions = torch.arange(h.shape[1], device=dev)
        h, aux, _ = self._stack(params, h, positions=positions, mode="train")
        h = L.rmsnorm(params["final_norm"], h)
        w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]
        if isinstance(w, DTensor):
            targets = sharding.shard_batch(targets)
            w = sharding.gather_param(w)

        def chunk_ce(h_c, t_c, w_):
            if isinstance(w_, DTensor):
                return _vocab_parallel_ce(h_c, t_c, w_)
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
        with sharding.placement_of(self.embed_weight(params)):
            return self._decode_step(params, cache, batch)

    def _decode_step(self, params, cache, batch):
        dev = self._device(params)
        pos = torch.as_tensor(batch["pos"], device=dev).long()
        h = self._embed(params, {"tokens": batch["tokens"]}, dev)
        h, _, cache = self._stack(params, h, positions=pos[:, None], mode="decode",
                                  caches=cache, cache_pos=pos)
        h = L.rmsnorm(params["final_norm"], h)
        return self._logits(params, h), cache


def _embed_placed(w, tokens):
    """The embedding gather of a placed table ``w`` (V, d) on each rank's
    local shards: the tokens enter the mesh split over the batch axes and
    each rank indexes its table shard with its own tokens, as the unplaced
    path indexes the whole table (DTensor's own gathers are not used: its
    masked gather cannot take its gradient back from the reduced rows);
    :func:`lookup_placed` does the lookup."""
    tok = sharding.shard_batch(tokens)
    batch_group, _ = sharding.split_group(tok, 0)
    rows = lookup_placed(w, tok.to_local(), batch_group)
    return DTensor.from_local(rows, w.device_mesh, tok.placements, run_check=False)


def lookup_placed(w, idx, batch_group):
    """Rows ``idx`` (a plain index tensor, this rank's) of the placed table
    ``w`` (V, d), plain. Under ``fsdp`` the table is gathered first
    (:func:`~repro_torch.distributed.sharding.gather_param`). A table split
    over its rows (``model``) is Megatron's vocab-parallel gather: each rank
    reads the rows its slice holds (zeros for the others) and ``reduce``
    sums the partial rows over the table's ranks at once. The table enters
    over ``batch_group``, the ranks whose rows of the batch differ, whose
    partial gradients it sums."""
    w = sharding.gather_param(w)
    wl = w.to_local()
    if batch_group is not None:
        wl = enter(wl, batch_group)
    vocab_group, vr = sharding.split_group(w, 0)
    if vocab_group is None:
        return wl[idx]
    V_l = wl.shape[0]
    rel = idx - vr * V_l
    inside = ((rel >= 0) & (rel < V_l))[..., None]
    rows = torch.where(inside, wl[rel.clamp(0, V_l - 1)],
                       torch.zeros((), dtype=wl.dtype, device=wl.device))
    return reduce(rows, vocab_group)


def _vocab_parallel_ce(h_c, t_c, w):
    """One chunk's ``(sum of -log p(target) over unmasked targets, count)``
    with the logits split over the vocabulary, as Megatron's cross-entropy:
    each rank holds ``logits[..., v0:v0 + V_l]`` of its batch rows, takes
    its local max (reduced by max over the vocabulary's ranks; no gradient
    flows through a max that only shifts), its sum of ``exp`` and the
    target's logit where this rank's slice holds the target (both summed
    over the vocabulary's ranks by ``reduce``: all-reduce forward, identity
    backward). The chunk's ``(B, chunk, V)`` logits are never gathered.
    The sums over batch rows are reduced over the batch's ranks. Plain
    scalars, the same on every rank."""
    logits = sharding.constrain(h_c.float() @ w.float().T,
                                sharding.BATCH, None, sharding.MODEL)
    ll, tl = logits.to_local(), _local_rows_like(t_c, logits)
    vocab_group, vr = sharding.split_group(logits, 2)
    V_l = ll.shape[-1]
    m = ll.detach().amax(-1)
    if vocab_group is not None:
        m = funcol.all_reduce(m, "max", vocab_group)
    se = torch.exp(ll - m[..., None]).sum(-1)
    rel = tl - vr * V_l
    inside = (rel >= 0) & (rel < V_l)
    picked = ll.gather(-1, rel.clamp(0, V_l - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    if vocab_group is not None:
        se, picked = reduce(se, vocab_group), reduce(picked, vocab_group)
    ll_t = picked - (m + torch.log(se))
    mask = (tl >= 0).float()
    tot, cnt = -(ll_t * mask).sum(), mask.sum()
    batch_group, _ = sharding.split_group(logits, 0)
    if batch_group is not None:
        tot, cnt = reduce(tot, batch_group), reduce(cnt, batch_group)
    return tot, cnt


def _local_rows_like(t, ref):
    """This rank's local block of the placed ``t`` (B, c), laid out over
    the batch as ``ref``'s dimension 0 and replicated elsewhere."""
    mesh = ref.device_mesh
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in ref.placements)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local()


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
