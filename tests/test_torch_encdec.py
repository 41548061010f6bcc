"""The port's encoder-decoder LM (``models/encdec.py``, the Whisper
backbone) and cross-attention (``attention(kv_override=)``) against the
reference on the CPU with carried weights, reduced whisper-large-v3, fp32
within 1e-5 of the reference's largest value: the encoder, ``loss``,
``prefill`` (last logits, self and cross caches) and decode steps through
the decode kernel's plain version (logits and the cache written in place);
the parameter and cache layouts; teacher-forced decode against the
forward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import build_model
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_lm_cache, from_jax_lm_params

ARCH = "whisper-large-v3"
REL, ABS = 1e-5, 1e-6   # fp32: max |port - ref| <= REL * max|ref| + ABS
B, S = 2, 12


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(jget_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL, abs_=ABS):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    batch = {"frames": rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["targets"][0, :3] = -1
    return jcfg, cfg, jm, m, jp, from_jax_lm_params(_np(jp), cfg, "cpu"), batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_build_model_gives_the_encoder_decoder(models):
    jcfg, cfg, jm, m, *_ = models
    assert isinstance(m, EncDecLM) and m.MAX_DEC_SEQ == jm.MAX_DEC_SEQ
    assert build_model(cfg) is m


def test_cross_attention_matches_the_reference():
    """``attention(kv_override=)``: no RoPE (even where the config has
    it), no cache write, the given cache returned as it was."""
    jcfg, cfg = _cfgs(rope_theta=10_000.0, n_kv_heads=2)
    jp = JL.attn_init(jax.random.key(2), jcfg, cross=True)
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _np(jp))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(B, 16, 2, cfg.head_dim)).astype(np.float32) for _ in range(2)]
    for pos in (np.arange(5), np.array([[7], [9]])):
        xx = x if pos.ndim == 1 else x[:, :1]
        want, jc = JL.attention(jp, jcfg, jnp.asarray(xx), positions=jnp.asarray(pos),
                                causal=False, kv_override=tuple(map(jnp.asarray, kv)))
        sentinel = object()
        got, c = L.attention(p, cfg, torch.from_numpy(xx), positions=torch.from_numpy(pos),
                             causal=False, cache=sentinel,
                             kv_override=tuple(map(torch.from_numpy, kv)))
        assert jc is None and c is sentinel
        _close(got, want)


def test_encoder_and_loss_match_the_reference(models):
    jcfg, cfg, jm, m, jp, p, batch = models
    _close(m.encode(p, torch.from_numpy(batch["frames"])),
           jm.encode(jp, jnp.asarray(batch["frames"])))
    jloss, jmet = jm.loss(jp, _j(batch))
    loss, met = m.loss(p, _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    want, _ = jm.apply(jp, _j(batch))
    got, _ = m.apply(p, _t(batch))
    _close(got, want)


def _pad_self(cache, n):
    return {"self": L.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
                                for t in cache["self"])),
            "cross": cache["cross"]}


def test_prefill_and_decode_match_the_reference(models):
    """Prefill's last logits and both caches; then four decode steps with
    slots at different positions over the reference's padded cache: the
    logits and both caches (self written in place, cross unchanged)."""
    jcfg, cfg, jm, m, jp, p, batch = models
    pre = {k: batch[k] for k in ("frames", "tokens")}
    jl, jc = jm.prefill(jp, _j(pre))
    tl, c = m.prefill(p, _t(pre))
    _close(tl, jl)
    for name in ("self", "cross"):
        _close(c[name].k, jc[name].k)
        _close(c[name].v, jc[name].v)
    jc = {"self": JL.KVCache(*(jnp.pad(a, [(0, 0), (0, 0), (0, 6), (0, 0), (0, 0)])
                               for a in jc["self"])), "cross": jc["cross"]}
    c = from_jax_lm_cache(_np(jc), "cpu")
    held = c["self"].k
    rng = np.random.default_rng(4)
    for step in range(4):
        pos = np.array([S + step, 3 + 2 * step], np.int32)   # slot 1 overwrites
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tl, c = m.decode_step(p, c, {"tokens": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)})
        assert c["self"].k is held
        _close(tl, jl)
        for name in ("self", "cross"):
            _close(c[name].k, jc[name].k)
            _close(c[name].v, jc[name].v)


def test_layout_and_cache_follow_the_reference():
    """``init`` (bf16) and ``abstract_params`` give the reference's tree,
    shapes and dtypes; ``init_cache`` its ``{"self", "cross"}`` shapes."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    ref = jm.abstract_params()
    for tree in (m.init(torch.Generator().manual_seed(0), device="cpu"),
                 m.abstract_params()):
        leaves = tree_leaves(tree)
        flat = jax.tree_util.tree_leaves_with_path(ref)
        assert len(leaves) == len(flat)
        for (path, want), got in zip(flat, leaves):
            assert tuple(got.shape) == want.shape, path
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    jc = jm.init_cache(3, 20, abstract=True)
    c = m.init_cache(3, 20, device="cpu")
    for name in ("self", "cross"):
        for a, b in zip(c[name], jc[name]):
            assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
            assert not a.any()


def test_prefill_then_decode_matches_forward():
    """The reference's prefill-then-decode check on the encoder-decoder:
    teacher-forced decode over a cached prefill equals the forward's
    logits (rtol/atol 2e-3, tests/test_consistency.py's)."""
    _, cfg = _cfgs()
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(6)
    frames = torch.randn((B, cfg.n_frames, cfg.d_model), generator=g)
    toks = torch.randint(0, cfg.vocab_size, (B, 20), generator=g)
    full, _ = m.apply(p, {"frames": frames, "tokens": toks})
    logits, cache = m.prefill(p, {"frames": frames, "tokens": toks[:, :14]})
    np.testing.assert_allclose(logits[:, 0], full[:, 13], rtol=2e-3, atol=2e-3)
    cache = _pad_self(cache, 6)
    for t in range(14, 20):
        logits, cache = m.decode_step(p, cache, {"tokens": toks[:, t : t + 1],
                                                 "pos": torch.full((B,), t)})
        np.testing.assert_allclose(logits[:, 0], full[:, t], rtol=2e-3, atol=2e-3)
