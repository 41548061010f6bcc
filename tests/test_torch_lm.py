"""The port's LM against the reference on the CPU: configs, parameter
counts, full-size parameter layouts and ``input_specs`` of every arch;
layers (RMSNorm, RoPE, attention prefill direct and chunked, and decode);
and ``LM.apply`` / ``prefill`` / ``decode_step`` with weights carried over
from the reference, on reduced configs of the four dense archs (the other
families: ``tests/test_torch_lm_families.py``). The decode step runs the
decode kernel's plain version here (CPU tensors)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import reduced as jreduced
from repro.configs import runnable as jrunnable
from repro.models import layers as JL
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs, reduced, runnable
from repro_torch.models import layers as L
from repro_torch.models.lm import build_model
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_lm_cache, from_jax_lm_params

DENSE = ["llama3-8b", "yi-9b", "codeqwen1.5-7b", "qwen2-0.5b"]
B, S = 2, 48


def _close(got, want, rel=1e-4, abs_=1e-5):
    """fp32 within 1e-4 * max|ref| + 1e-5: the same function summed in
    another order by another library."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max() + abs_
    assert err <= tol, (err, tol)


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages, fp32 unless given."""
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _models(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jcfg, cfg, jm, m, jp, from_jax_lm_params(_np(jp), cfg, "cpu")


# ------------------------------------------------------------------ configs

def test_configs_match_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg))
        for name in ("head_dim", "period", "n_periods", "sub_quadratic"):
            assert getattr(cfg, name) == getattr(jcfg, name), (arch, name)
        assert (cfg.layer_kinds(), cfg.ffn_kinds()) == (jcfg.layer_kinds(),
                                                        jcfg.ffn_kinds())
        for shape in SHAPES:
            assert runnable(cfg, SHAPES[shape]) == jrunnable(jcfg, J_SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count_matches_the_reference(arch):
    """Every architecture at full size, counted on meta tensors."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in DENSE])
def test_build_model_builds_the_other_families(arch):
    """The six architectures beyond the dense family build, and their
    full-config parameter trees (meta tensors) equal the reference's
    ``abstract_params`` leaf for leaf in path, shape and dtype."""
    model = build_model(get_config(arch))
    assert type(model).__name__ == type(jbuild_model(jget_config(arch))).__name__
    got = model.abstract_params()
    want = jax.tree_util.tree_leaves_with_path(
        jbuild_model(jget_config(arch)).abstract_params())
    leaves = tree_leaves(got)
    assert len(leaves) == len(want)
    for (path, w), t in zip(want, leaves):
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (w.shape, str(w.dtype)), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(J_SHAPES))
def test_input_specs_match_the_reference(arch, shape):
    """``input_specs``: the reference's keys, shapes and dtypes, as meta
    tensors."""
    got = input_specs(get_config(arch), SHAPES[shape])
    want = jinput_specs(jget_config(arch), J_SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) == (
            w.shape, str(w.dtype)), k


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("arch", DENSE)
def test_rmsnorm_and_rope_match_the_reference(arch):
    _, cfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 7, 4, cfg.head_dim + 1)).astype(np.float32)  # odd tail
    scale = rng.normal(size=(cfg.head_dim + 1,)).astype(np.float32)
    _close(L.rmsnorm({"scale": _t(scale)}, _t(x)),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    prefill_pos = np.arange(3, 10)
    decode_pos = rng.integers(0, 1000, size=(B, 1))
    for pos, xx in ((prefill_pos, x), (decode_pos, x[:, :1])):
        _close(L.rope(_t(xx), torch.from_numpy(pos), cfg.rope_theta),
               JL.rope(jnp.asarray(xx), jnp.asarray(pos), cfg.rope_theta))


def _attn(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jp = JL.attn_init(jax.random.key(3), jcfg)
    if cfg.qkv_bias:   # the reference starts biases at zero: make them count
        rng = np.random.default_rng(4)
        jp = {k: {n: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.1)
                      if n == "b" else a) for n, a in p.items()} for k, p in jp.items()}
    p = jax.tree_util.tree_map(lambda a: _t(a), _np(jp))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("path", ["direct", "chunked"])
def test_attention_prefill_matches_the_reference(arch, path):
    jcfg, cfg, jp, p = _attn(arch, attn_chunk=16 if path == "chunked" else 4096)
    x = np.random.default_rng(5).normal(size=(B, 64, cfg.d_model)).astype(np.float32)
    pos = np.arange(64)
    want, jc = JL.attention(jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                            prefill=True)
    got, c = L.attention(p, cfg, _t(x), positions=torch.from_numpy(pos), prefill=True)
    _close(got, want)
    _close(c.k, jc.k)
    _close(c.v, jc.v)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_decode_matches_the_reference(arch):
    """One decode step over a cache with a random prefix, slots at
    different positions: the output and the cache row it writes."""
    jcfg, cfg, jp, p = _attn(arch)
    rng = np.random.default_rng(6)
    smax = 40
    shape = (B, smax, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 29], np.int32)
    want, jc = JL.attention(jp, jcfg, jnp.asarray(x),
                            positions=jnp.asarray(pos)[:, None],
                            cache=JL.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
                            cache_pos=jnp.asarray(pos))
    cache = L.KVCache(_t(k0), _t(v0))
    tpos = torch.from_numpy(pos).long()
    got, c = L.attention(p, cfg, _t(x), positions=tpos[:, None], cache=cache,
                         cache_pos=tpos)
    _close(got, want)
    assert c.k is cache.k      # written in place
    _close(c.k, jc.k)
    _close(c.v, jc.v)


def test_chunked_attention_equals_direct():
    """Port of tests/test_consistency.py::test_chunked_attention_equals_direct."""
    _, cfg = _cfgs("llama3-8b", attn_chunk=16)
    p = L.attn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((B, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(64)
    o1, _ = L.attention(p, cfg, x, positions=pos)   # chunked (16*64 > 16^2)
    o2, _ = L.attention(p, dataclasses.replace(cfg, attn_chunk=4096), x, positions=pos)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- the model

def _pad_cache(cache, n):
    return [L.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)) for t in c))
            for c in cache]


@pytest.mark.parametrize("arch", DENSE)
def test_lm_matches_the_reference(arch):
    """apply, prefill and four decode steps (slots at different positions)
    against the reference with carried weights: logits and caches."""
    jcfg, cfg, jm, m, jp, p = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    got, aux = m.apply(p, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(aux) == 0.0

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])})
    tl, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :12])})
    _close(tl, jl)
    for a, b in zip(c, jc):
        _close(a.k, b.k)
        _close(a.v, b.v)

    jc = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * 2 + [(0, 8)] + [(0, 0)] * (a.ndim - 3)), jc)
    c = from_jax_lm_cache([(np.asarray(x.k), np.asarray(x.v)) for x in jc], "cpu")
    for step in range(4):
        pos = np.array([12 + step, 5 + 2 * step], np.int32)   # slot 1 overwrites
        tok = toks[:, 12 + step : 13 + step]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)})
        tl, c = m.decode_step(p, c, {"tokens": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)})
        _close(tl, jl)
        for a, b in zip(c, jc):
            _close(a.k, b.k)
            _close(a.v, b.v)


def _bf16_round(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)
        if a.dtype == jnp.float32 and a.ndim > 1 else a, tree)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_bf16_against_the_fp32_reference(arch):
    """A bf16 model against the fp32 reference with the same bf16-rounded
    weights: full-sequence and decoded logits within 0.05 * max|ref|. The
    tolerance is bf16's: activations rounded to 8 bits of mantissa at every
    layer boundary, about 0.4% each, over 2 layers and the head (the four
    archs land at 1.3-1.8% of max|ref|)."""
    jcfg, cfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    jp = _bf16_round(jm.init(jax.random.key(1)))
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    m = build_model(bcfg)
    p = from_jax_lm_params(_np(jp), bcfg, "cpu")
    assert p["embed"]["w"].dtype == torch.bfloat16
    assert p["final_norm"]["scale"].dtype == torch.float32
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    got, _ = m.apply(p, {"tokens": torch.from_numpy(toks)})
    _close(got, want, rel=0.05, abs_=0)
    _, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :12])})
    assert c[0].k.dtype == torch.bfloat16
    c = _pad_cache(c, 4)
    for t in range(12, 16):
        tl, c = m.decode_step(p, c, {"tokens": torch.from_numpy(toks[:, t : t + 1]),
                                     "pos": torch.full((B,), t)})
        _close(tl[:, 0], np.asarray(want)[:, t], rel=0.05, abs_=0)


def test_prefill_then_decode_matches_forward():
    """Port of tests/test_consistency.py::test_prefill_then_decode_matches_forward:
    teacher-forced decode over a cached prefill equals the full forward."""
    _, cfg = _cfgs("llama3-8b")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    full_logits, _ = m.apply(params, {"tokens": toks})
    n_prefill = S - 8
    logits_p, cache = m.prefill(params, {"tokens": toks[:, :n_prefill]})
    np.testing.assert_allclose(logits_p[:, 0], full_logits[:, n_prefill - 1],
                               rtol=2e-3, atol=2e-3)
    cache = _pad_cache(cache, 8)
    for t in range(n_prefill, S):
        logits_d, cache = m.decode_step(params, cache, {"tokens": toks[:, t : t + 1],
                                                        "pos": torch.full((B,), t)})
        np.testing.assert_allclose(logits_d[:, 0], full_logits[:, t], rtol=2e-3,
                                   atol=2e-3, err_msg=f"position {t}")


def test_init_follows_the_reference_layout_and_scales():
    """LM.init gives the reference's tree, shapes and dtypes, zero biases,
    unit norm scales, and the reference's standard deviations."""
    jcfg, cfg = _cfgs("qwen2-0.5b", dtype="bfloat16")
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.key(0)))
    flat = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    attn = p["layers"][0]["mixer"]["attn"]
    assert not attn["wq"]["b"].any()
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    for w, std in ((p["embed"]["w"], 0.02), (attn["wq"]["w"], d ** -0.5),
                   (attn["wo"]["w"], hd ** -0.5),
                   (p["layers"][0]["ffn"]["w_down"]["w"], cfg.d_ff ** -0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.1
    assert "lm_head" not in p   # tied embeddings


def test_from_jax_lm_params_checks_shapes():
    jcfg, cfg = _cfgs("llama3-8b")
    jp = _np(jbuild_model(jcfg).init(jax.random.key(0)))
    w_up = jp["layers"][0]["ffn"]["w_up"]
    w_up["w"], full = w_up["w"][:, :, :5], w_up["w"]
    with pytest.raises(ValueError, match=r"layers\[0\].ffn.w_up.w has shape"):
        from_jax_lm_params(jp, cfg, "cpu")
    w_up["w"] = full
    del jp["lm_head"]
    with pytest.raises(ValueError, match="missing parameter lm_head"):
        from_jax_lm_params(jp, cfg, "cpu")
