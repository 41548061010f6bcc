"""Every architecture of the registry, reduced, through the port against
the reference on the CPU with carried weights (fp32 within 1e-5 of the
reference's largest value): ``loss`` (ce and aux), prefill's last logits
and cache, and decode steps' logits and caches; the VLM's patch
embeddings; and prefill then decode against the forward for the MoE,
hybrid and xLSTM families. Training of the new families is in
``tests/test_torch_lm_families_train.py``, their serving in
``tests/test_torch_serve_engine.py``.

Prefill-vs-decode checks of an MoE model raise the capacity factor to
``n_experts / top_k`` (``C >= T``): prefill routes ``B*S`` tokens and
decode ``B``, so with Switch dropping a teacher-forced decode would not
equal the forward whenever a token is dropped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models.lm import build_model
from repro_torch.weights import from_jax_lm_cache, from_jax_lm_params

REL, ABS = 1e-5, 1e-6   # fp32: max |port - ref| <= REL * max|ref| + ABS
B, S = 2, 24


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages, fp32 unless given."""
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _no_drops(cfg):
    """``cfg`` with capacity for every token (``C >= T``)."""
    if not cfg.moe.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


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


def _models(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jcfg, cfg, jm, m, jp, from_jax_lm_params(_np(jp), cfg, "cpu")


def _batch(cfg, seed, s=S):
    """Seeded numpy inputs of the config's kind: tokens and targets, plus
    patch embeddings (VLM; targets cover them) or frames (audio)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    n_tgt = s + cfg.n_patches
    b["targets"] = rng.integers(0, cfg.vocab_size, (B, n_tgt)).astype(np.int32)
    b["targets"][0, :2] = -1
    if cfg.n_patches:
        b["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.encoder_layers:
        b["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return b


def _entries(cache):
    """A cache's entries in order: ``(name, tensor)`` pairs."""
    if isinstance(cache, dict):
        return [(f"{n}.{f}", getattr(cache[n], f)) for n in ("self", "cross")
                for f in ("k", "v")]
    out = []
    for i, c in enumerate(cache):
        if isinstance(c, dict):
            out += [(f"[{i}].{k}", c[k]) for k in sorted(c)]
        else:
            out += [(f"[{i}].k", c[0]), (f"[{i}].v", c[1])]
    return out


def _caches_close(got, want):
    g, w = _entries(got), _entries(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        _close(a, b)


def _pad_ref(cache, n):
    """The reference's prefill cache with ``n`` more KV rows (recurrent
    states as they are)."""
    def pad(kv):
        return type(kv)(*(jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)])
                          for a in kv))
    if isinstance(cache, dict):
        return {"self": pad(cache["self"]), "cross": cache["cross"]}
    return [c if isinstance(c, dict) else pad(c) for c in cache]


def _pad_port(cache, n):
    def pad(kv):
        return L.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)) for t in kv))
    if isinstance(cache, dict):
        return {"self": pad(cache["self"]), "cross": cache["cross"]}
    return [c if isinstance(c, dict) else pad(c) for c in cache]


def test_registry_is_the_reference_s():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_matches_the_reference(arch):
    """``loss`` (ce and aux), prefill's last logits and cache, then two
    decode steps (slots at different positions) over the reference's
    padded prefill cache: the logits and every cache entry."""
    jcfg, cfg, jm, m, jp, p = _models(arch)
    b = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jloss, jmet = jm.loss(jp, jb)
    loss, met = m.loss(p, tb)
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]), (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    assert (float(met["aux"]) > 0) == bool(cfg.moe.n_experts)

    pre = {k: v for k, v in b.items() if k != "targets"}
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in pre.items()})
    tl, c = m.prefill(p, {k: torch.from_numpy(v) for k, v in pre.items()})
    _close(tl, jl)
    _caches_close(c, _np(jc))

    n_pre = S + cfg.n_patches
    jc = _pad_ref(jc, 4)
    c = from_jax_lm_cache(_np(jc), "cpu")
    rng = np.random.default_rng(2)
    for step in range(2):
        pos = np.array([n_pre + step, 5 + step], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)})
        tl, c2 = m.decode_step(p, c, {"tokens": torch.from_numpy(tok),
                                      "pos": torch.from_numpy(pos)})
        assert c2 is c
        _close(tl, jl)
        _caches_close(c, _np(jc))


def test_vlm_prepends_the_patch_embeddings():
    """LLaVA: the logits of ``apply`` over patches + text against the
    reference's, and the patches change the text positions' logits."""
    jcfg, cfg, jm, m, jp, p = _models("llava-next-mistral-7b")
    b = _batch(cfg, 3)
    want, _ = jm.apply(jp, {k: jnp.asarray(b[k]) for k in ("tokens", "patch_embeds")})
    got, _ = m.apply(p, {k: torch.from_numpy(b[k]) for k in ("tokens", "patch_embeds")})
    assert got.shape == (B, S + cfg.n_patches, cfg.vocab_size)
    _close(got, want)
    text_only, _ = m.apply(p, {"tokens": torch.from_numpy(b["tokens"])})
    assert not torch.allclose(text_only, got[:, cfg.n_patches:])


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "xlstm-125m"])
def test_prefill_then_decode_matches_forward(arch):
    """tests/test_consistency.py's prefill-then-decode check on the other
    families (rtol/atol 2e-3), MoE at capacity ``n_experts / top_k``; the
    hybrid at a Mamba chunk of 8, so the 40-token prefill and the 48-token
    forward both divide into chunks."""
    _, cfg = _cfgs(arch)
    cfg = _no_drops(cfg)
    if cfg.attn_every:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, chunk=8))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 48), generator=torch.Generator().manual_seed(1))
    full, _ = m.apply(p, {"tokens": toks})
    logits, cache = m.prefill(p, {"tokens": toks[:, :40]})
    np.testing.assert_allclose(logits[:, 0], full[:, 39], rtol=2e-3, atol=2e-3)
    cache = _pad_port(cache, 8)
    for t in range(40, 48):
        logits, cache = m.decode_step(p, cache, {"tokens": toks[:, t : t + 1],
                                                 "pos": torch.full((B,), t)})
        np.testing.assert_allclose(logits[:, 0], full[:, t], rtol=2e-3, atol=2e-3,
                                   err_msg=f"position {t}")
