"""The port's Mamba mixer (``models/ssm.py``) against the reference's on
the CPU with carried weights: the training forward over several chunks,
prefill with its cache and decode steps (output and cache, written in
place), gradients against ``jax.grad``, all fp32 within 1e-5 of the
reference's largest value; then the reference's chunked-equals-stepwise
test (``tests/test_consistency.py``) rewritten against the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import ssm
from repro_torch.tree import tree_leaves, tree_map

ARCH = "jamba-1.5-large-398b"
REL, ABS = 1e-5, 1e-6   # fp32: max |port - ref| <= REL * max|ref| + ABS
B = 2


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(jget_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL, abs_=ABS):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (err, tol)


def _setup(S, seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = jssm.mamba_init(jax.random.key(seed), jcfg)
    x = (np.random.default_rng(seed + 1).normal(size=(B, S, cfg.d_model)) * 0.5
         ).astype(np.float32)
    return jcfg, cfg, jp, _t(jp), x


@pytest.mark.parametrize("S", [24, 64])
def test_mamba_train_and_prefill_match_the_reference(S):
    """S 24 (one chunk of 24) and 64 (two chunks of 32): the output, and
    the prefill's conv and ssm states."""
    jcfg, cfg, jp, p, x = _setup(S)
    want, none = jssm.mamba(jp, jcfg, jnp.asarray(x))
    got, c = ssm.mamba(p, cfg, torch.from_numpy(x))
    assert none is None and c is None
    _close(got, want)
    want, jc = jssm.mamba(jp, jcfg, jnp.asarray(x), want_cache=True)
    got, c = ssm.mamba(p, cfg, torch.from_numpy(x), want_cache=True)
    _close(got, want)
    assert set(c) == set(jc) == {"conv", "ssm"}
    for k in c:
        _close(c[k], jc[k])


def test_mamba_decode_matches_the_reference_in_place():
    """Three decode steps from a random state: outputs and both states,
    written into the given cache's tensors."""
    jcfg, cfg, jp, p, _ = _setup(8, seed=2)
    rng = np.random.default_rng(3)
    jc = {k: jnp.asarray(rng.normal(size=np.shape(v)).astype(np.float32))
          for k, v in jssm.init_mamba_cache(jcfg, B).items()}
    c = _t(jc)
    held = dict(c)
    for step in range(3):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, jc = jssm.mamba(jp, jcfg, jnp.asarray(x), cache=jc)
        got, c2 = ssm.mamba(p, cfg, torch.from_numpy(x), cache=c)
        assert c2 is c and all(c[k] is held[k] for k in c)
        _close(got, want)
        for k in c:
            _close(c[k], jc[k])


def test_mamba_grads_match_jax():
    """Gradients of ``sum(out * g)`` in every parameter and in x over two
    chunks, against ``jax.grad``, fp32, each leaf within 1e-5 of its
    largest (the port checkpoints each chunk, as the reference does)."""
    jcfg, cfg, jp, p, x = _setup(64, seed=4)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda pp, xx: jnp.sum(jssm.mamba(pp, jcfg, xx)[0] * g),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    live = tree_map(lambda t: t.clone().requires_grad_(True), p)
    xx = torch.from_numpy(x).requires_grad_(True)
    (ssm.mamba(live, cfg, xx)[0] * torch.from_numpy(g)).sum().backward()
    _close(xx.grad, jgx)
    for got, want in zip(tree_leaves(live), jax.tree_util.tree_leaves(jgp)):
        _close(got.grad, want)


def test_doubling_scan_is_the_sequential_recurrence():
    """``h_t = a_t * h_{t-1} + b_t`` from 0 and the running product of
    ``a``, at lengths that are and are not powers of two, against a loop
    (fp32, 1e-6 relative: the doubling scan multiplies in another order)."""
    rng = np.random.default_rng(6)
    for L in (1, 5, 16, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, L, 3, 4)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, L, 3, 4)).astype(np.float32))
        pa, h = ssm._doubling_scan(a, b)
        ref_h, ref_p = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(L):
            ref_h = a[:, t] * ref_h + b[:, t]
            ref_p = ref_p * a[:, t]
            np.testing.assert_allclose(h[:, t].numpy(), ref_h.numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(pa[:, t].numpy(), ref_p.numpy(), rtol=1e-6)


def test_chunk_must_divide_the_sequence():
    _, cfg, _, p, x = _setup(40)
    with pytest.raises(ValueError, match="does not divide"):
        ssm.mamba(p, cfg, torch.from_numpy(x))


def test_init_follows_the_reference_layout():
    """Shapes and dtypes of ``mamba_init`` and ``init_mamba_cache`` in a
    bf16 model (dt_bias, a_log, d and the ssm state stay fp32), and the
    reference's fixed leaves."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    ref = jssm.mamba_init(jax.random.key(0), jcfg)
    p = ssm.mamba_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 tree_leaves(p)):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    _close(p["mamba"]["a_log"], ref["mamba"]["a_log"])
    dt = torch.nn.functional.softplus(p["mamba"]["dt_bias"])
    assert 1e-3 <= float(dt.min()) and float(dt.max()) < 1e-1
    jc, c = jssm.init_mamba_cache(jcfg, 3), ssm.init_mamba_cache(cfg, 3, device="cpu")
    for k in jc:
        assert tuple(c[k].shape) == jc[k].shape
        assert str(c[k].dtype).split(".")[-1] == str(jc[k].dtype)
        assert not c[k].any()


def test_mamba_chunked_equals_stepwise():
    """Port of tests/test_consistency.py::test_mamba_chunked_equals_stepwise
    (its tolerance, rtol 1e-4 / atol 1e-5)."""
    _, cfg = _cfgs()
    p = ssm.mamba_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn((B, 64, cfg.d_model), generator=torch.Generator().manual_seed(2)) * 0.5
    y_full, cache_full = ssm.mamba(p, cfg, x, want_cache=True)
    c = ssm.init_mamba_cache(cfg, B, device="cpu")
    ys = []
    for t in range(64):
        y, c = ssm.mamba(p, cfg, x[:, t : t + 1], cache=c)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cache_full["ssm"].numpy(), c["ssm"].numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prefill_then_decode_matches_the_reference_forward(S):
    """A prefill shorter than ``d_conv - 1`` tokens, then one decode step, on
    reduced Jamba (carried weights): the conv state is left-padded with the
    zeros the causal conv saw, so the decode logits are the reference's
    full forward of the same S + 1 tokens at the last position (2e-3, the
    prefill-then-decode tolerance; the experts at capacity ``n_experts /
    top_k``, since the forward routes B*(S+1) tokens and the step B). The
    reference's own decode step raises after such a prefill."""
    from repro.models.lm import build_model as jbuild_model
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_model
    from repro_torch.weights import from_jax_lm_params

    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=c.moe.n_experts / c.moe.top_k)) for c in _cfgs())
    assert S < cfg.mamba.d_conv - 1
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(0))
    p = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    _, cache = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])})
    cache = [c if isinstance(c, dict) else L.KVCache(
        *(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1)) for t in c)) for c in cache]
    got, _ = m.decode_step(p, cache, {"tokens": torch.from_numpy(toks[:, S:]),
                                      "pos": torch.full((B,), S)})
    np.testing.assert_allclose(_np32(got[:, 0]), np.asarray(want[:, S], np.float32),
                               rtol=2e-3, atol=2e-3)
