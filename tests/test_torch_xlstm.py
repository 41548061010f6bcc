"""The port's xLSTM blocks (``models/xlstm.py``) against the reference's on
the CPU with carried weights: mLSTM over several chunks, prefill states
and decode steps; sLSTM over a sequence, prefill states and decode steps
(outputs, and states written in place); gradients against ``jax.grad``;
all fp32 within 1e-5 of the reference's largest value. Then the
reference's chunked/scan-equals-stepwise tests
(``tests/test_consistency.py``) rewritten against the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import xlstm as jx
from repro_torch.configs import get_config, reduced
from repro_torch.models import xlstm
from repro_torch.tree import tree_leaves, tree_map

ARCH = "xlstm-125m"
REL, ABS = 1e-5, 1e-6   # fp32: max |port - ref| <= REL * max|ref| + ABS
B = 2
KINDS = {"mlstm": (jx.mlstm_init, jx.mlstm, xlstm.mlstm_init, xlstm.mlstm),
         "slstm": (jx.slstm_init, jx.slstm, xlstm.slstm_init, xlstm.slstm)}


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


def _setup(kind, S, seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jinit, jfn, init, fn = KINDS[kind]
    jp = jinit(jax.random.key(seed), jcfg)
    x = (np.random.default_rng(seed + 1).normal(size=(B, S, cfg.d_model)) * 0.5
         ).astype(np.float32)
    return jcfg, cfg, jp, _t(jp), x, jfn, fn


@pytest.mark.parametrize("kind,S,attn_chunk", [
    ("mlstm", 48, 64),    # one chunk of 48
    ("mlstm", 64, 16),    # four chunks of 16
    ("slstm", 24, 64),
])
def test_block_and_prefill_match_the_reference(kind, S, attn_chunk):
    """The training forward's output, then the prefill's output and final
    state."""
    jcfg, cfg, jp, p, x, jfn, fn = _setup(kind, S, attn_chunk=attn_chunk)
    want, _ = jfn(jp, jcfg, jnp.asarray(x))
    got, none = fn(p, cfg, torch.from_numpy(x))
    assert none is None
    _close(got, want)
    want, jst = jfn(jp, jcfg, jnp.asarray(x), want_cache=True)
    got, st = fn(p, cfg, torch.from_numpy(x), want_cache=True)
    _close(got, want)
    assert set(st) == set(jst)
    for k in st:
        _close(st[k], jst[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_the_reference_in_place(kind):
    """Three decode steps from the state a 16-token prefill leaves: the
    outputs and every state tensor, written into the given cache's
    tensors."""
    jcfg, cfg, jp, p, x, jfn, fn = _setup(kind, 16, seed=2)
    _, jc = jfn(jp, jcfg, jnp.asarray(x), want_cache=True)
    c = _t(jc)
    held = dict(c)
    rng = np.random.default_rng(3)
    for _ in range(3):
        xs = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, jc = jfn(jp, jcfg, jnp.asarray(xs), cache=jc)
        got, c2 = fn(p, cfg, torch.from_numpy(xs), cache=c)
        assert c2 is c and all(c[k] is held[k] for k in c)
        _close(got, want)
        for k in c:
            _close(c[k], jc[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_grads_match_jax(kind):
    """Gradients of ``sum(out * g)`` in every parameter and in x against
    ``jax.grad`` (mLSTM over two chunks), fp32, each leaf within 1e-5 of
    its largest."""
    jcfg, cfg, jp, p, x, jfn, fn = _setup(kind, 32, seed=4, attn_chunk=16)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda pp, xx: jnp.sum(jfn(pp, jcfg, xx)[0] * g),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    live = tree_map(lambda t: t.clone().requires_grad_(True), p)
    xx = torch.from_numpy(x).requires_grad_(True)
    (fn(live, cfg, xx)[0] * torch.from_numpy(g)).sum().backward()
    _close(xx.grad, jgx)
    for got, want in zip(tree_leaves(live), jax.tree_util.tree_leaves(jgp)):
        _close(got.grad, want)


def test_mlstm_chunk_must_divide_the_sequence():
    _, cfg, _, p, x, _, fn = _setup("mlstm", 40, attn_chunk=16)
    with pytest.raises(ValueError, match="does not divide"):
        fn(p, cfg, torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_follows_the_reference_layout(kind):
    """Shapes and dtypes of the block's parameters in a bf16 model (w_if
    and w_rec stay fp32) and of its fp32 state."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jinit, _, init, _ = KINDS[kind]
    ref = jinit(jax.random.key(0), jcfg)
    p = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 tree_leaves(p)):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    jc = jx.init_xlstm_cache(jcfg, kind, 3)
    c = xlstm.init_xlstm_cache(cfg, kind, 3, device="cpu")
    assert set(c) == set(jc)
    for k in jc:
        assert tuple(c[k].shape) == jc[k].shape and c[k].dtype == torch.float32
        assert not c[k].any()


@pytest.mark.parametrize("kind,S,rtol,atol", [("mlstm", 64, 1e-3, 1e-4),
                                             ("slstm", 32, 1e-4, 1e-5)])
def test_chunked_or_scan_equals_stepwise(kind, S, rtol, atol):
    """Port of tests/test_consistency.py::test_mlstm_chunked_equals_stepwise
    and ::test_slstm_scan_equals_stepwise, with their tolerances."""
    _, cfg = _cfgs()
    _, _, init, fn = KINDS[kind]
    p = init(torch.Generator().manual_seed(3), cfg, device="cpu")
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(4)) * 0.5
    y_full, _ = fn(p, cfg, x, want_cache=True)
    c = xlstm.init_xlstm_cache(cfg, kind, B, device="cpu")
    ys = []
    for t in range(S):
        y, c = fn(p, cfg, x[:, t : t + 1], cache=c)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=rtol,
                               atol=atol)
