"""The port's mixture-of-experts layer (``moe_init``, ``_router``, ``moe``)
against the reference's single-device path on the CPU: outputs, balance
loss and gradients with carried weights (fp32 within 1e-5 of the
reference's largest output), routing ties, and the reference's own tests of
``tests/test_moe.py`` (capacity drops, zero experts, router dtypes, the
shared expert) rewritten against the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

REL = 1e-5   # fp32: max |port - ref| <= REL * max|ref| (+ ABS)
ABS = 1e-6


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages, fp32 unless given."""
    kw.setdefault("dtype", "float32")
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    return jcfg, cfg


def _to_torch(tree):
    """A reference tree of arrays as the port's tree of tensors (bf16 by
    its bits), dtypes kept."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(one, tree)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=REL, abs_=ABS):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (err, tol)


def _setup(arch, seed=0, shape=(2, 32), **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jp = JL.moe_init(jax.random.key(seed), jcfg)
    x = (np.random.default_rng(seed + 1).normal(size=shape + (cfg.d_model,)) * 0.5
         ).astype(np.float32)
    return jcfg, cfg, jp, _to_torch(jp), x


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_matches_the_reference(arch):
    """Output and aux, fp32, within 1e-5 of the reference's largest
    output. Reduced Kimi routes with capacity factor 1.0 (tokens dropped)
    and adds its shared expert."""
    jcfg, cfg, jp, p, x = _setup(arch)
    want, jaux = JL.moe(jp, jcfg, jnp.asarray(x))
    got, aux = L.moe(p, cfg, torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert ("shared" in p) == (arch == "kimi-k2-1t-a32b")


@pytest.mark.parametrize("tokens", [1, 8, 64])
def test_moe_matches_the_reference_at_decode_and_prefill_sizes(tokens):
    """T = 1 (C = 1), 8 (a decode step of 8 slots) and 64 tokens, fp32,
    1e-5."""
    jcfg, cfg, jp, p, x = _setup("dbrx-132b", seed=3, shape=(tokens, 1))
    want, jaux = JL.moe(jp, jcfg, jnp.asarray(x))
    got, aux = L.moe(p, cfg, torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_grads_match_jax_vjp():
    """Gradients of ``sum(out * g) + aux`` in every parameter and in x
    against ``jax.grad``, fp32, each leaf within 1e-5 of its largest."""
    jcfg, cfg, jp, p, x = _setup("kimi-k2-1t-a32b", seed=5)
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = JL.moe(params, jcfg, xx)
        return jnp.sum(out * g) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = tree_map(lambda t: t.clone().requires_grad_(True), p)
    xx = torch.from_numpy(x).requires_grad_(True)
    out, aux = L.moe(live, cfg, xx)
    (out * torch.from_numpy(g)).sum().add(aux).backward()
    _close(xx.grad, jgx)
    for got, want in zip(tree_leaves(live), jax.tree_util.tree_leaves(jgp)):
        _close(got.grad, want)


def _tie_router(cfg, row):
    """Router weights whose first input feature carries ``row`` (one logit
    per expert) and whose other features carry nothing, and inputs that
    are ``t * e_0`` with ``t`` from 1 to 2: every token sees logits ``t *
    row``."""
    d, E = cfg.d_model, cfg.moe.n_experts
    w = np.zeros((d, E), np.float32)
    w[0] = row
    x2d = np.zeros((8, d), np.float32)
    x2d[:, 0] = np.linspace(1.0, 2.0, 8)
    return w, x2d


@pytest.mark.parametrize("row,dtype,want_e", [
    ([0.0, 1.0, 1.0, 2.0], "float32", [3, 1]),          # tie for the second pick
    ([1.0, 2.0, 2.0, 0.0], "float32", [1, 2]),          # tie for the first
    ([0.0, 1.0, 1.0 + 2 ** -10, 2.0], "bfloat16", [3, 1]),   # a tie only in bf16
])
def test_router_breaks_ties_toward_the_lower_expert(row, dtype, want_e):
    """Equal probabilities go to the lower expert first, as ``lax.top_k``
    takes them (``torch.topk`` promises no order); the bf16 case rounds
    two distinct fp32 weights to one bf16 logit, a tie the model dtype
    makes. Then a whole ``moe`` over the tied router against the
    reference."""
    jcfg, cfg = _cfgs("dbrx-132b", dtype=dtype)
    w, x2d = _tie_router(cfg, row)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {"router": {"w": jnp.asarray(w)}}
    jtop_p, jtop_e, jprobs = JL._router(jp, jcfg, jnp.asarray(x2d).astype(jdt))
    top_p, top_e, probs = L._router({"router": {"w": torch.from_numpy(w)}}, cfg,
                                    torch.from_numpy(x2d).to(tdt))
    assert np.asarray(jtop_e).tolist() == [want_e] * 8
    assert top_e.tolist() == [want_e] * 8
    _close(top_p, jtop_p)
    _close(probs, jprobs)

    full = JL.moe_init(jax.random.key(7), jcfg)
    full["router"]["w"] = jnp.asarray(w)
    x = x2d.reshape(1, 8, cfg.d_model)
    want, jaux = JL.moe(full, jcfg, jnp.asarray(x).astype(jdt))
    got, aux = L.moe(_to_torch(full), cfg, torch.from_numpy(x).to(tdt))
    _close(got, want, rel=REL if dtype == "float32" else 1e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_bf16_moe_matches_the_reference_on_clear_routes():
    """A bf16 layer against the bf16 reference with the same weights, held
    only on tokens whose reference top-k margin (the k-th probability less
    the next) exceeds 1e-2: the router's logits are bf16 in both, and two
    correct bf16 matmuls summed in other orders can flip a near-tie, which
    sends the token to another expert. A flipped near-tie is not a fault.
    Held tokens within 2e-2 of the largest output (bf16 activations, about
    three roundings on the way)."""
    jcfg, cfg, jp, p, x = _setup("dbrx-132b", seed=9, dtype="bfloat16",
                                 shape=(2, 32))
    # capacity for every token, so a flip elsewhere cannot drop a held one
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                  / cfg.moe.top_k)
    jcfg = dataclasses.replace(jcfg, moe=moe_cfg)
    cfg = dataclasses.replace(cfg, moe=moe_cfg)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = JL.moe(jp, jcfg, xb)
    got, _ = L.moe(p, cfg, _to_torch(xb))
    _, _, jprobs = JL._router(jp, jcfg, xb.reshape(-1, cfg.d_model))
    srt = -np.sort(-np.asarray(jprobs), axis=-1)
    k = cfg.moe.top_k
    held = (srt[:, k - 1] - srt[:, k]) > 1e-2
    assert held.sum() >= 32, held.sum()
    g, w = _np32(got).reshape(-1, cfg.d_model), _np32(want).reshape(-1, cfg.d_model)
    err = np.abs(g[held] - w[held]).max()
    assert err <= 2e-2 * np.abs(w[held]).max(), err


# ---------------------------------------- the reference's tests/test_moe.py

def test_capacity_drops_tokens():
    """Port of test_capacity_drops_tokens: with capacity_factor -> 0 each
    expert keeps one token, so at least 16 - E of 16 rows are zero."""
    cfg = reduced(get_config("dbrx-132b"))
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=1e-9))
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = L.moe(p, cfg, x)
    assert int((out == 0).all(-1).sum()) >= 16 - cfg.moe.n_experts


def test_router_weights_stay_model_dtype():
    """Port of test_router_weights_stay_model_dtype: fp32 router weights,
    fp32 probabilities from a bf16 input, renormalised top-k."""
    cfg = reduced(get_config("kimi-k2-1t-a32b"))
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["router"]["w"].dtype == torch.float32
    assert p["experts"]["w_gate"].dtype == torch.bfloat16
    x = torch.ones((8, cfg.d_model), dtype=torch.bfloat16)
    top_p, top_e, probs = L._router(p, cfg, x)
    assert probs.dtype == torch.float32
    assert top_e.shape == (8, cfg.moe.top_k)
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_shared_expert_applied():
    """Port of test_shared_expert_applied, and the shared expert's width:
    ``mlp_init(d_ff=)`` at expert d_ff times the shared count."""
    cfg = reduced(get_config("kimi-k2-1t-a32b"))
    assert cfg.moe.n_shared_experts == 1
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["shared"]["w_up"]["w"].shape == (cfg.d_model, cfg.moe.d_ff)
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = L.moe(p, cfg, x.to(torch.bfloat16))
    assert out.shape == x.shape and out.dtype == torch.bfloat16


def test_dispatch_combine_zero_experts():
    """Port of test_dispatch_combine_identity_experts: every weight zero
    gives an output of exactly 0 and finite gradients."""
    _, cfg = _cfgs("dbrx-132b")
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    p = tree_map(lambda t: torch.zeros_like(t).requires_grad_(True), p)
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    out, aux = L.moe(p, cfg, x)
    assert float(out.detach().abs().max()) == 0.0
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(p))
