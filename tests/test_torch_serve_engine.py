"""The port's continuous-batching LM engine: ports of the three tests of
``tests/test_serve_engine.py`` (slot recycling, mixed lengths, greedy
against a sequential decode, EOS), the reference engine's tokens from the
port's engine on a reduced fp32 Llama-3 with carried weights, and the
recurrent families (reduced Jamba and xLSTM), whose admitted slots start
from a zeroed state."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.lm import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.models import layers as L
from repro_torch.models.lm import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import from_jax_lm_params


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), dtype="float32",
                              remat=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def test_serves_batch_to_completion(small_model):
    cfg, model, params = small_model
    reqs = [
        Request(prompt=[1, 2, 3], max_new_tokens=4),
        Request(prompt=[4, 5], max_new_tokens=6),
        Request(prompt=[7, 8, 9, 10, 11], max_new_tokens=3),
    ]
    eng = ServeEngine(model, params, slots=2, max_len=32, device="cpu")  # fewer slots than reqs
    out = eng.run(reqs)
    assert all(r.done for r in out)
    assert [len(r.output) for r in out] == [4, 6, 3]
    for r in out:
        assert all(0 <= t < cfg.vocab_size for t in r.output)


def test_greedy_matches_sequential_decode(small_model):
    """Engine output (continuous batching, mixed slots) must equal a plain
    sequential greedy decode of the same prompt."""
    cfg, model, params = small_model
    prompt = [3, 1, 4, 1, 5]
    n_new = 5

    # reference: prefill + decode loop
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])})
    cache = [L.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n_new)) for t in c))
             for c in cache]
    ref = [int(torch.argmax(logits[0, -1]))]
    for t in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.tensor([[ref[-1]]]), "pos": torch.tensor([t])})
        ref.append(int(torch.argmax(logits[0, -1])))

    # engine, alongside an unrelated second request in the other slot
    reqs = [
        Request(prompt=prompt, max_new_tokens=n_new),
        Request(prompt=[9, 9], max_new_tokens=7),
    ]
    eng = ServeEngine(model, params, slots=2, max_len=32, device="cpu")
    eng.run(reqs)
    assert reqs[0].output == ref


def test_eos_stops_early(small_model):
    cfg, model, params = small_model
    # find whatever greedy emits first, then use it as "EOS"
    probe = Request(prompt=[1, 2], max_new_tokens=1)
    eng = ServeEngine(model, params, slots=1, max_len=16, device="cpu")
    eng.run([probe])
    eos = probe.output[0]
    r = Request(prompt=[1, 2], max_new_tokens=8, eos_id=eos)
    eng2 = ServeEngine(model, params, slots=1, max_len=16, device="cpu")
    eng2.run([r])
    assert r.done and r.output[-1] == eos and len(r.output) == 1


def _requests(cls, rng, vocab):
    return [cls(prompt=rng.integers(0, vocab, size=int(n)).tolist(),
                max_new_tokens=int(m))
            for n, m in zip(rng.integers(1, 12, size=7), rng.integers(1, 9, size=7))]


def test_engine_emits_the_reference_engines_tokens():
    """Seven requests of mixed lengths through three slots (slots recycled,
    idle slots stepping at stale positions): the port's engine, with weights
    carried from the reference, emits the reference engine's greedy tokens,
    in the same number of steps. Every step's attention runs through the
    decode kernel's wrapper (its plain version here), and a custom sampler
    sees the same logits rows."""
    jcfg = dataclasses.replace(jreduced(jget_config("llama3-8b")), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), dtype="float32")
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(2))
    params = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")

    jreqs = _requests(JRequest, np.random.default_rng(3), cfg.vocab_size)
    jeng = JServeEngine(jmodel, jparams, slots=3, max_len=24)
    jeng.run(jreqs)

    calls = []
    orig = da.decode_attention_ref

    def spy(*args):
        calls.append(args[1].shape)
        return orig(*args)

    reqs = _requests(Request, np.random.default_rng(3), cfg.vocab_size)
    eng = ServeEngine(model, params, slots=3, max_len=24, device="cpu")
    da.decode_attention_ref = spy
    try:
        eng.run(reqs)
    finally:
        da.decode_attention_ref = orig
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(r.done for r in reqs) and eng.steps == jeng.steps
    assert len(calls) == cfg.n_layers * eng.steps
    assert set(calls) == {(3, 24, cfg.n_kv_heads, cfg.head_dim)}

    rows = []
    reqs = _requests(Request, np.random.default_rng(3), cfg.vocab_size)
    sampled = ServeEngine(model, params, slots=3, max_len=24, device="cpu",
                          sampler=lambda row, rid: rows.append(row) or int(np.argmax(row)))
    sampled.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert len(rows) == sum(len(r.output) for r in reqs)
    assert all(r.dtype == np.float32 and r.shape == (cfg.vocab_size,) for r in rows)


def test_engine_refuses_params_elsewhere_and_long_requests(small_model):
    cfg, model, params = small_model
    eng = ServeEngine(model, params, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.run([Request(prompt=[1] * 6, max_new_tokens=3)])
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(model, params, device="meta")


# ------------------------------------------- recurrent families (slot reset)

def _family_cfg(arch, **mamba):
    """Reduced fp32 ``arch`` with capacity for every token (MoE) and the
    given Mamba fields."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    if mamba:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, **mamba))
    return cfg


def _pad_kv(cache, n):
    return [c if isinstance(c, dict) else
            L.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)) for t in c))
            for c in cache]


def _sequential(m, p, prompt, n_new):
    """Greedy tokens of one request alone: prefill, then decode steps."""
    logits, cache = m.prefill(p, {"tokens": torch.tensor([prompt])})
    cache = _pad_kv(cache, n_new)
    out = [int(logits[0, -1].argmax())]
    for t in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = m.decode_step(p, cache, {"tokens": torch.tensor([[out[-1]]]),
                                                 "pos": torch.tensor([t])})
        out.append(int(logits[0, -1].argmax()))
    return out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_engine_serves_sequential_tokens_in_recycled_slots(arch):
    """Five requests through two slots (so three are admitted into slots
    that served before, and idle slots run token 0 meanwhile): each
    request's greedy tokens equal its sequential decode, which needs the
    admitted slot's recurrent state zeroed. Jamba runs at capacity
    ``n_experts / top_k`` (co-batched requests would otherwise change each
    other's routes through drops) and a Mamba chunk of 1, so a prompt of
    any length prefills (at least ``d_conv - 1`` tokens, which the conv
    state holds)."""
    cfg = _family_cfg(arch, **({"chunk": 1} if arch.startswith("jamba") else {}))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=int(k))
            for n, k in ((5, 4), (3, 7), (6, 2), (4, 5), (7, 3))]
    eng = ServeEngine(m, p, slots=2, max_len=32, device="cpu")
    eng.run(reqs)
    assert all(r.done for r in reqs)
    for r in reqs:
        assert r.output == _sequential(m, p, r.prompt, r.max_new_tokens), r.rid

    # the reference's engine does not reset: there a recycled slot starts
    # from its last request's state, and the served tokens differ
    stale = [dataclasses.replace(r, rid=-1, output=[], done=False) for r in reqs]
    eng = ServeEngine(m, p, slots=2, max_len=32, device="cpu")
    eng._reset_state = lambda slot: None
    eng.run(stale)
    assert [r.output for r in stale] != [r.output for r in reqs]
