"""Port of LM training (``SyntheticTokens``, ``cosine_schedule``,
``LM.loss``, ``train/train_step.py``, ``train/trainer.py``,
``launch/train.py``) and of the port's examples, against the JAX package
on the CPU.

The same numpy inputs go through both packages: the reference's initial
weights (``from_jax_lm_params``) and its token batches, since the port's
random draws cannot match JAX's. fp32 models are held to 1e-5; a bf16
model is held to the fp32 reference with a tolerance scaled to magnitude.
Then the reference's own tests of this path, rewritten against the port:
``test_train_step_decreases_loss``, ``test_train_serve_round_trip`` and
``test_trainer_resume``; the trainer's contract (NaN guard, SIGTERM); and
the entry points at tiny sizes.
"""
import dataclasses
import importlib.util
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models.lm import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim.schedule import cosine_schedule as jcosine
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens
from repro_torch.models.layers import KVCache
from repro_torch.models.lm import build_model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train import Trainer, latest_step
from repro_torch.train.train_step import (
    TrainConfig,
    abstract_train_state,
    init_train_state,
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax_lm_params

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages."""
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, seed=0, **kw):
    """Both models and both parameter trees, the port's carried over."""
    jcfg, cfg = _cfgs(arch, **kw)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, m, jp, from_jax_lm_params(_np(jp), cfg, "cpu")


def _batch(vocab, seq, batch, step, *, mask=False):
    """The reference's token batch of ``step`` as numpy (int64), its first
    targets set to -1 when ``mask``."""
    b = {k: np.array(v, np.int64) for k, v in
         JSyntheticTokens(vocab, seq, batch).batch(step).items()}
    if mask:
        b["targets"][0, : seq // 3] = -1
        b["targets"][-1, -1] = -1
    return b


def _j(b):
    return {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _f32(x):
    """A JAX or port leaf as an fp32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves_close(got, want, rel, abs_=0.0):
    """Per leaf: max |got - want| <= rel * max|want| + abs_."""
    lg, lw = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape
        err, tol = np.abs(g - w).max(), rel * np.abs(w).max() + abs_
        assert err <= tol, (err, tol, g.shape)


def _grads(m, params, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = m.loss(live, batch)
    flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss, metrics, tree_map(lambda _: next(flat), live)


def _bits_equal(a, b):
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(ints[x.element_size()]), y.view(ints[y.element_size()]))
        for x, y in zip(la, lb))


# ------------------------------------------------------------------- data

def test_synthetic_tokens_are_a_pure_function_of_seed_step_and_host():
    d = SyntheticTokens(1000, 24, 6, seed=3, device="cpu")
    a, b = d.batch(5), d.batch(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], d.batch(6)["tokens"])
    assert not torch.equal(a["tokens"], d.batch(5, host_index=1)["tokens"])
    assert not torch.equal(a["tokens"], SyntheticTokens(1000, 24, 6, seed=4,
                                                        device="cpu").batch(5)["tokens"])
    assert a["tokens"].shape == (6, 24) and a["tokens"].dtype == torch.int64
    assert d.batch(5, host_index=1, host_count=3)["tokens"].shape == (2, 24)
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 1000


@pytest.mark.parametrize("vocab", [512, 151_936])
def test_synthetic_tokens_follow_the_reference_distribution(vocab):
    """The Zipf marginal and the bigram rule, by their statistics: the mean
    of log(rank + 1) / log V, the share of rank-0 tokens, and the share of
    positions that follow the rule from their predecessor."""
    def stats(toks):
        toks = np.asarray(toks, np.int64)
        follows = toks[:, 1:] == (toks[:, :-1] * 31 + 7) % vocab
        return (np.log1p(toks).mean() / np.log(vocab), (toks == 0).mean(),
                follows.mean())

    port = stats(SyntheticTokens(vocab, 256, 64, device="cpu").batch(0)["tokens"])
    ref = stats(JSyntheticTokens(vocab, 256, 64).batch(0)["tokens"])
    np.testing.assert_allclose(port, ref, atol=0.02)


# --------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup,total", [(2, 30), (100, 10_000), (0, 5), (7, 7)])
def test_cosine_schedule_matches_reference(warmup, total):
    kw = dict(base_lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in list(range(0, min(total, 200) + 6)) + [total - 1, total + 5]:
        want = float(jcosine(jnp.asarray(step, jnp.int32), **kw))
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        np.testing.assert_allclose(float(cosine_schedule(step, **kw)), want, rtol=1e-6)


# -------------------------------------------------------------------- loss

LOSS_CASES = [  # (S, remat, batch, attn_chunk): one loss chunk, two (with the
    # chunked attention at 4 x 4 tiles), and an S that 512 does not divide
    (16, False, 2, 64), (16, True, 2, 64), (1024, True, 1, 256), (520, False, 1, 64)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
@pytest.mark.parametrize("seq,remat,batch,attn_chunk", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, seq, remat, batch, attn_chunk):
    jm, m, jp, p = _models(arch, dtype="float32", remat=remat, attn_chunk=attn_chunk)
    b = _batch(m.cfg.vocab_size, seq, batch, 3, mask=True)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, _j(b))
    loss, met, g = _grads(m, p, _t(b))
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= 1e-5
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    _leaves_close(g, jg, rel=1e-5)


def test_loss_chunks_and_masks_as_the_reference():
    """Every target masked gives 0 (the count clamped at 1); the chunked
    loss equals the mean over unmasked targets of the full logits' CE."""
    _, m, _, p = _models("qwen2-0.5b", dtype="float32", attn_chunk=512)
    b = _t(_batch(m.cfg.vocab_size, 1024, 1, 0, mask=True))
    loss, _ = m.loss(p, b)
    logits, _ = m.apply(p, b)
    t = b["targets"]
    ll = torch.log_softmax(logits, -1).gather(-1, t.clamp(min=0)[..., None])[..., 0]
    want = -(ll * (t >= 0)).sum() / (t >= 0).sum()
    assert abs(float(loss) - float(want)) <= 1e-5
    b["targets"] = torch.full_like(t, -1)
    assert float(m.loss(p, b)[0]) == 0.0


def test_bf16_loss_and_grads_near_the_fp32_reference():
    jm, _, jp, _ = _models("qwen2-0.5b", dtype="float32")
    _, cfg = _cfgs("qwen2-0.5b", dtype="bfloat16")
    m = build_model(cfg)
    p = from_jax_lm_params(_np(jp), cfg, "cpu")   # rounded to bf16
    b = _batch(cfg.vocab_size, 64, 2, 1, mask=True)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, _j(b))
    loss, _, g = _grads(m, p, _t(b))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    _leaves_close(g, jg, rel=5e-2)


# -------------------------------------------------------------- train step

def _all_but_few_close(got, want, abs_, few, bound):
    """Every element within ``abs_`` but at most a share ``few`` of them,
    which lie within ``bound``."""
    g = np.concatenate([_f32(x).ravel() for x in tree_leaves(got)])
    w = np.concatenate([_f32(x).ravel() for x in jax.tree_util.tree_leaves(want)])
    err = np.abs(g - w)
    assert (err > abs_).mean() <= few and err.max() <= bound, (
        (err > abs_).sum(), err.size, err.max())


@pytest.mark.parametrize("compress", [False, True])
def test_three_train_steps_match_reference(compress):
    """Three steps from one state on the same batches: the metrics within
    1e-5, the params within 1e-5 and the moments within 1e-5 of each
    leaf's largest.

    Adam's ``eps`` is 1e-6 here (the default 1e-8 elsewhere): the update
    of a gradient near zero moves with slope 1/eps, so at 1e-8 the two
    packages' correct fp32 sums of one gradient, taken in other orders,
    leave a few parameters more than 1e-5 apart after three steps. With
    ``compress_grads`` a gradient on a half-quantum boundary of the int8
    code may round either way for two such sums, moving its parameter by up
    to one step's lr: there, all but 1e-4 of the parameters and moments are
    held to the same bounds."""
    jm, m, jp, p = _models("qwen2-0.5b", dtype="float32", remat=True)
    kw = dict(warmup_steps=2, total_steps=30, compress_grads=compress)
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, eps=1e-6), **kw)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, eps=1e-6), **kw)
    jo = jadamw.adamw_init(jp, jtc.optimizer)
    o = adamw_init(p, tc.optimizer)
    jstep, step = jax.jit(jts.make_train_step(jm, jtc)), make_train_step(m, tc)
    for i in range(3):
        b = _batch(m.cfg.vocab_size, 32, 2, i)
        jp, jo, jmet = jstep(jp, jo, _j(b))
        p, o, met = step(p, o, _t(b))
        assert set(met) == set(jmet) == {"loss", "grad_norm", "lr", "ce", "aux"}
        for k in met:
            assert met[k].dtype == torch.float32 and met[k].ndim == 0
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert int(o["count"]) == int(jo["count"]) == 3
    if compress:
        _all_but_few_close(p, jp, 1e-5, 1e-4, 3e-3)
        for k in ("m", "v"):   # a flipped code moves its moment by under a quantum
            top = max(np.abs(_f32(x)).max() for x in jax.tree_util.tree_leaves(jo[k]))
            _all_but_few_close(o[k], jo[k], 1e-5 * top, 1e-4, 1e-2 * top)
        return
    _leaves_close(p, jp, rel=0.0, abs_=1e-5)
    _leaves_close(o["m"], jo["m"], rel=1e-5)
    _leaves_close(o["v"], jo["v"], rel=1e-5)


def test_steps_state_shapes_and_the_other_steps():
    cfg = reduced(get_config("llama3-8b"))
    m = build_model(cfg)
    tc = TrainConfig()
    p, o = init_train_state(m, torch.Generator().manual_seed(0), tc, device="cpu")
    ap, ao = abstract_train_state(m, tc)
    for live, meta in ((p, ap), (o, ao)):
        for x, y in zip(tree_leaves(live), tree_leaves(meta)):
            assert y.device.type == "meta" and (x.shape, x.dtype) == (y.shape, y.dtype)
    b = _t(_batch(cfg.vocab_size, 8, 2, 0))
    ev = make_eval_step(m)(p, b)
    assert set(ev) == {"loss", "ce", "aux"} and math.isfinite(float(ev["loss"]))
    logits, cache = make_prefill_step(m)(p, {"tokens": b["tokens"]})
    assert logits.shape == (2, 1, cfg.vocab_size)
    cache = [KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1)) for t in c))
             for c in cache]
    logits, _ = make_serve_step(m)(p, cache, {"tokens": b["tokens"][:, :1],
                                              "pos": torch.full((2,), 8)})
    assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()


def test_plan_is_passed_to_the_loss_only_when_given():
    seen = []

    class Model:
        def loss(self, params, batch, **kw):
            seen.append(kw)
            return (params["w"] ** 2).sum(), {}

    step = make_train_step(Model(), TrainConfig())
    params = {"w": torch.ones(2)}
    step(params, adamw_init(params, AdamWConfig()), {})
    plan = object()
    make_train_step(Model(), TrainConfig(), plan=plan)(
        params, adamw_init(params, AdamWConfig()), {})
    assert seen == [{}, {"plan": plan}]


# ------------------------------------------- the reference's tests, ported

def test_train_step_decreases_loss():
    """tests/test_archs_smoke.py::test_train_step_decreases_loss: a reduced
    Qwen2-0.5B (bf16) learns on synthetic data, from the reference's
    initial weights and on its batches."""
    jcfg, cfg = _cfgs("qwen2-0.5b")
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3), warmup_steps=2,
                          total_steps=30)
    jp, _ = jts.init_train_state(jbuild_model(jcfg), jax.random.key(0), jtc)
    m = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=30)
    params = from_jax_lm_params(_np(jp), cfg, "cpu")
    opt = adamw_init(params, tc.optimizer)
    step = make_train_step(m, tc)
    losses = []
    for i in range(30):
        params, opt, met = step(params, opt, _t(_batch(cfg.vocab_size, 32, 4, i)))
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]


def test_train_serve_round_trip():
    """tests/test_system.py::test_train_serve_round_trip: train a reduced
    LM a few steps, then serve greedy tokens from it."""
    cfg = reduced(get_config("llama3-8b"))
    m = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=10)
    params, opt = init_train_state(m, torch.Generator().manual_seed(0), tc, device="cpu")
    step = make_train_step(m, tc)
    data = SyntheticTokens(cfg.vocab_size, 32, 2, device="cpu")
    for i in range(5):
        params, opt, metrics = step(params, opt, data.batch(i))
    assert math.isfinite(float(metrics["loss"]))

    toks = data.batch(99)["tokens"][:, :8]
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": toks})
        cache = [KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 8)) for t in c))
                 for c in cache]
        out = []
        tok = logits[:, -1].argmax(-1)[:, None]
        for t in range(8, 12):
            logits, cache = m.decode_step(params, cache,
                                          {"tokens": tok, "pos": torch.full((2,), t)})
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
    gen = torch.cat(out, 1)
    assert gen.shape == (2, 4)
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size


def _trainer_setup():
    cfg = reduced(get_config("qwen2-0.5b"))
    m = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=20)
    data = SyntheticTokens(cfg.vocab_size, 16, 2, device="cpu")

    def fresh():
        return init_train_state(m, torch.Generator().manual_seed(0), tc, device="cpu")

    def trainer(data=data, **kw):
        kw.setdefault("log_fn", lambda *_: None)
        return Trainer(m, make_train_step(m, tc), data, **kw)

    return fresh, trainer


def test_trainer_resume(tmp_path):
    """tests/test_checkpoint.py::test_trainer_resume (kill and relaunch:
    the second run resumes from the checkpoint), and the resumed run is
    bitwise the uninterrupted one."""
    fresh, trainer = _trainer_setup()
    ckpt = str(tmp_path)
    trainer(ckpt_dir=ckpt, ckpt_every=5).run(*fresh(), steps=10)  # writes step_10
    assert latest_step(ckpt) == 10
    t2 = trainer(ckpt_dir=ckpt, ckpt_every=5)
    p2, o2, hist = t2.run(*fresh(), steps=14)
    assert len(hist) == 4  # resumed at 10, ran 10..13
    assert t2.resumed_step == 10
    p, o, full = trainer().run(*fresh(), steps=14)
    assert full[10:] == hist
    assert _bits_equal([p, o], [p2, o2])


def test_nan_step_leaves_the_state_bitwise_untouched():
    fresh, trainer = _trainer_setup()
    p, o = fresh()
    tr = trainer()
    tok = int(tr.data.batch(0)["tokens"][0, 0])
    with torch.no_grad():
        p["embed"]["w"][tok] = float("nan")
    before = tree_map(torch.clone, [p, o])
    logs = []
    tr.log = logs.append
    p1, o1, hist = tr.run(p, o, steps=1)
    assert hist == [] and tr.skipped_steps == 1
    assert _bits_equal(before, [p1, o1])
    assert any("non-finite" in line for line in logs)


class _SigtermAt:
    """Token data that sends this process SIGTERM while drawing step ``at``."""

    def __init__(self, data, at):
        self.data, self.at = data, at

    def batch(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.batch(step)


def test_sigterm_checkpoints_and_stops(tmp_path):
    fresh, trainer = _trainer_setup()
    base = trainer().data
    tr = trainer(data=_SigtermAt(base, 2), ckpt_dir=str(tmp_path), ckpt_every=100)
    before = signal.getsignal(signal.SIGTERM)
    _, _, hist = tr.run(*fresh(), steps=10)
    assert tr.stopped and len(hist) == 3 and latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) == before


# ------------------------------------------------------------ entry points

def test_launch_train_runs_reduced_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    hist = train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "4", "--batch",
                       "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                       "2", "--compress-grads", "--device", "cpu"])
    assert len(hist) == 4 and all(map(math.isfinite, hist))
    assert latest_step(str(tmp_path)) == 4
    assert "loss" in capsys.readouterr().out
    assert train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "4", "--batch",
                       "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"]) == []   # resumed at its end


@pytest.mark.parametrize("mesh,ranks", [("single-pod", 256), ("multi-pod", 512)])
def test_launch_train_refuses_meshes(mesh, ranks):
    """The production meshes need a torchrun world of their size: on one
    rank the launcher raises the ValueError that names it, before it
    touches a process group."""
    import torch.distributed as dist

    from repro_torch.launch import train

    with pytest.raises(ValueError, match=f"needs a torchrun world of {ranks} ranks"):
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--mesh", mesh])
    assert not dist.is_initialized()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []),
    ("torch_serve_gan", ["--requests", "8", "--sequential"]),
    ("torch_train_dcgan", ["--steps", "2", "--batch", "2"]),
    ("torch_serve_lm", []),
    ("torch_train_lm", ["--steps", "3", "--batch", "2", "--seq", "16"]),
])
def test_examples_run_on_the_cpu(name, argv, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    if name == "torch_train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = _example(name).main(argv + ["--device", "cpu"])
    assert out is not None
