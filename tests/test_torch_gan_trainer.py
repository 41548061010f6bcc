"""Port of the training path: AdamW, int8 compression, the discriminator,
checkpoints and the GAN trainer (repro_torch.optim, repro_torch.models.gan,
repro_torch.train). AdamW, checkpoints and ``place_like`` also take an LM's
tree, whose per-period layers are a list.

Against the JAX package on the CPU, on the same numpy inputs: three AdamW
steps per moment dtype, the compressors bit for bit, the discriminator at
64x64x3, checkpoints read across both packages bit for bit, and three
trainer steps of a channel-reduced DCGAN from one shared state. Then the
reference's trainer tests (tests/test_gan_trainer.py), rewritten against
the port's API: config checks, checkpoints, bit-exact resume, the NaN
guard, the skipped count across a checkpoint, compressed error feedback,
and the elastic schedule with its resume.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import SyntheticImages as JSyntheticImages
from repro.models import gan as jgan
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import checkpoint as jckpt
from repro.models.lm import build_model as jbuild_model
from repro.train.gan_trainer import GanTrainer as JGanTrainer
from repro.train.gan_trainer import GanTrainerConfig as JGanTrainerConfig
from repro_torch.data import SyntheticImages
from repro_torch.data.pipeline import bilinear_matrix
from repro_torch.models.layers import KVCache
from repro_torch.models import gan
from repro_torch.optim import adamw, compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax_state

TINY = gan.GANConfig("tiny", 8, ((4, 4, 4), (8, 4, 3)))


def _np(tree):
    """A JAX or port tree as numpy (bf16 as ml_dtypes arrays)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(_np(a)), tree_leaves(_np(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ------------------------------------------------------------------- AdamW

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((3, 300)).astype(np.float32)},
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("moments,tol", [("float32", 1e-6), ("bfloat16", 1e-6),
                                         ("int8", 1e-6)])
def test_adamw_three_steps_match_reference(moments, tol):
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, moment_dtype=moments)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p0 = _params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw.adamw_init(tp, tcfg)
    for step in range(3):
        g = _params(10 + step)
        jp, js, jn = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                         js, jp, jcfg, jcfg.lr)
        tp, ts, tn = adamw.adamw_update(tree_map(torch.from_numpy, g), ts, tp,
                                        tcfg, tcfg.lr)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(_np(tp)), tree_leaves(_np(jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    assert int(ts["count"]) == int(js["count"]) == 3
    for a, b in zip(tree_leaves(_np(ts["m"])), tree_leaves(_np(js["m"]))):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                   rtol=1e-2, atol=1e-6)


def _lm_params(seed=0, dtype="float32"):
    """A reduced Qwen2-0.5B's parameters from the reference, as numpy:
    ``params["layers"]`` is a list of period positions."""
    cfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")), dtype=dtype)
    return jax.tree_util.tree_map(
        np.asarray, jbuild_model(cfg).init(jax.random.key(seed)))


def _lm_np(tree):
    """A port tree of dicts and lists as numpy (bf16 as ml_dtypes arrays)."""
    if isinstance(tree, list):
        return [_lm_np(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _lm_np(v) for k, v in tree.items()}
    return _np(tree)


def _lm_torch(tree):
    if isinstance(tree, list):
        return [_lm_torch(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _lm_torch(v) for k, v in tree.items()}
    return _to_torch(tree)


def _assert_lm_trees_equal(a, b):
    """Bitwise, structure included: lists stay lists."""
    assert jax.tree_util.tree_structure(_lm_np(a)) == jax.tree_util.tree_structure(
        _lm_np(b))
    for x, y in zip(jax.tree_util.tree_leaves(_lm_np(a)),
                    jax.tree_util.tree_leaves(_lm_np(b))):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_on_the_lm_tree_matches_reference(moments):
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, moment_dtype=moments)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p0 = _lm_params()
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = _lm_torch(p0)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw.adamw_init(tp, tcfg)
    for step in range(3):
        rng = np.random.default_rng(10 + step)
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
        jp, js, jn = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                         jp, jcfg, jcfg.lr)
        tp, ts, tn = adamw.adamw_update(_lm_torch(g), ts, tp, tcfg, tcfg.lr)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert isinstance(tp["layers"], list) and isinstance(ts["v"]["layers"], list)
    for a, b in zip(jax.tree_util.tree_leaves(_lm_np(tp)),
                    jax.tree_util.tree_leaves(_np_tree(jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(_lm_np(ts[k])),
                        jax.tree_util.tree_leaves(_np_tree(js[k]))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=1e-2, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_adamw_refuses_unknown_moment_dtype():
    with pytest.raises(ValueError, match="moment_dtype"):
        adamw.adamw_init({"w": torch.zeros(2)}, adamw.AdamWConfig(moment_dtype="fp8"))


# ------------------------------------------------------------- compression

@pytest.mark.parametrize("shape", [(7,), (3, 300), (2, 2, 256)])
def test_compress_int8_bitwise(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = [0.5, -0.5, 2.5]   # ties of the rounding
    q, s = compression.compress_int8(torch.from_numpy(x))
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.decompress_int8(q, s, shape).numpy(),
        np.asarray(jcomp.decompress_int8(jq, js, shape)))


def test_error_feedback_compress_bitwise_over_two_rounds():
    g1, g2 = _params(1), _params(2)
    deq, err = compression.error_feedback_compress(tree_map(torch.from_numpy, g1))
    jdeq, jerr = jcomp.error_feedback_compress(jax.tree_util.tree_map(jnp.asarray, g1))
    _assert_trees_equal(deq, jdeq)
    _assert_trees_equal(err, jerr)
    deq, err = compression.error_feedback_compress(tree_map(torch.from_numpy, g2), err)
    jdeq, jerr = jcomp.error_feedback_compress(
        jax.tree_util.tree_map(jnp.asarray, g2), jerr)
    _assert_trees_equal(deq, jdeq)
    _assert_trees_equal(err, jerr)
    zeros = compression.zero_error_state(tree_map(torch.from_numpy, g1))
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(zeros))


# ----------------------------------------------------------- discriminator

def test_discriminator_matches_reference():
    """At 64x64x3, the reference's DCGAN output size: the head flattens in
    NHWC order in both packages."""
    dp = jgan.discriminator_init(jax.random.key(3), 64, 3)
    x = np.tanh(np.random.default_rng(4).standard_normal((2, 64, 64, 3))
                ).astype(np.float32)
    want = np.asarray(jgan.discriminator_apply(dp, jnp.asarray(x)))
    tdp = tree_map(lambda a: torch.from_numpy(np.array(a)), dp)
    got = gan.discriminator_apply(tdp, torch.from_numpy(x))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_discriminator_init_shapes():
    dp = gan.discriminator_init(torch.Generator().manual_seed(0), 16, 3, width=8,
                                device="cpu")
    assert {k: tuple(v["w"].shape) for k, v in dp.items()} == {
        "conv0": (4, 4, 3, 8), "conv1": (4, 4, 8, 16), "conv2": (4, 4, 16, 32),
        "head": (2 * 2 * 32, 1)}


# ------------------------------------------------------------- checkpoints

def _jax_ckpt_state():
    rng = np.random.default_rng(5)
    params = {"g": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32)}}
    opt = {"g": {
        "m": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)},
        "v": {"w": {"q": jnp.asarray(rng.integers(-127, 128, (3, 1, 256)), jnp.int8),
                    "scale": jnp.asarray(rng.random((3, 1, 1)), jnp.float32)}},
        "count": jnp.array(7, jnp.int32)}}
    return params, opt


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    params, opt = _jax_ckpt_state()
    jckpt.save_checkpoint(tmp_path, 5, params, opt,
                          extra={"skipped_steps": np.int64(2)})
    step, p, o, extra = ckpt.restore_checkpoint(tmp_path)
    assert step == 5 and int(extra["skipped_steps"]) == 2
    assert o["g"]["m"]["w"].dtype == torch.bfloat16
    _assert_trees_equal(p, params)
    _assert_trees_equal(o, opt)


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    params, opt = _jax_ckpt_state()
    tp, to = tree_map(_to_torch, params), tree_map(_to_torch, opt)
    ckpt.save_checkpoint(tmp_path, 9, tp, to, extra={"skipped_steps": np.int64(1)})
    step, p, o, extra = jckpt.restore_checkpoint(tmp_path)
    assert step == 9 and int(extra["skipped_steps"]) == 1
    assert o["g"]["m"]["w"].dtype == ml_dtypes.bfloat16
    _assert_trees_equal(p, params)
    _assert_trees_equal(o, opt)


def _jax_lm_state(moments):
    """A reduced Qwen2-0.5B train state (bf16 params) from the reference,
    its moments of ``moments`` dtype made non-zero."""
    params = jax.tree_util.tree_map(jnp.asarray, _lm_params(dtype="bfloat16"))
    opt = jadamw.adamw_init(params, jadamw.AdamWConfig(moment_dtype=moments))
    g = jax.tree_util.tree_map(lambda a: jnp.ones(a.shape, jnp.float32) * 0.01, params)
    _, opt, _ = jadamw.adamw_update(g, opt, params, jadamw.AdamWConfig(
        moment_dtype=moments), 1e-3)
    return params, opt


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_lm_checkpoints_interchange_with_the_reference(tmp_path, direction, moments):
    """An LM state (its layers a list, bf16 params, int8 moments as
    ``{"q", "scale"}``) written by one package restores in the other
    bitwise, with lists restored as lists."""
    params, opt = _jax_lm_state(moments)
    if direction == "reference_to_port":
        jckpt.save_checkpoint(tmp_path, 4, params, opt)
        step, p, o, _ = ckpt.restore_checkpoint(tmp_path)
    else:
        ckpt.save_checkpoint(tmp_path, 4, _lm_torch(_np_tree(params)),
                             _lm_torch(_np_tree(opt)))
        step, p, o, _ = jckpt.restore_checkpoint(tmp_path)
    assert step == 4
    _assert_lm_trees_equal(p, params)
    _assert_lm_trees_equal(o, opt)


def test_list_and_namedtuple_trees_round_trip_bitwise(tmp_path):
    """Lists and tuples come back as lists, a NamedTuple as a dict of its
    fields (the reference's scheme), every leaf bitwise."""
    rng = np.random.default_rng(0)
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.integers(-127, 128, (2, 1, 256)).astype(np.int8))
    params = {"layers": [{"w": torch.arange(6.0).reshape(2, 3)}, {"w": k}],
              "cache": [KVCache(k, v)], "pair": (v, q)}
    opt = {"v": [{"q": q, "scale": torch.ones(2, 1, 1)}], "count": torch.tensor(3)}
    ckpt.save_checkpoint(tmp_path, 1, params, opt)
    _, p, o, _ = ckpt.restore_checkpoint(tmp_path)
    want = {"layers": params["layers"], "cache": [{"k": k, "v": v}], "pair": [v, q]}
    _assert_lm_trees_equal(p, want)
    _assert_lm_trees_equal(o, opt)


def test_place_like_walks_lists(tmp_path):
    params, opt = _jax_lm_state("int8")
    live_p, live_o = _lm_torch(_np_tree(params)), _lm_torch(_np_tree(opt))
    ckpt.save_checkpoint(tmp_path, 2, live_p, live_o)
    _, p, o, _ = ckpt.restore_checkpoint(tmp_path)
    placed_p, placed_o = ckpt.place_like(p, live_p), ckpt.place_like(o, live_o)
    _assert_lm_trees_equal(placed_p, live_p)
    _assert_lm_trees_equal(placed_o, live_o)
    with pytest.raises(ValueError, match="list"):
        ckpt.place_like({"layers": p["layers"][:1]}, {"layers": live_p["layers"] * 2})


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_restore_skips_a_corrupt_checkpoint(tmp_path):
    tp = {"w": torch.arange(4.0)}
    to = {"count": torch.tensor(1, dtype=torch.int32)}
    ckpt.save_checkpoint(tmp_path, 1, tp, to)
    ckpt.save_checkpoint(tmp_path, 2, tp, to)
    (tmp_path / "step_00000002.npz").write_bytes(b"not a zip")
    (tmp_path / "junk.tmp").write_bytes(b"")
    logs = []
    step, p, _, _ = ckpt.restore_checkpoint(tmp_path, log_fn=logs.append)
    assert step == 1 and torch.equal(p["w"], tp["w"]) and logs
    ckpt.gc_checkpoints(tmp_path, keep_last=1)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["step_00000002.npz"]


# ------------------------------------------------------ trainer vs reference

def _leaves(state, part):
    return tree_leaves(_np(state[part]))


def test_trainer_steps_match_reference():
    """Three steps of a channel-reduced DCGAN (global batch 2) from one
    state on the same reals and latents. Every step: losses and grad norms
    within 1e-4 (from step 1 on they depend on the earlier updates), and
    every parameter leaf moved. After three steps: each parameter's change
    within lr/100 of the reference's change, and the moments within 1e-4 of
    their largest entry. Adam turns a gradient that is zero to rounding
    into a +-lr step whose sign is the rounding's, so the change leaves out,
    by rule, each entry whose reference gradient at some step is within
    1e-4 of its leaf's largest; the gradients are read off the reference's
    first moments, g_t = (m_t - b1 m_(t-1)) / (1 - b1)."""
    cfg_j = jgan.reduced_config(jgan.DCGAN, 16)
    cfg_t = gan.reduced_config(gan.DCGAN, 16)
    jt = JGanTrainer(cfg_j, JGanTrainerConfig(global_batch=2),
                     JSyntheticImages(64, cfg_j.layers[-1][2], 2), log_fn=lambda *a: None)
    state_j = jt.init_state(jax.random.key(0))
    tt = GanTrainer(cfg_t, GanTrainerConfig(global_batch=2),
                    SyntheticImages(64, cfg_t.layers[-1][2], 2, device="cpu"),
                    log_fn=lambda *a: None, device="cpu")
    state_t = from_jax_state(_np(state_j), cfg_t, "cpu")
    states_j = [_np(state_j)]
    for step in range(3):
        reals, zs = (np.array(a) for a in jt._batches(step))
        before = _np(state_t)
        state_j, mj = jt._step_fn(state_j, jnp.asarray(reals), jnp.asarray(zs))
        state_t, mt = tt._step_fn(state_t, torch.from_numpy(reals),
                                  torch.from_numpy(zs))
        assert mt["skipped"] == int(mj["skipped"]) == 0
        for key in ("g_loss", "d_loss", "g_gnorm", "d_gnorm"):
            np.testing.assert_allclose(mt[key], float(mj[key]), rtol=1e-4,
                                       err_msg=f"{key} at step {step}")
        for part in ("g_params", "d_params"):
            for old, new in zip(tree_leaves(before[part]), _leaves(state_t, part)):
                assert not np.array_equal(old, new), f"a {part} leaf did not move"
        states_j.append(_np(state_j))

    opt = tt.tcfg.opt
    start, want, got = states_j[0], states_j[-1], _np(state_t)
    for part, opt_part in (("g_params", "g_opt"), ("d_params", "d_opt")):
        moments = [tree_leaves(s[opt_part]["m"]) for s in states_j]
        for i, (p0, pj, pt) in enumerate(zip(tree_leaves(start[part]),
                                             tree_leaves(want[part]),
                                             tree_leaves(got[part]))):
            grads = np.stack([(moments[t + 1][i] - opt.b1 * moments[t][i]) / (1 - opt.b1)
                              for t in range(3)])
            decided = (np.abs(grads) > 1e-4 * np.abs(grads).max()).all(axis=0)
            assert decided.any(), f"{part} leaf {i}: no entry compared"
            np.testing.assert_allclose((pt - p0)[decided], (pj - p0)[decided],
                                       rtol=0, atol=opt.lr / 100,
                                       err_msg=f"{part} leaf {i}: change")
        for moment in ("m", "v"):
            for a, b in zip(tree_leaves(got[opt_part][moment]),
                            tree_leaves(want[opt_part][moment])):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
        assert int(got[opt_part]["count"]) == int(want[opt_part]["count"]) == 3


# ------------------------------------- the reference's trainer tests, ported

def _data(tcfg, cfg=TINY):
    micro, _ = tcfg.micro_accum
    return SyntheticImages(hw=cfg.out_hw(cfg.layers[-1][0]),
                           channels=cfg.layers[-1][2], global_batch=micro,
                           device="cpu")


def _trainer(tcfg, *, ckpt_dir=None, hooks=None, data=None, cfg=TINY):
    return GanTrainer(cfg, tcfg, data if data is not None else _data(tcfg, cfg),
                      ckpt_dir=ckpt_dir, hooks=hooks, log_fn=lambda *a: None,
                      device="cpu")


def _seed(s):
    return torch.Generator().manual_seed(s)


class NanAt:
    """Data whose batch is all NaN at the given step indices."""

    def __init__(self, data, steps):
        self.data, self.steps = data, set(steps)

    def batch(self, i):
        x = self.data.batch(i)
        return torch.full_like(x, float("nan")) if i in self.steps else x


def test_config_validation():
    with pytest.raises(ValueError):
        GanTrainerConfig(pods_alive=3, pods_total=2)
    with pytest.raises(ValueError):
        GanTrainerConfig(pods_alive=0)
    with pytest.raises(ValueError):
        GanTrainerConfig(global_batch=0)


def test_trains_and_checkpoints(tmp_path):
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    tr = _trainer(tcfg, ckpt_dir=tmp_path)
    state, hist = tr.run(tr.init_state(_seed(0)), steps=4)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["g_loss"]) and np.isfinite(h["d_loss"]) for h in hist)
    assert ckpt.latest_step(tmp_path) == 4
    s = tr.metrics_summary()
    assert s["skipped_steps"] == 0 and s["steps_timed"] == 4


def test_resume_continues_and_trajectory_is_bit_exact(tmp_path):
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=3)
    ref_tr = _trainer(tcfg)
    ref_state, ref = ref_tr.run(ref_tr.init_state(_seed(0)), steps=6)

    tr1 = _trainer(tcfg, ckpt_dir=tmp_path)
    tr1.run(tr1.init_state(_seed(0)), steps=3)
    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    state2, hist2 = tr2.run(tr2.init_state(_seed(0)), steps=6)

    assert tr2.resumed_step == 3
    assert [h["step"] for h in hist2] == [3, 4, 5]
    assert [r for r in ref if r["step"] >= 3] == hist2
    _assert_trees_equal(state2, ref_state)


def test_nan_guard_leaves_state_bitwise_untouched():
    tcfg = GanTrainerConfig(global_batch=2)
    tr = _trainer(tcfg, data=NanAt(_data(tcfg), (0,)))
    state = tr.init_state(_seed(1))
    before = _np(state)
    state, hist = tr.run(state, steps=1)
    assert hist[0]["skipped"] == 1
    assert tr.skipped_steps == 1
    _assert_trees_equal(state, before)


def test_nan_step_then_training_continues():
    tcfg = GanTrainerConfig(global_batch=2)
    tr = _trainer(tcfg, data=NanAt(_data(tcfg), (1,)))
    _, hist = tr.run(tr.init_state(_seed(0)), steps=4)
    assert [h["skipped"] for h in hist] == [0, 1, 0, 0]
    assert all(np.isfinite(h["g_loss"]) for h in hist if not h["skipped"])
    assert tr.skipped_steps == 1


def test_skipped_count_survives_checkpoint(tmp_path):
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    tr = _trainer(tcfg, ckpt_dir=tmp_path, data=NanAt(_data(tcfg), (0,)))
    tr.run(tr.init_state(_seed(0)), steps=2)
    assert tr.skipped_steps == 1
    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    tr2.run(tr2.init_state(_seed(0)), steps=3)
    assert tr2.skipped_steps == 1   # restored from the checkpoint extra


def test_compressed_error_feedback_is_checkpointed(tmp_path):
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2, compress_grads=True)
    ref_tr = _trainer(tcfg)
    ref_state = ref_tr.init_state(_seed(0))
    assert "err" in ref_state["g_opt"] and "err" in ref_state["d_opt"]
    _, ref = ref_tr.run(ref_state, steps=4)

    tr1 = _trainer(tcfg, ckpt_dir=tmp_path)
    st1, _ = tr1.run(tr1.init_state(_seed(0)), steps=2)
    err_norm = sum(float(t.abs().sum()) for t in tree_leaves(st1["g_opt"]["err"]))
    assert err_norm > 0.0
    _, _, opt, _ = ckpt.restore_checkpoint(tmp_path)
    _assert_trees_equal(opt["g"]["err"], st1["g_opt"]["err"])

    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist2 = tr2.run(tr2.init_state(_seed(0)), steps=4)
    assert [r for r in ref if r["step"] >= 2] == hist2


def test_elastic_schedule_shrinks_micro_and_accumulates():
    tcfg = GanTrainerConfig(global_batch=4, pods_alive=1, pods_total=2)
    tr = _trainer(tcfg)
    assert (tr.micro, tr.accum) == (2, 2)
    assert tr.micro * tr.accum >= tcfg.global_batch
    assert tr.train_plan[0].batch == tr.micro
    _, hist = tr.run(tr.init_state(_seed(0)), steps=2)
    assert len(hist) == 2 and all(np.isfinite(h["g_loss"]) for h in hist)


def test_elastic_resume_across_pod_loss(tmp_path):
    full = GanTrainerConfig(global_batch=4, ckpt_every=2)
    tr1 = _trainer(full, ckpt_dir=tmp_path)
    tr1.run(tr1.init_state(_seed(0)), steps=2)
    degraded = dataclasses.replace(full, pods_alive=1, pods_total=2)
    tr2 = _trainer(degraded, ckpt_dir=tmp_path)
    _, hist = tr2.run(tr2.init_state(_seed(0)), steps=4)
    assert tr2.resumed_step == 2
    assert [h["step"] for h in hist] == [2, 3]
    assert all(np.isfinite(h["g_loss"]) for h in hist)


# ------------------------------------------------------------------- pieces

def test_synthetic_images_are_a_pure_function_of_the_step():
    data = SyntheticImages(16, 3, 2, seed=4, device="cpu")
    a, b = data.batch(5), data.batch(5)
    assert a.shape == (2, 16, 16, 3) and torch.equal(a, b)
    assert not torch.equal(a, data.batch(6))
    assert float(a.abs().max()) <= 1.0


@pytest.mark.parametrize("n_in,n_out", [(2, 16), (8, 64), (3, 7)])
def test_synthetic_images_upsample_as_the_reference_resizes(n_in, n_out):
    """The port's bilinear upsampling (two products with a fixed matrix) is
    the reference's jax.image.resize on the same base noise."""
    base = np.random.default_rng(n_in).standard_normal((2, n_in, n_in, 3)
                                                       ).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(base), (2, n_out, n_out, 3),
                                       "bilinear"))
    up = bilinear_matrix(n_out, n_in, torch.device("cpu"))
    got = up @ torch.from_numpy(base).permute(0, 3, 1, 2) @ up.T
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_train_plan_runs_the_kernels_with_the_segregated_backward():
    tr = _trainer(GanTrainerConfig(global_batch=2))
    assert [lp.method for lp in tr.train_plan] == ["gemm", "fused"]
    assert {lp.bwd_method for lp in tr.train_plan} == {"segregated"}
