"""Training of the MoE and hybrid families through the port against the
reference on the CPU with carried weights: the nested remat's gradients
(each layer under its own checkpoint inside its period's) against
``jax.grad``, and three ``make_train_step`` steps of reduced DBRX and
reduced Jamba against the reference's jitted step. fp32, within 1e-5 of
each leaf's largest value unless a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.lm import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax_lm_params

REL, ABS = 1e-5, 1e-6   # fp32: max |port - ref| <= REL * max|ref| + ABS
B, S = 2, 24


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
    """Both reduced fp32 models and parameter trees, the port's carried."""
    kw.setdefault("dtype", "float32")
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jcfg, cfg, jm, m, jp, from_jax_lm_params(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
         for k in ("tokens", "targets")}
    b["targets"][0, :2] = -1
    return b


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_nested_remat_grads_match_the_reference(arch):
    """``remat`` on a period of several layers (each layer under its own
    checkpoint inside the period's), one period deep: the loss and every
    gradient against ``jax.grad`` of the reference's, fp32, each leaf
    within 1e-5 of its largest, and the same as without remat."""
    jcfg, cfg, jm, m, jp, p = _models(arch, remat=True,
                                      n_layers=get_config(arch).period)
    b = _batch(cfg, 4)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = []
    for model in (m, build_model(dataclasses.replace(cfg, remat=False))):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss, _ = model.loss(live, tb)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        grads.append(torch.autograd.grad(loss, tree_leaves(live)))
    for got, plain, want in zip(*grads, jax.tree_util.tree_leaves(jg)):
        _close(got, want)
        _close(got, plain)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-1.5-large-398b"])
def test_three_train_steps_match_reference(arch):
    """Three steps of ``make_train_step`` from one state on the same
    batches against the reference's jitted step, one period deep (Jamba's
    8 layers): the metrics within 1e-5, params within 1e-5, the first
    moments within 1e-5 of each leaf's largest and the second within 2e-5
    (they are squares: a relative error doubles).

    Adam's ``eps`` is 1e-4 here: an update moves with slope ``lr / eps``
    in a gradient near zero, and the Mamba layers hold many gradients
    near 1e-6 whose two correct fp32 sums differ (their gradients at equal
    params agree within 2e-5 of each leaf's largest); at eps 1e-6 those
    differences, amplified, change the next steps' gradients everywhere
    by about 1e-4 of a leaf's largest moment."""
    jcfg, cfg, jm, m, jp, p = _models(arch, remat=True,
                                      n_layers=get_config(arch).period * (
                                          1 if get_config(arch).period > 1 else 2))
    kw = dict(warmup_steps=2, total_steps=30)
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, eps=1e-4), **kw)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, eps=1e-4), **kw)
    jo, o = jadamw.adamw_init(jp, jtc.optimizer), adamw_init(p, tc.optimizer)
    jstep, step = jax.jit(jts.make_train_step(jm, jtc)), make_train_step(m, tc)
    for i in range(3):
        b = _batch(cfg, 10 + i, s=32)
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, met = step(p, o, {k: torch.from_numpy(v).long() for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr", "ce", "aux"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for got, want in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        _close(got, want, rel=0.0, abs_=1e-5)
    for name, rel in (("m", 1e-5), ("v", 2e-5)):
        for got, want in zip(tree_leaves(o[name]), jax.tree_util.tree_leaves(jo[name])):
            _close(got, want, rel=rel, abs_=0.0)
