"""Port of the Table-4 generators, their plans and the weight loader, held
against the JAX package: the four zoo configs at 1/16 width, batch 2, the
same weights (through ``from_jax_params``) and latents, fp32 within
rtol = atol = 1e-5. The JAX plans are compiled with
``method="unified_reshape", fuse="off"``."""
import jax
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro_torch.kernels import plan as planlib
from repro_torch.models import gan
from repro_torch.weights import from_jax_params

NAMES = sorted(gan.GAN_ZOO)


def _jax_setup(name, batch=2, seed=0):
    """Reduced JAX config, its params with nonzero biases (numpy), and z."""
    cfg_j = jgan.reduced_config(jgan.GAN_ZOO[name], 16)
    params = jax.tree.map(np.asarray,
                          jgan.generator_init(jax.random.key(seed), cfg_j))
    rng = np.random.default_rng(seed)
    for i in range(len(cfg_j.layers)):
        b = params[f"tconv{i}"]["b"]
        params[f"tconv{i}"]["b"] = (0.1 * rng.standard_normal(b.shape)).astype(
            np.float32)
    z = rng.standard_normal((batch, cfg_j.z_dim)).astype(np.float32)
    return cfg_j, params, z


def _jax_generate(cfg_j, params, z):
    plan = jgan.generator_plan(cfg_j, z.shape[0], method="unified_reshape",
                               fuse="off")
    fn = jax.jit(lambda p, zz: jgan.generator_apply(p, cfg_j, zz, plan=plan))
    return np.asarray(fn(params, z))


@pytest.mark.parametrize("name", NAMES)
def test_generator_matches_jax(name):
    cfg_j, params_np, z = _jax_setup(name)
    want = _jax_generate(cfg_j, params_np, z)
    cfg = gan.reduced_config(gan.GAN_ZOO[name], 16)
    params = from_jax_params(params_np, cfg, "cpu")
    got = gan.generator_apply(params, cfg, z, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", planlib.METHODS)
def test_every_pinned_method_matches_jax(method):
    cfg_j, params_np, z = _jax_setup("dcgan", seed=1)
    want = _jax_generate(cfg_j, params_np, z)
    cfg = gan.reduced_config(gan.DCGAN, 16)
    plan = gan.generator_plan(cfg, 2, method=method)
    assert {lp.method for lp in plan} == {method}
    got = gan.generator_apply(from_jax_params(params_np, cfg, "cpu"), cfg, z,
                              plan=plan, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cold_rule_puts_head_on_gemm_and_the_rest_on_fused():
    plan = gan.generator_plan(gan.DCGAN, 8)
    assert [lp.method for lp in plan] == ["gemm", "fused", "fused", "fused"]
    assert all(lp.source == "cold" for lp in plan)
    assert [lp.epilogue.tag() for lp in plan] == ["b+relu"] * 3 + ["b+tanh"]
    ebgan = gan.generator_plan(gan.EBGAN, 1)
    assert [lp.method for lp in ebgan] == ["gemm"] + ["fused"] * 5


def test_plan_buckets_and_memo():
    buckets = planlib.compile_plan_buckets(
        gan.DCGAN, [4, 1, 2, 2], epilogues=gan.generator_epilogues(gan.DCGAN))
    assert sorted(buckets) == [1, 2, 4]
    assert all(lp.batch == b for b, p in buckets.items() for lp in p)
    again = planlib.compile_plan_buckets(
        gan.DCGAN, [2], epilogues=gan.generator_epilogues(gan.DCGAN))
    assert again[2].layers[0] is buckets[2].layers[0]
    with pytest.raises(ValueError):
        planlib.compile_plan_buckets(gan.DCGAN, [0])
    with pytest.raises(ValueError):
        planlib.compile_plan(gan.DCGAN, 1, epilogues=(None,))
    with pytest.raises(ValueError):
        planlib.plan_layer(1, 4, 4, 2, 2, 2, method="pallas_pair")


def test_execute_layer_checks_shape_dtype_and_bias():
    lp = planlib.plan_layer(1, 4, 4, 3, 2, 2, epilogue=gan.Epilogue(True, "relu"))
    x, k, b = torch.zeros((1, 4, 4, 3)), torch.zeros((4, 4, 3, 2)), torch.zeros(2)
    assert planlib.execute_layer(lp, x, k, bias=b).shape == (1, 8, 8, 2)
    with pytest.raises(ValueError, match="mismatch"):
        planlib.execute_layer(lp, torch.zeros((1, 5, 5, 3)), k, bias=b)
    with pytest.raises(ValueError, match="mismatch"):
        planlib.execute_layer(lp, x.double(), k.double(), bias=b.double())
    with pytest.raises(ValueError, match="epilogue"):
        planlib.execute_layer(lp, x, k)


def test_flops_and_memory_savings_match_jax():
    for name in NAMES:
        cfg, cfg_j = gan.GAN_ZOO[name], jgan.GAN_ZOO[name]
        for method in ("segregated", "conventional"):
            assert gan.generator_flops(cfg, method=method) == \
                jgan.generator_flops(cfg_j, method=method)
        for epi in (False, True):
            assert gan.generator_memory_savings(cfg, include_epilogue=epi) == \
                jgan.generator_memory_savings(cfg_j, include_epilogue=epi)
    # the paper's Table-4 EB-GAN figure: ~35 MB never materialized
    assert 34e6 < gan.generator_memory_savings(gan.EBGAN) < 36e6


def test_generator_init_shapes_and_seed():
    cfg = gan.reduced_config(gan.GPGAN, 16)
    p1 = gan.generator_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    p2 = gan.generator_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert p1["proj"]["w"].shape == (100, 4 * 4 * 32)
    for i, (_, cin, cout) in enumerate(cfg.layers):
        assert p1[f"tconv{i}"]["w"].shape == (4, 4, cin, cout)
        assert torch.equal(p1[f"tconv{i}"]["w"], p2[f"tconv{i}"]["w"])
    out = gan.generator_apply(p1, cfg, np.zeros((1, 100), np.float32),
                              device="cpu")
    assert out.shape == (1, 64, 64, 2) and bool(torch.isfinite(out).all())


def test_from_jax_params_rejects_wrong_shapes():
    cfg_j, params_np, _ = _jax_setup("dcgan")
    cfg = gan.reduced_config(gan.DCGAN, 8)       # other widths
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(params_np, cfg, "cpu")


def test_generator_apply_rejects_params_on_another_device():
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        gan.generator_apply(params, cfg, np.zeros((1, 100), np.float32),
                            device="meta")
