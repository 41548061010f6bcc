"""Port of the segregation algebra, the oracles, the epilogue and the
transpose-conv baselines, held against the JAX package on the same numpy
inputs (fp32, rtol = atol = 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segregation as jseg
from repro.core import transpose_conv as jtc
from repro.kernels import epilogue as jepi
from repro.kernels import ref as jref
from repro_torch.core import segregation as seg
from repro_torch.core import transpose_conv as tc
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import ref

GEOMS = [(n, p) for n in (2, 3, 4, 5) for p in range(n)] + [(3, 2)]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_segregate_merge_stack(n):
    k = _rng(n).standard_normal((n, n, 3, 2)).astype(np.float32)
    subs = seg.segregate_kernel(torch.from_numpy(k))
    jsubs = jseg.segregate_kernel(jnp.asarray(k))
    for a, b in zip(subs, jsubs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(seg.merge_subkernels(subs, n).numpy(), k)
    np.testing.assert_array_equal(
        seg.stack_subkernels(torch.from_numpy(k)).numpy(),
        np.asarray(jseg.stack_subkernels(jnp.asarray(k))),
    )


def test_segregate_rejects_1d():
    with pytest.raises(ValueError):
        seg.segregate_kernel(torch.zeros(3))


@pytest.mark.parametrize("n,p", GEOMS)
@pytest.mark.parametrize("n_in", [3, 4, 7])
def test_shape_algebra_matches(n, p, n_in):
    assert seg.output_size(n_in, n, p) == jseg.output_size(n_in, n, p)
    assert seg.plan_phases(n_in, n, p) == tuple(jseg.plan_phases(n_in, n, p))
    for method in ("segregated", "conventional"):
        assert seg.flop_count(n_in, n, 3, 5, p, method=method) == \
            jseg.flop_count(n_in, n, 3, 5, p, method=method)
    for mode in ("diff", "buffer"):
        assert seg.memory_savings_bytes(n_in, 3, 4, p, mode=mode) == \
            jseg.memory_savings_bytes(n_in, 3, 4, p, mode=mode)
    for r in (0, 1):
        for s in (0, 1):
            assert seg.subkernel_shape(n, r, s) == jseg.subkernel_shape(n, r, s)


def test_output_size_rejects_empty():
    with pytest.raises(ValueError):
        seg.output_size(1, 5, 0)


@pytest.mark.parametrize("n,p", GEOMS)
def test_oracles_and_methods_match_jax(n, p):
    rng = _rng(10 * n + p)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    k = rng.standard_normal((n, n, 3, 4)).astype(np.float32)
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    jx, jk = jnp.asarray(x), jnp.asarray(k)
    want = np.asarray(jax.jit(jref.conventional_ref, static_argnums=2)(jx, jk, p))
    got = {
        "conventional_ref": ref.conventional_ref(tx, tk, p),
        "unified_segregated_ref": ref.unified_segregated_ref(tx, tk, p),
        **{name: fn(tx, tk, p) for name, fn in tc.METHODS.items()},
    }
    for name, y in got.items():
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("method", sorted(tc.METHODS))
def test_methods_match_jax_methods_at_gan_padding(method):
    rng = _rng(3)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    k = rng.standard_normal((4, 4, 6, 5)).astype(np.float32)
    want = jax.jit(jtc.METHODS[method], static_argnums=2)(
        jnp.asarray(x), jnp.asarray(k), 2)
    got = tc.METHODS[method](torch.from_numpy(x), torch.from_numpy(k), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ref_promotes_2d():
    x = _rng(0).standard_normal((4, 4)).astype(np.float32)
    k = _rng(1).standard_normal((3, 3)).astype(np.float32)
    got = ref.unified_segregated_ref(torch.from_numpy(x), torch.from_numpy(k), 1)
    want = jref.unified_segregated_ref(jnp.asarray(x), jnp.asarray(k), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------- epilogue

EPIS = [(b, a) for b in (False, True) for a in epilib.ACTIVATIONS]


@pytest.mark.parametrize("bias,act", EPIS)
def test_epilogue_matches_jax(bias, act):
    rng = _rng(5)
    y = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    g = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    e = epilib.Epilogue(bias=bias, act=act)
    je = jepi.Epilogue(bias=bias, act=act)
    assert e.tag() == je.tag()
    assert e.is_identity == je.is_identity
    assert (epilib.canonical(e) is None) == (jepi.canonical(je) is None)
    tb = torch.from_numpy(b) if bias else None
    jb = jnp.asarray(b) if bias else None
    np.testing.assert_allclose(e.apply(torch.from_numpy(y), tb).numpy(),
                               np.asarray(je.apply(jnp.asarray(y), jb)),
                               rtol=1e-6, atol=1e-6)
    out = e.apply(torch.from_numpy(y), tb)
    np.testing.assert_allclose(
        e.grad_from_y(torch.from_numpy(g), out).numpy(),
        np.asarray(je.grad_from_y(jnp.asarray(g), jnp.asarray(out.numpy()))),
        rtol=1e-6, atol=1e-6,
    )


def test_epilogue_validation_and_make():
    with pytest.raises(ValueError):
        epilib.Epilogue(act="gelu")
    with pytest.raises(ValueError):
        epilib.Epilogue(act="leaky_relu", slope=0.0)
    with pytest.raises(ValueError):
        epilib.Epilogue(bias=True).apply(torch.zeros(2))
    assert epilib.make(None) is None
    assert epilib.make(torch.zeros(2), "relu") == epilib.Epilogue(True, "relu")
    assert epilib.Epilogue(act="leaky_relu", slope=0.1).tag() == "leaky0.1"
    assert [epilib.Epilogue(act=a).code for a in epilib.ACTIVATIONS] == [0, 1, 2, 3]
