"""The port's transpose-conv zoo and its entry ``transpose_conv2d`` held
against the JAX package's on the same numpy inputs (fp32, rtol = atol =
1e-5 unless said): every method name the entry takes at the geometries of
``tests/test_transpose_conv.py``, each epilogue, gradients, bf16, n = 1,
the ``plan=`` checks and the exports of ``repro_torch.core``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro_torch.core
from repro.core import transpose_conv as jtc
from repro_torch.core import transpose_conv as tc
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import plan as planlib

GEOMS = [(3, 2, 0), (4, 3, 1), (5, 4, 2), (6, 5, 1), (4, 5, 3), (7, 3, 0),
         (8, 4, 1), (5, 5, 2)]
NAMES = sorted(tc.METHODS) + sorted(tc.KERNEL_METHODS)
# (bias, act) of each epilogue the entry composes or fuses
EPIS = [(False, "relu"), (True, "none"), (True, "tanh"), (True, "leaky_relu")]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_autotune_cache(tmp_path, monkeypatch):
    """The reference's ``auto`` reads its autotune cache: an empty one."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


def _jax_method(name: str) -> str:
    """The reference method a port name is held against: its own, except
    ``pallas`` and ``pallas_fused``, whose reference kernel cannot run here
    (its BlockSpecs use ``pl.unblocked``, which JAX 0.9 removed); those are
    held against the reference's ``unified``, the function that kernel
    computes."""
    return "unified" if name in ("pallas", "pallas_fused") else name


def _inputs(n_in, n_k, seed, cin=3, cout=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n_in, n_in, cin)).astype(np.float32)
    k = rng.standard_normal((n_k, n_k, cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, k, b


def _jax(name, x, k, pad, bias=None, act="none"):
    jb = None if bias is None else jnp.asarray(bias)
    return np.asarray(jtc.transpose_conv2d(
        jnp.asarray(x), jnp.asarray(k), pad, method=_jax_method(name),
        bias=jb, act=act))


@pytest.mark.parametrize("n_in,n_k,pad", GEOMS)
@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_jax(name, n_in, n_k, pad):
    x, k, _ = _inputs(n_in, n_k, seed=n_in * 10 + n_k)
    got = tc.transpose_conv2d(torch.from_numpy(x), torch.from_numpy(k), pad,
                              method=name)
    np.testing.assert_allclose(got.numpy(), _jax(name, x, k, pad), **TOL)


@pytest.mark.parametrize("bias,act", EPIS, ids=[f"{b}-{a}" for b, a in EPIS])
@pytest.mark.parametrize("name", NAMES)
def test_entry_epilogues_match_jax(name, bias, act):
    x, k, b = _inputs(6, 5, seed=7)
    b = b if bias else None
    got = tc.transpose_conv2d(
        torch.from_numpy(x), torch.from_numpy(k), 1, method=name,
        bias=None if b is None else torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got.numpy(), _jax(name, x, k, 1, b, act), **TOL)


@pytest.mark.parametrize("with_epilogue", [False, True], ids=["bare", "b+tanh"])
@pytest.mark.parametrize("n_in,n_k,pad", [(5, 4, 2), (6, 5, 1)])
@pytest.mark.parametrize("name", NAMES)
def test_entry_grads_match_jax_conventional(name, n_in, n_k, pad,
                                            with_epilogue):
    """d(sum y^2)/d(x, kernel, bias) against ``jax.grad`` of the
    reference's conventional method with the same epilogue, within rtol
    1e-5 and 1e-5 of each gradient's magnitude."""
    x, k, b = _inputs(n_in, n_k, seed=3)
    act = "tanh" if with_epilogue else "none"

    def jloss(x, k, b):
        y = jtc.transpose_conv2d(x, k, pad, method="conventional",
                                 bias=b if with_epilogue else None, act=act)
        return jnp.sum(y * y)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, k, b)]
    y = tc.transpose_conv2d(leaves[0], leaves[1], pad, method=name,
                            bias=leaves[2] if with_epilogue else None, act=act)
    (y * y).sum().backward()
    for t, w in zip(leaves[: 3 if with_epilogue else 2], want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", NAMES)
def test_entry_bf16_against_fp32_reference(name):
    """bf16 operands against the reference's fp32 conventional on the same
    (bf16-rounded) values, within 2% of the magnitude of the output before
    its activation (tanh is 1-Lipschitz; the sums round at that scale)."""
    x, k, b = _inputs(8, 4, seed=11, cin=4, cout=8)
    tx = torch.from_numpy(x).bfloat16()
    tk = torch.from_numpy(k).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = tc.transpose_conv2d(tx, tk, 1, method=name, bias=tb, act="tanh")
    assert got.dtype == torch.bfloat16
    args = (tx.float().numpy(), tk.float().numpy(), 1, tb.float().numpy())
    scale = np.abs(_jax("conventional", *args)).max()
    err = np.abs(got.float().numpy() - _jax("conventional", *args, "tanh")).max()
    assert err <= 2e-2 * scale, (err, scale)


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("name", ["unified_fused", "unified_matmul",
                                  "unified_reshape"])
def test_uniform_methods_serve_a_1x1_kernel(name, pad):
    x, k, _ = _inputs(5, 1, seed=5)
    got = tc.transpose_conv2d(torch.from_numpy(x), torch.from_numpy(k), pad,
                              method=name)
    np.testing.assert_allclose(got.numpy(), _jax(name, x, k, pad), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_auto_and_kernel_spellings_run_their_plan(name, monkeypatch):
    """``auto`` resolves the CUDA cold rule, each Pallas spelling its
    kernel's plan method; the baselines run without a plan."""
    seen = []
    execute = planlib.execute_layer

    def spy(lp, *args, **kwargs):
        seen.append(lp.method)
        return execute(lp, *args, **kwargs)

    monkeypatch.setattr(planlib, "execute_layer", spy)
    x, k, _ = _inputs(8, 4, seed=2)  # M = 14, Hp = 7: the GEMM side
    x16, _, _ = _inputs(16, 4, seed=2)  # Hp = 15: the fused side
    for xin, cold in ((x, "gemm"), (x16, "fused")):
        tc.transpose_conv2d(torch.from_numpy(xin), torch.from_numpy(k), 1,
                            method=name)
        if name == "auto":
            assert seen[-1] == cold == planlib.cold_method(xin.shape[1], 4, 1)
        elif name in tc.KERNEL_METHODS:
            assert seen[-1] == tc.KERNEL_METHODS[name]
        else:
            assert not seen


def test_transpose_conv_auto_is_the_auto_entry():
    x, k, b = (torch.from_numpy(a) for a in _inputs(6, 4, seed=4))
    np.testing.assert_array_equal(
        tc.transpose_conv_auto(x, k, 2, bias=b, act="relu").numpy(),
        tc.transpose_conv2d(x, k, 2, method="auto", bias=b, act="relu").numpy())


def test_auto_stays_out_of_the_plan_methods():
    assert "auto" in tc.METHODS
    assert "auto" not in planlib.METHODS
    with pytest.raises(ValueError):
        planlib.plan_layer(1, 4, 4, 3, 4, 2, method="pallas")


def test_plan_mismatches_raise():
    x, k, b = (torch.from_numpy(a) for a in _inputs(5, 4, seed=6))
    lp = planlib.plan_layer(2, 5, 4, 3, 4, 2,
                            epilogue=epilib.Epilogue(bias=True, act="relu"))
    y = tc.transpose_conv2d(x, k, 2, plan=lp, bias=b, act="relu")
    want = tc.transpose_conv2d(x, k, 2, method="conventional", bias=b, act="relu")
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="padding"):
        tc.transpose_conv2d(x, k, 1, plan=lp, bias=b, act="relu")
    with pytest.raises(ValueError, match="epilogue"):
        tc.transpose_conv2d(x, k, 2, plan=lp, bias=b, act="tanh")
    with pytest.raises(ValueError, match="epilogue"):
        tc.transpose_conv2d(x, k, 2, plan=lp)


def test_unknown_method_raises():
    x, k, _ = (torch.from_numpy(a) for a in _inputs(4, 3, seed=0))
    with pytest.raises(ValueError, match="unknown method"):
        tc.transpose_conv2d(x, k, method="nope")


def test_core_exports_the_reference_names():
    assert repro_torch.core.__all__ == repro.core.__all__
    for name in repro_torch.core.__all__:
        assert getattr(repro_torch.core, name) is not None


EMPTY_GEOMS = [(2, 4, 0), (1, 3, 0), (2, 5, 0)]   # M = 2N - n + 2P <= 0


@pytest.mark.parametrize("n_in,n_k,pad", EMPTY_GEOMS)
@pytest.mark.parametrize("name", ["conventional", "xla"])
def test_non_positive_output_is_empty_as_in_jax(name, n_in, n_k, pad):
    """Where the output extent is not positive, the dense baselines return
    the empty ``(B, 0, 0, Cout)`` tensor in both packages."""
    x, k, _ = _inputs(n_in, n_k, seed=n_in * 10 + n_k)
    want = _jax(name, x, k, pad)
    got = tc.transpose_conv2d(torch.from_numpy(x), torch.from_numpy(k), pad,
                              method=name)
    assert tuple(got.shape) == want.shape == (2, 0, 0, 4)
    assert got.dtype == torch.float32 and want.dtype == np.float32


@pytest.mark.parametrize("n_in,n_k,pad", EMPTY_GEOMS)
@pytest.mark.parametrize("name", [n for n in sorted(tc.METHODS)
                                  if n not in ("conventional", "xla")])
def test_non_positive_output_phase_methods_raise_as_in_jax(name, n_in, n_k, pad):
    x, k, _ = _inputs(n_in, n_k, seed=n_in * 10 + n_k)
    with pytest.raises(ValueError, match="non-positive output size"):
        _jax(name, x, k, pad)
    with pytest.raises(ValueError, match="non-positive output size"):
        tc.transpose_conv2d(torch.from_numpy(x), torch.from_numpy(k), pad,
                            method=name)
