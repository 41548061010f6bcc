"""The port's segregated dilated convolution held against the JAX
package's ``dilated_conv2d`` on the same numpy inputs (fp32, rtol = atol =
1e-5), at the geometries of ``tests/test_dilated.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dilated_conv import dilated_conv2d as jax_dilated_conv2d
from repro_torch.core.dilated_conv import dilated_conv2d


@pytest.mark.parametrize("method", ["conventional", "segregated"])
@pytest.mark.parametrize("n_in,n_k", [(6, 2), (8, 3), (12, 4), (9, 3)])
def test_dilated_matches_jax(n_in, n_k, method):
    rng = np.random.default_rng(n_in * 10 + n_k)
    x = rng.standard_normal((2, n_in, n_in, 3)).astype(np.float32)
    k = rng.standard_normal((n_k, n_k, 3, 4)).astype(np.float32)
    want = np.asarray(jax_dilated_conv2d(jnp.asarray(x), jnp.asarray(k),
                                         method=method))
    got = dilated_conv2d(torch.from_numpy(x), torch.from_numpy(k), method=method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_in,n_k", [(2, 3), (3, 3), (4, 3), (1, 2)])
def test_too_small_input_conventional_is_empty_as_in_jax(n_in, n_k):
    """An input too small for the dilated kernel: the dense baseline returns
    the empty ``(B, 0, 0, Cout)`` tensor in both packages."""
    rng = np.random.default_rng(n_in * 10 + n_k)
    x = rng.standard_normal((2, n_in, n_in, 3)).astype(np.float32)
    k = rng.standard_normal((n_k, n_k, 3, 4)).astype(np.float32)
    want = np.asarray(jax_dilated_conv2d(jnp.asarray(x), jnp.asarray(k),
                                         method="conventional"))
    got = dilated_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                         method="conventional")
    assert tuple(got.shape) == want.shape == (2, 0, 0, 4)
    assert got.dtype == torch.float32 and want.dtype == np.float32


def test_too_small_input_raises():
    with pytest.raises(ValueError, match="too small"):
        dilated_conv2d(torch.zeros((1, 4, 4, 1)), torch.zeros((3, 3, 1, 1)),
                       method="segregated")


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        dilated_conv2d(torch.zeros((1, 8, 8, 1)), torch.zeros((3, 3, 1, 1)),
                       method="nope")
