"""Card tests of the port: each CUDA kernel against its plain version, and
the generator's batch invariance. Every test is marked ``cuda`` and skips
itself when no card is present. The file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.kernels import transpose_conv2d_gemm as tcg
from repro_torch.models import gan

pytestmark = pytest.mark.cuda

EPILOGUES = [
    None,
    epilib.Epilogue(bias=True),
    epilib.Epilogue(bias=True, act="relu"),
    epilib.Epilogue(bias=True, act="tanh"),
    epilib.Epilogue(bias=True, act="leaky_relu", slope=0.2),
]
EPI_IDS = ["none", "b", "b+relu", "b+tanh", "b+leaky0.2"]
SHAPES = [  # (B, N, n, P, Cin, Cout)
    (8, 4, 4, 2, 1024, 512),   # DCGAN L0
    (8, 8, 4, 2, 512, 256),    # DCGAN L1
    (8, 32, 4, 2, 128, 3),     # DCGAN L3
    (2, 7, 3, 0, 37, 19),      # odd M, Cout not a multiple of a tile
    (2, 6, 5, 1, 20, 70),      # n = 5, odd P
    (1, 9, 3, 3, 33, 5),       # n = 3, odd P, odd M
]
KERNELS = {
    "fused": (tcf.transpose_conv2d_fused, tcf.transpose_conv2d_fused_plain),
    "gemm": (tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, b, n_in, cin, n_k, cout, device):
    """Inputs at the generator's scale: a fan-in scaled kernel keeps the
    pre-activations O(1), so the tolerance on a tanh output (whose max is
    1) is not spent on rounding a pre-activation of size ~100."""
    rng = np.random.default_rng(seed)
    x, k, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n_in, n_in, cin), (n_k, n_k, cin, cout), (cout,)))
    k *= (n_k * n_k * cin) ** -0.5
    return tuple(torch.from_numpy(a).to(device) for a in (x, k, 0.1 * b))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain(card, kernel, epi, shape):
    """Within 1e-4 * max|ref| + 1e-5: fp32 sums of up to 16384 terms taken
    in another order."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    bias = bias if epi is not None else None
    launch, plain = KERNELS[kernel]
    before = launch.launches
    got = launch(x, k, pad, epilogue=epi, bias=bias)
    want = plain(x, k, pad, epilogue=epi, bias=bias)
    torch.cuda.synchronize()
    assert launch.launches == before + 1
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_refuses_other_dtypes(card, kernel):
    x, k, _ = _case(0, 1, 4, 2, 4, 2, card)
    with pytest.raises(TypeError):
        KERNELS[kernel][0](x.double(), k.double(), 2)


def test_generator_batch_invariant_bitwise(card):
    """A sample's image does not depend on what it is batched with: each
    row of a batch-8 call equals the batch-1 call on that row, bit for bit."""
    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device=card)
    z = torch.randn((8, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    batched = gan.generator_apply(params, cfg, z, device=card)
    for i in range(8):
        one = gan.generator_apply(params, cfg, z[i : i + 1], device=card)
        assert torch.equal(one[0], batched[i])
