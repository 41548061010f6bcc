"""Card tests of the port: each CUDA kernel against its plain version, the
generator's batch invariance, and the generator's gradients through the
backward kernels. Every test is marked ``cuda`` and skips
itself when no card is present. The file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.kernels import transpose_conv2d_bwd as bw
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


def _close(got, want):
    """Within 1e-4 * max|ref| + 1e-5: fp32 sums of up to 8192 terms taken in
    another order."""
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.parametrize("epi", EPILOGUES[2:], ids=EPI_IDS[2:])
def test_epilogue_grad_kernel_matches_plain_bitwise(card, epi):
    gen = torch.Generator(device=card).manual_seed(0)
    g = torch.randn((8, 64, 64, 3), device=card, generator=gen)
    y = torch.tanh(torch.randn(g.shape, device=card, generator=gen))
    y[0, 0, 0] = 0.0
    before = bw.epilogue_grad.launches
    got = bw.epilogue_grad(g, y, epi)
    want = bw.epilogue_grad_plain(g, y, epi)
    torch.cuda.synchronize()
    assert bw.epilogue_grad.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_db", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dx_and_dw_kernels_match_plain(card, shape, with_db):
    b, n_in, n_k, pad, cin, cout = shape
    x, k, _ = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    m = 2 * n_in - n_k + 2 * pad
    gm = torch.randn((b, m, m, cout), device=card,
                     generator=torch.Generator(device=card).manual_seed(1))
    before = (bw.transpose_conv2d_dx.launches, bw.transpose_conv2d_dw.launches)
    dx = bw.transpose_conv2d_dx(gm, k, n_in, pad)
    dw = bw.transpose_conv2d_dw(x, gm, n_k, pad, with_db=with_db)
    torch.cuda.synchronize()
    assert (bw.transpose_conv2d_dx.launches, bw.transpose_conv2d_dw.launches) == (
        before[0] + 1, before[1] + 1)
    _close(dx, bw.transpose_conv2d_dx_plain(gm, k, n_in, pad))
    want = bw.transpose_conv2d_dw_plain(x, gm, n_k, pad, with_db=with_db)
    if with_db:
        _close(dw[0], want[0])
        _close(dw[1], want[1])
    else:
        _close(dw, want)


def test_backward_kernels_are_deterministic(card):
    """Two runs of the split dx and dw kernels give the same bits."""
    b, n_in, n_k, pad, cin, cout = 8, 32, 4, 2, 128, 3
    x, k, _ = _case(3, b, n_in, cin, n_k, cout, card)
    gm = torch.randn((b, 64, 64, cout), device=card)
    runs = [(bw.transpose_conv2d_dx(gm, k, n_in, pad),
             *bw.transpose_conv2d_dw(x, gm, n_k, pad, with_db=True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_generator_grads_segregated_match_autograd(card):
    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device=card)
    z = torch.randn((4, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    r = torch.randn((4, 64, 64, cfg.layers[-1][2]),
                    generator=torch.Generator().manual_seed(2)).to(card)
    grads = {}
    for bwd in ("segregated", "autograd"):
        live = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
                for k, v in params.items()}
        plan = gan.generator_plan(cfg, 4, bwd=bwd)
        (gan.generator_apply(live, cfg, z, plan=plan, device=card) * r).sum().backward()
        grads[bwd] = {(k, n): t.grad for k, v in live.items() for n, t in v.items()}
    for key, want in grads["autograd"].items():
        _close(grads["segregated"][key], want)
