"""Card tests of the port: each CUDA kernel against its plain version (the
fused, per-phase, GEMM and dx kernels at shapes for each of their compiled
instances and copy widths), the fused, per-phase and GEMM kernels' rows equal
to unbatched calls bit for bit, dx on both sides of its layout boundary and
with unaligned operands, the dx and dw kernels that fold act' into their
staging bitwise the standalone epilogue-grad -> dx -> dw route (with an
unaligned y too), the generator's batch invariance (per layer and
through fused pairs), the latent projection's kernels (rows bitwise
independent of the batch, forward, dW and dz against float64, one launch a
generator call, a captured graph bitwise its eager calls), the RGB head's
kernels (EB-GAN's rows bitwise independent of the batch, forward, dx and dW
against float64, dx only where asked), and the
generator's gradients through the backward
kernels, fused pairs and the per-phase kernel, the decode attention kernel
at the LM shapes, and a decode step's independence of the other slots;
then the CUDA graphs of the main path (repro_torch.graphs): each kind of
executable (a generator per bucket, per layer and through pairs, the
sequential executables, the decode step, the training step with either
objective) bitwise equal to its eager call, the energy step's decoder taking
no dW in the generator's phase, the published EB-GAN served bitwise its
one-row calls, the launch counters counting replays, the lifetime of
the buffers a replay overwrites, and a failed capture raising; then the
operator zoo: every method name of ``transpose_conv2d`` at the paper's
Table-2 shapes and at every Table-4 layer against the tap-by-tap oracle,
the fused and per-phase kernels against their plain versions at the
Table-2 shapes, a kernel spelling past the kernels' largest kernel raising,
and the segregated dilated convolution; then, with tracing on, the
engine's replays counting exactly their eager launches, and a two-replica
supervisor's served outputs bitwise their unbatched calls; last, the
sharded paths on a one-rank NCCL host mesh (the generator, a sharded
replica's graphs, data-parallel training steps, the MoE's expert-parallel
path and its graphed decode step) against the unsharded ones, and a gloo
mesh refusing a CUDA trainer.
Every test is marked ``cuda`` and skips itself when no card is present.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.configs import get_config, reduced
from repro_torch.core import transpose_conv as tc
from repro_torch.core.dilated_conv import dilated_conv2d
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import project as proj
from repro_torch.kernels import ref
from repro_torch.kernels import rgb_head as head
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.kernels import transpose_conv2d_bwd as bw
from repro_torch.kernels import transpose_conv2d_gemm as tcg
from repro_torch.kernels import transpose_conv2d_pair as tcp
from repro_torch.models import gan
from repro_torch.models.lm import build_model
from repro_torch.tree import tree_leaves, tree_map

# cuBLAS sums in a fixed order only with a fixed workspace, which it reads
# when it starts: the training step's graph-against-eager test needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    (1, 8, 4, 2, 512, 256),    # DCGAN L1 at batch 1: Cin split
    (1, 32, 4, 2, 128, 3),     # DCGAN L3 at batch 1: poor layout, split
    (1, 64, 4, 2, 128, 64),    # EB-GAN L4
    (1, 128, 4, 2, 64, 64),    # EB-GAN L5
    (3, 6, 3, 1, 100, 70),     # 13 chunks in uneven splits, 4-byte copies
]
# Two shapes per instance of the fused kernel, (layout, R, d): n = 2R or
# 2R - 1, an odd and an even P, Cout <= 4 for the poor layout; Cin and Cout
# multiples of 4 or not, for each of its copy widths.
VARIANT_SHAPES = [(2, 3 + n, n, pad, cin, cout)
                  for n in (2, 4, 5, 7) for pad in (n - 1, n - 2)
                  for cin, cout in ((12, 6), (10, 8), (8, 4), (5, 3))]
SHAPES += VARIANT_SHAPES
# Two shapes per instance of the per-phase kernel, (layout, R, ks): n = 2R
# or 2R - 1 with an odd and an even P, on 6 x 6 inputs (rich ks = 1, and
# poor for Cout <= 4) and on 2 x 2 inputs (phase planes of at most 4 x 4:
# rich ks = 4); Cin and Cout multiples of 4 and not, for each copy width.
PHASE_VARIANT_SHAPES = (
    [(2, 6, n, pad, cin, cout) for n in (2, 4, 5, 7)
     for pad, (cin, cout) in ((n - 1, (12, 8)), (n - 2, (10, 6)),
                              (n - 1, (8, 4)), (n - 2, (5, 3)))]
    + [(2, 2, n, pad, cin, cout) for n, pads in ((2, (1, 0)), (4, (2, 3)))
       for pad, (cin, cout) in zip(pads, ((24, 8), (18, 6)))])
SHAPES += PHASE_VARIANT_SHAPES
# The implicit-GEMM kernel at bucket 1 (DCGAN L0: 17 splits, a warp past the
# batch), 4-byte input with 16-byte weight copies, and the poor dx layout
# with 16-byte gm pixels and dx stores at R = 2.
SHAPES += [(1, 4, 4, 2, 1024, 512), (3, 5, 4, 2, 30, 12), (2, 6, 4, 2, 12, 4)]
# dx with gm and the kernel as contiguous views 4 bytes into larger buffers:
# 4-byte copies at a Cout that is a multiple of 4 (the poor layout at Cout 4,
# the rich tile at Cout 8)
DX_UNALIGNED_SHAPES = [(2, 6, 4, 2, 12, 4), (2, 5, 3, 1, 9, 8)]
# A shape of each dx instance (rich; poor at R = 1-4) and each dw instance
# (rich and narrow tiles; poor at R = 1-4) for the fold of act' into their
# staging: DCGAN L0, L2 and L3 at batch 8, a ragged odd-M layer, and the
# poor layout at R = 1, 3, 4 and with 16-byte pixels at R = 2.
FOLD_SHAPES = [(8, 4, 4, 2, 1024, 512), (8, 16, 4, 2, 256, 128), (8, 32, 4, 2, 128, 3),
               (2, 7, 3, 0, 37, 19), (2, 5, 2, 1, 7, 3), (2, 6, 5, 2, 9, 4),
               (1, 9, 7, 3, 6, 2), (2, 6, 4, 2, 12, 4)]
# (N, n, P, Cin, Cout) of every zoo layer the plan sends to the GEMM kernel
ZOO_GEMM_LAYERS = [(4, 4, 2, 512, 256), (4, 4, 2, 1024, 512), (4, 4, 2, 2048, 1024)]
KERNELS = {
    "fused": (tcf.transpose_conv2d_fused, tcf.transpose_conv2d_fused_plain),
    "gemm": (tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain),
    "phase": (tcf.transpose_conv2d_phase, tcf.transpose_conv2d_phase_plain),
}
PAIR_SHAPES = [  # (B, N, n, P, C0, C1, C2)
    (8, 4, 4, 2, 1024, 512, 256),   # DCGAN L0-1
    (8, 16, 4, 2, 256, 128, 3),     # DCGAN L2-3
    (2, 5, 3, 1, 13, 21, 7),        # n = 3, odd P, C2 not a tile multiple
    (2, 7, 5, 3, 9, 12, 5),         # n = 5, odd P
    # with the rows above, one shape for each compiled (R, d) instance
    (2, 3, 2, 1, 8, 8, 8),          # R = 1, d = 0
    (2, 4, 2, 0, 6, 10, 5),         # R = 1, d = 1
    (1, 5, 6, 2, 10, 9, 7),         # R = 3, d = 1
    (1, 4, 8, 3, 6, 10, 4),         # R = 4, d = 0
    (1, 5, 7, 2, 5, 6, 3),          # R = 4, d = 1
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def offset_view(t, offset=1):
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    larger buffer, so its first element is not 16-byte aligned."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


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


# --------------------------------------------------------- the projection

# (K, N) of the latent projection: DCGAN, EB-GAN, and a ragged N (4-byte
# copies and column tails)
PROJECTION_WIDTHS = [(100, 16384), (100, 32768), (37, 70)]
PROJECTION_BATCHES = (1, 2, 7, 8, 64, 128)


def _projection_case(seed, b, k, n, device):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, k)).astype(np.float32)
    w = (0.02 * rng.standard_normal((k, n))).astype(np.float32)
    g = rng.standard_normal((b, n)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (z, w, g))


def _within(got, want):
    """Within 1e-4 * max|ref| + 1e-5 of a float64 reference."""
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.parametrize("width", PROJECTION_WIDTHS, ids=str)
def test_projection_rows_do_not_depend_on_the_batch(card, width):
    """Each row of the projection's forward at batch B is bitwise that row
    at batch 128, for every B a bucket or the training batch takes; a W
    4 bytes off alignment (4-byte copies) gives the same bits."""
    k, n = width
    z, w, _ = _projection_case(0, 128, k, n, card)
    full = proj.project_relu_fwd(z, w)
    for b in PROJECTION_BATCHES:
        assert torch.equal(proj.project_relu_fwd(z[:b], w), full[:b]), b
        assert torch.equal(proj.project_relu_fwd(z[:b].clone(), offset_view(w)), full[:b]), b


@pytest.mark.parametrize("b", [1, 7, 128])
@pytest.mark.parametrize("width", PROJECTION_WIDTHS, ids=str)
def test_projection_and_its_gradients_match_float64(card, width, b):
    """y, dW and dz against float64 products, within 1e-4 * max|ref| + 1e-5;
    a y and g 4 bytes off alignment give dW's bits."""
    k, n = width
    z, w, g = _projection_case(b + n, b, k, n, card)
    y = proj.project_relu_fwd(z, w)
    y64 = torch.relu(z.double() @ w.double())
    _within(y, y64)
    gm = torch.where(y <= 0, 0.0, g.double())
    dw = proj.project_relu_dw(z, y, g)
    _within(dw, z.double().t() @ gm)
    assert torch.equal(proj.project_relu_dw(z, offset_view(y), offset_view(g)), dw)
    _within(proj.project_relu_dz(w, y, g), gm @ w.double().t())
    torch.cuda.synchronize()


def test_projection_function_gradients(card):
    """The autograd function on the card: dW and dz of a scalar loss within
    tolerance of float64, dz only where z asks for it."""
    z, w, g = _projection_case(3, 8, 100, 16384, card)
    for want_dz in (False, True):
        zz, ww = z.clone().requires_grad_(want_dz), w.clone().requires_grad_()
        before = [f.launches for f in (proj.project_relu_fwd, proj.project_relu_dw,
                                       proj.project_relu_dz)]
        (gan.project(zz, ww) * g).sum().backward()
        after = [f.launches for f in (proj.project_relu_fwd, proj.project_relu_dw,
                                      proj.project_relu_dz)]
        assert [a - b for a, b in zip(after, before)] == [1, 1, int(want_dz)]
        gm = torch.where(z.double() @ w.double() <= 0, 0.0, g.double())
        _within(ww.grad, z.double().t() @ gm)
        if want_dz:
            _within(zz.grad, gm @ w.double().t())
        else:
            assert zz.grad is None


def test_projection_refuses_other_dtypes(card):
    z, w, _ = _projection_case(0, 2, 4, 8, card)
    with pytest.raises(TypeError):
        proj.project_relu_fwd(z.double(), w.double())


@pytest.mark.parametrize("b", [1, 8, 64])
def test_generator_call_launches_one_projection(card, b):
    """One forward launch of the projection a generator call, whatever the
    batch, read through the kernel counters."""
    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    z = torch.randn((b, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    _, counts = _counted(gan.generator_apply, params, cfg, z, device=card)
    slots = graphs.kernel_counters().slots
    got = {fn.__name__: n for (fn, name), n in zip(slots, counts) if name == "launches"}
    assert (got["project_relu_fwd"], got["project_relu_dw"], got["project_relu_dz"]) == (1, 0, 0)


# --------------------------------------------------------- the RGB head

HEAD_BUCKETS = (1, 8, 64)


def _head_case(seed, b, hw, k, c, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, k)).astype(np.float32)
    w = (rng.standard_normal((k, c)) * k ** -0.5).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, bias, g))


def test_rgb_head_rows_do_not_depend_on_the_batch(card):
    """EB-GAN's head (64 -> 3 over 256^2 pixels): each sample at buckets
    1, 8 and 64 bitwise that sample at batch 64, the last sample alone too."""
    x, w, b, _ = _head_case(0, 64, 256, 64, 3, card)
    full = head.rgb_head_fwd(x, w, b)
    for n in HEAD_BUCKETS:
        assert torch.equal(head.rgb_head_fwd(x[:n].clone(), w, b), full[:n]), n
    assert torch.equal(head.rgb_head_fwd(x[-1:].clone(), w, b), full[-1:])
    # an x 4 bytes off alignment (4-byte copies) gives the same bits
    assert torch.equal(head.rgb_head_fwd(offset_view(x[:8]), w, b), full[:8])


@pytest.mark.parametrize("shape", [(2, 256, 64, 3), (3, 17, 4, 3), (1, 5, 37, 2)],
                         ids=str)
def test_rgb_head_and_its_gradients_match_float64(card, shape):
    """y, dx, dW and db against float64, within 1e-4 * max|ref| + 1e-5, at
    EB-GAN's head, a narrow one and a ragged one (pixels not a whole tile,
    K over 32 and odd); dW's bits the same from an x off alignment."""
    b, hw, k, c = shape
    x, w, bias, g = _head_case(sum(shape), b, hw, k, c, card)
    y = head.rgb_head_fwd(x, w, bias)
    _within(y, torch.tanh(x.double() @ w.double() + bias.double()))
    gm = g.double() * (1 - y.double() ** 2)
    _within(head.rgb_head_dx(g, y, w), gm @ w.double().t())
    dw, db = head.rgb_head_dw(x, g, y)
    _within(dw, x.double().reshape(-1, k).t() @ gm.reshape(-1, c))
    _within(db, gm.reshape(-1, c).sum(0))
    dw4, db4 = head.rgb_head_dw(offset_view(x), g, y)
    assert torch.equal(dw4, dw) and torch.equal(db4, db)
    torch.cuda.synchronize()


def test_rgb_head_function_computes_dx_only_where_asked(card):
    """The autograd function: one forward launch, dW with its sum pass once,
    dx only where x needs a gradient; the gradients within tolerance of
    float64."""
    x, w, b, g = _head_case(5, 2, 32, 64, 3, card)
    fns = (head.rgb_head_fwd, head.rgb_head_dx, head.rgb_head_dw)
    for want_dx in (False, True):
        xx = x.clone().requires_grad_(want_dx)
        ww, bb = w.clone().requires_grad_(), b.clone().requires_grad_()
        before = [f.launches for f in fns] + [head.rgb_head_dw.reduce_launches]
        (gan.rgb_head(xx, ww, bb) * g).sum().backward()
        after = [f.launches for f in fns] + [head.rgb_head_dw.reduce_launches]
        assert [a - c for a, c in zip(after, before)] == [1, int(want_dx), 1, 1]
        y = torch.tanh(x.double() @ w.double() + b.double())
        gm = g.double() * (1 - y ** 2)
        _within(ww.grad, x.double().reshape(-1, 64).t() @ gm.reshape(-1, 3))
        _within(bb.grad, gm.reshape(-1, 3).sum(0))
        if want_dx:
            _within(xx.grad, gm @ w.double().t())
        else:
            assert xx.grad is None


def test_rgb_head_refuses_what_it_does_not_take(card):
    x, w, b, _ = _head_case(0, 1, 4, 65, 3, card)
    with pytest.raises(ValueError, match="input and"):
        head.rgb_head_fwd(x, w, b)
    with pytest.raises(TypeError):
        head.rgb_head_fwd(x[..., :64].double(), w[:64].double(), b.double())


def test_projection_graph_equals_eager_bitwise(card):
    """The forward and the whole backward (dW and dz) captured as one CUDA
    graph: bitwise the eager calls, each replay counting their launches."""
    z, w, g = _projection_case(5, 64, 100, 16384, card)

    def step(zz, gg):
        y = proj.project_relu_fwd(zz, w)
        return y, proj.project_relu_dw(zz, y, gg), proj.project_relu_dz(w, y, gg)

    want, eager = _counted(step, z, g)
    graph = graphs.CudaGraph(step, z, g)
    assert graph.launches == eager and sum(eager) == 3
    z2, _, g2 = _projection_case(6, 64, 100, 16384, card)
    want2 = step(z2, g2)
    for zz, gg, ref in ((z, g, want), (z2, g2, want2)):
        got, replayed = _counted(graph, zz, gg)
        assert replayed == eager
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("shape", [
    (8, 8, 4, 2, 512, 256),    # DCGAN L1
    (8, 16, 4, 2, 256, 128),   # DCGAN L2
    (8, 32, 4, 2, 128, 3),     # DCGAN L3
    (4, 6, 3, 1, 100, 70),     # uneven Cin splits, 4-byte copies
], ids=str)
def test_fused_kernel_rows_equal_unbatched_bitwise(card, shape):
    """Each batch row of the fused kernel equals its batch-1 call bit for
    bit: nothing that orders a sum depends on the batch."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    epi = EPILOGUES[2]
    batched = tcf.transpose_conv2d_fused(x, k, pad, epilogue=epi, bias=bias)
    for i in range(b):
        one = tcf.transpose_conv2d_fused(x[i : i + 1], k, pad, epilogue=epi,
                                         bias=bias)
        assert torch.equal(one[0], batched[i])


@pytest.mark.parametrize("shape", [
    (8, 4, 4, 2, 1024, 512),   # DCGAN L0: ks = 4, Cin split
    (8, 8, 4, 2, 512, 256),    # DCGAN L1
    (8, 16, 4, 2, 256, 128),   # DCGAN L2
    (8, 32, 4, 2, 128, 3),     # DCGAN L3: poor layout
], ids=str)
def test_phase_kernel_rows_equal_unbatched_bitwise(card, shape):
    """Each batch row of the per-phase kernel equals its batch-1 call bit
    for bit: its geometry reads the batch only in the grid."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    epi = EPILOGUES[2]
    batched = tcf.transpose_conv2d_phase(x, k, pad, epilogue=epi, bias=bias)
    for i in range(b):
        one = tcf.transpose_conv2d_phase(x[i : i + 1], k, pad, epilogue=epi,
                                         bias=bias)
        assert torch.equal(one[0], batched[i])


@pytest.mark.parametrize("layer", ZOO_GEMM_LAYERS, ids=str)
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_gemm_kernel_rows_equal_unbatched_bitwise(card, batch, layer):
    """Each batch row of the implicit-GEMM kernel equals its batch-1 call
    bit for bit at every zoo layer it serves: its splits and summation
    order read the layer's shape, never the batch."""
    n_in, n_k, pad, cin, cout = layer
    x, k, bias = _case(sum(layer) + batch, batch, n_in, cin, n_k, cout, card)
    epi = EPILOGUES[2]
    batched = tcg.transpose_conv2d_gemm(x, k, pad, epilogue=epi, bias=bias)
    for i in range(batch):
        one = tcg.transpose_conv2d_gemm(x[i : i + 1], k, pad, epilogue=epi, bias=bias)
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


def _three_kernel_route(x, k, g, y, epi, n_in, pad):
    """dx, dw and db through the standalone epilogue-grad kernel, then the
    dx and dw kernels on the gm it wrote."""
    gm = bw.epilogue_grad(g, y, epi)
    return (bw.transpose_conv2d_dx(gm, k, n_in, pad),
            *bw.transpose_conv2d_dw(x, gm, k.shape[0], pad, with_db=True))


def _folded_route(x, k, g, y, epi, n_in, pad):
    """dx, dw and db through the dx and dw kernels given g, y and epi."""
    return (bw.transpose_conv2d_dx(g, k, n_in, pad, y=y, epilogue=epi),
            *bw.transpose_conv2d_dw(x, g, k.shape[0], pad, with_db=True, y=y,
                                    epilogue=epi))


def _fold_inputs(card, shape, epi):
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    y = tcf.transpose_conv2d_fused(x, k, pad, epilogue=epi, bias=bias)
    g = torch.randn(y.shape, device=card,
                    generator=torch.Generator(device=card).manual_seed(7))
    return x, k, g, y


@pytest.mark.parametrize("epi", EPILOGUES[2:], ids=EPI_IDS[2:])
@pytest.mark.parametrize("shape", FOLD_SHAPES, ids=str)
def test_folded_dx_dw_db_bitwise_the_three_kernel_route(card, shape, epi):
    """dx and dw given g, y and the activation (act' applied as they stage
    g) give the bits of epilogue-grad -> dx -> dw, and launch no standalone
    epilogue-grad kernel: two folded launches."""
    n_in, pad = shape[1], shape[3]
    x, k, g, y = _fold_inputs(card, shape, epi)
    want = _three_kernel_route(x, k, g, y, epi, n_in, pad)
    before = (bw.epilogue_grad.launches, bw.epilogue_grad.folded_launches)
    got = _folded_route(x, k, g, y, epi, n_in, pad)
    torch.cuda.synchronize()
    assert (bw.epilogue_grad.launches, bw.epilogue_grad.folded_launches) == (
        before[0], before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the composer takes the folded route on the card
    before = bw.epilogue_grad.launches
    dx, dw, db = bw.transpose_conv2d_bwd(x, k, g, pad, epilogue=epi, y=y)
    torch.cuda.synchronize()
    assert bw.epilogue_grad.launches == before
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1]) and torch.equal(db, want[2])


@pytest.mark.parametrize("shape", DX_UNALIGNED_SHAPES, ids=str)
def test_folded_kernels_with_unaligned_y(card, shape):
    """A y that starts 4 bytes into its buffer takes the 4-byte copies of
    g and y in dx and dw, with the same bits as the three-kernel route."""
    n_in, pad = shape[1], shape[3]
    epi = EPILOGUES[3]
    x, k, g, y = _fold_inputs(card, shape, epi)
    yu = offset_view(y)
    assert bw.dx_copy_widths(g, k, y)[0] and not bw.dx_copy_widths(g, k, yu)[0]
    want = _three_kernel_route(x, k, g, y, epi, n_in, pad)
    got = _folded_route(x, k, g, yu, epi, n_in, pad)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.parametrize("shape", [
    (8, 32, 4, 2, 128, 3),     # DCGAN L3: poor dx, split poor dw
    (8, 4, 4, 2, 1024, 512),   # DCGAN L0: rich dx in 16 splits
    (8, 16, 4, 2, 256, 128),   # DCGAN L2: rich dx in 4 splits, split dw
    (2, 9, 7, 3, 10, 4),       # poor dx at R = 4, 16-byte gm pixels
], ids=str)
def test_backward_kernels_are_deterministic(card, shape):
    """Two runs of the dx and dw kernels (each dx layout, split and not)
    give the same bits."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, _ = _case(3, b, n_in, cin, n_k, cout, card)
    m = 2 * n_in - n_k + 2 * pad
    gm = torch.randn((b, m, m, cout), device=card)
    runs = [(bw.transpose_conv2d_dx(gm, k, n_in, pad),
             *bw.transpose_conv2d_dw(x, gm, n_k, pad, with_db=True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("cout", [3, 4, 5, 64])
def test_dx_kernel_across_the_layout_boundary(card, cout):
    """dx at Cout 3 and 4 (the poor layout, 4-byte and 16-byte gm pixels)
    and 5 and 64 (the rich tile), on a DCGAN L3-like 32 x 32 input, against
    its plain version."""
    b, n_in, n_k, pad, cin = 2, 32, 4, 2, 128
    _, k, _ = _case(cout, b, n_in, cin, n_k, cout, card)
    gm = torch.randn((b, 64, 64, cout), device=card,
                     generator=torch.Generator(device=card).manual_seed(cout))
    want_layout = "poor" if cout <= 4 else "rich"
    assert bw.bwd_geometry(b, n_in, n_k, pad, cin, cout).dx_layout == want_layout
    before = bw.transpose_conv2d_dx.launches
    got = bw.transpose_conv2d_dx(gm, k, n_in, pad)
    torch.cuda.synchronize()
    assert bw.transpose_conv2d_dx.launches == before + 1
    _close(got, bw.transpose_conv2d_dx_plain(gm, k, n_in, pad))


@pytest.mark.parametrize("shape", DX_UNALIGNED_SHAPES, ids=str)
def test_dx_kernel_with_unaligned_operands(card, shape):
    """dx with gm and the kernel at a 4-byte offset (4-byte copies where the
    aligned call makes 16-byte ones) against its plain version."""
    b, n_in, n_k, pad, cin, cout = shape
    _, k, _ = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    m = 2 * n_in - n_k + 2 * pad
    gm = torch.randn((b, m, m, cout), device=card,
                     generator=torch.Generator(device=card).manual_seed(cout))
    gu, ku = offset_view(gm), offset_view(k)
    assert bw.dx_copy_widths(gm, k)[0] and not bw.dx_copy_widths(gu, ku)[0]
    before = bw.transpose_conv2d_dx.launches
    got = bw.transpose_conv2d_dx(gu, ku, n_in, pad)
    torch.cuda.synchronize()
    assert bw.transpose_conv2d_dx.launches == before + 1
    _close(got, bw.transpose_conv2d_dx_plain(gm, k, n_in, pad))


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


def _pair_case(seed, shape, device):
    b, n_in, n_k, _, c0, c1, c2 = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, n_in, n_in, c0), (n_k, n_k, c0, c1), (n_k, n_k, c1, c2), (c1,), (c2,))]
    arrays[1] *= (n_k * n_k * c0) ** -0.5
    arrays[2] *= (n_k * n_k * c1) ** -0.5
    arrays[3] *= 0.1
    arrays[4] *= 0.1
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_pair_kernel_matches_plain_and_is_batch_invariant(card, shape):
    x, k1, k2, b1, b2 = _pair_case(sum(shape), shape, card)
    kw = dict(epilogue1=EPILOGUES[2], bias1=b1, epilogue2=EPILOGUES[3], bias2=b2)
    pad = shape[3]
    before = tcp.transpose_conv2d_pair.launches
    got = tcp.transpose_conv2d_pair(x, k1, k2, pad, **kw)
    want = tcp.transpose_conv2d_pair_plain(x, k1, k2, pad, **kw)
    one = tcp.transpose_conv2d_pair(x[:1], k1, k2, pad, **kw)
    torch.cuda.synchronize()
    assert tcp.transpose_conv2d_pair.launches == before + 2
    _close(got, want)
    assert torch.equal(one[0], got[0])


def test_pair_kernel_refuses_a_pair_over_budget(card):
    """EB-GAN's 64x64x128->64->64 tail pair needs more shared memory a
    block than an H100 block may have."""
    x, k1, k2, b1, b2 = _pair_case(0, (1, 64, 4, 2, 128, 64, 64), card)
    with pytest.raises(ValueError, match="shared memory"):
        tcp.transpose_conv2d_pair(x, k1, k2, 2, epilogue1=EPILOGUES[2],
                                  bias1=b1, epilogue2=EPILOGUES[2], bias2=b2)


def test_fused_generator_batch_invariant_and_close_to_per_layer(card):
    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device=card)
    z = torch.randn((8, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    batched = gan.generator_apply(params, cfg, z, device=card,
                                  plan=gan.generator_plan(cfg, 8, fuse="force"))
    one_plan = gan.generator_plan(cfg, 1, fuse="force")
    for i in range(8):
        one = gan.generator_apply(params, cfg, z[i : i + 1], device=card,
                                  plan=one_plan)
        assert torch.equal(one[0], batched[i])
    _close(batched, gan.generator_apply(params, cfg, z, device=card))


def test_generator_grads_through_pairs_and_phase_match_per_layer(card):
    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device=card)
    z = torch.randn((4, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    r = torch.randn((4, 64, 64, cfg.layers[-1][2]),
                    generator=torch.Generator().manual_seed(2)).to(card)
    plans = {"per_layer": gan.generator_plan(cfg, 4),
             "pair": gan.generator_plan(cfg, 4, fuse="force"),
             "phase": gan.generator_plan(cfg, 4, method="phase")}
    grads = {}
    for name, plan in plans.items():
        live = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
                for k, v in params.items()}
        (gan.generator_apply(live, cfg, z, plan=plan, device=card) * r).sum().backward()
        grads[name] = {(k, n): t.grad for k, v in live.items() for n, t in v.items()}
    for name in ("pair", "phase"):
        for key, want in grads["per_layer"].items():
            _close(grads[name][key], want)


DECODE_SHAPES = [  # (B, S, KV, G, hd): chip_smoke.py's decode check
    (8, 1024, 8, 4, 128),    # Llama-3-8B as chip_smoke.py serves it
    (8, 4096, 8, 4, 128),    # Llama-3-8B
    (8, 32768, 8, 4, 128),   # Llama-3-8B at decode_32k: 32 splits to combine
    (8, 4096, 2, 7, 64),     # Qwen2-0.5B
    (8, 4096, 4, 8, 128),    # Yi-9B
    (2, 1024, 32, 1, 128),   # CodeQwen1.5 (MHA)
    (3, 1000, 2, 3, 64),     # S not a multiple of the split
    (4, 40000, 2, 4, 64),    # 40 splits: a lane of the combine takes two
    (8, 1024, 8, 6, 128),    # DBRX as chip_smoke.py serves it (G 6)
    (8, 448, 20, 1, 64),     # Whisper's decoder self-attention, 448 rows
]


def _decode_case(seed, shape, dtype, device):
    """q, k, v and a kv_len holding 1, S and lengths off the split grid:
    one just past a split (inside a tile), one just past 32 splits (a lane
    of the combine takes two), one on a tile's edge."""
    b, s_len, kvh, g, hd = shape
    geo = da.decode_geometry(s_len, hd, g, dtype)
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=gen).to(device=device, dtype=dtype)
               for sh in ((b, kvh, g, hd), (b, s_len, kvh, hd), (b, s_len, kvh, hd)))
    lens = torch.randint(1, s_len + 1, (b,), generator=gen)
    lens[0] = 1
    lens[-1] = s_len
    special = [geo.split_len + 3, 32 * geo.split_len + 5, geo.split_len + 2 * geo.tile]
    for i, n in enumerate(special[: b - 2]):
        lens[1 + i] = min(n, s_len)
    return q, k, v, lens.to(device=device, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_decode_kernel_matches_plain(card, shape, dtype):
    """Within 1e-4 * max|ref| + 1e-5 for both dtypes: kernel and plain
    version compute in fp32 from the same inputs. One launch, and one
    combine launch when the cache spans more than one split."""
    q, k, v, kv_len = _decode_case(sum(shape), shape, dtype, card)
    launches = (da.decode_attention.launches, da.decode_attention.reduce_launches)
    got = da.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    splits = da.decode_geometry(shape[1], shape[4], shape[3], dtype).n_splits
    assert (da.decode_attention.launches - launches[0],
            da.decode_attention.reduce_launches - launches[1]) == (1, int(splits > 1))
    _close(got, da.decode_attention_ref(q, k, v, kv_len))


def test_decode_kernel_refuses_what_it_does_not_take(card):
    q, k, v, kv_len = _decode_case(0, (2, 300, 2, 4, 64), torch.bfloat16, card)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention(q, k, v, kv_len.long())
    with pytest.raises(TypeError, match="one dtype"):
        da.decode_attention(q.float(), k, v, kv_len)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, kv_len)
    with pytest.raises(ValueError, match="grouped queries"):
        da.decode_attention(q.repeat(1, 1, 3, 1), k, v, kv_len)
    with pytest.raises(ValueError, match="one CUDA device"):
        da.decode_attention(q, k, v, kv_len.cpu())


def test_decode_step_of_a_slot_ignores_the_other_slots(card):
    """A slot's logits and cache rows from one decode step are bitwise the
    same whatever the other slots hold (their cache rows, tokens and
    positions): the decode kernel's split count depends on S alone and
    every product has the same shape."""
    cfg = reduced(get_config("llama3-8b"))   # bf16, 2 layers
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    runs = []
    for other in range(2):
        cache = model.init_cache(4, 600, device=card)
        for c in cache:
            for t in c:
                t.copy_(torch.randn(t.shape, generator=gen, device=card))
        if other == 0:
            first = [[t[:, 0].clone() for t in c] for c in cache]
        else:
            for c, f in zip(cache, first):
                for t, f0 in zip(c, f):
                    t[:, 0] = f0
        tokens = torch.tensor([[5], [1 + other], [7 * other], [3]], device=card)
        pos = torch.tensor([520, 3 + other, 599 - 100 * other, 0], device=card)
        logits, cache = model.decode_step(params, cache, {"tokens": tokens, "pos": pos})
        runs.append((logits[0].clone(), [[t[:, 0].clone() for t in c] for c in cache]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------- CUDA graphs

@pytest.fixture
def deterministic(card):
    """Deterministic algorithms on (cuDNN's discriminator and cuBLAS), as a
    bit-exact training run needs them, and off again after the test."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    yield card
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def _counted(fn, *args, **kwargs):
    """``(result, counts added)``: the kernel counters across one call."""
    counters = graphs.kernel_counters()
    before = counters.read()
    out = fn(*args, **kwargs)
    return out, [a - b for a, b in zip(counters.read(), before)]


def test_kernel_graph_counts_its_replays(card):
    """A graph of one fused-kernel call (with its split pass): its output
    bitwise the eager call's, the warm-up counted as the launches it made,
    the capture as none, and each replay as one call's launches."""
    x, k, b = _case(0, 1, 8, 512, 4, 256, card)   # DCGAN L1 at batch 1: splits
    epi = EPILOGUES[2]
    want, eager = _counted(tcf.transpose_conv2d_fused, x, k, 2, epilogue=epi, bias=b)
    assert eager[:2] == [1, 1]   # the fused counters come first: one launch, one split pass
    graph, built = _counted(graphs.CudaGraph,
                            lambda xx: tcf.transpose_conv2d_fused(xx, k, 2, epilogue=epi,
                                                                  bias=b), x)
    assert built == eager and graph.launches == eager
    for _ in range(3):
        out, replayed = _counted(graph, x)
        assert replayed == eager
    assert torch.equal(out, want)


@pytest.mark.parametrize("fuse", ["off", "force"])
def test_engine_graphs_equal_eager_calls_bitwise(card, fuse):
    """Every bucket's executable, per layer and through pairs, is one graph
    in the model's pool: bitwise the eager call of its plan, counting the
    eager call's launches, and refusing parameters other than the
    registered ones."""
    from repro_torch.serve import BucketPolicy, GanEngine

    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    eng = GanEngine(BucketPolicy(buckets=(1, 2, 4, 8)), fuse=fuse)
    eng.register(cfg, params)
    eng.warmup()
    slot = eng.registry[cfg.name]
    assert slot.pool is not None and eng.metrics.recompiles == 4
    rng = np.random.default_rng(1)
    for bucket, fn in slot.apply.items():
        z = torch.from_numpy(rng.standard_normal((bucket, cfg.z_dim)).astype(np.float32))
        want, eager = _counted(gan.generator_apply, params, cfg, z,
                               plan=slot.plans[bucket], device=card)
        got, replayed = _counted(fn, params, z)
        assert torch.equal(got, want) and replayed == eager and any(eager)
        assert fn.graph.launches == eager
    with pytest.raises(ValueError, match="captured over its own params"):
        slot.apply[1](dict(params), torch.zeros((1, cfg.z_dim)))
    assert eng.metrics.recompiles == 4


def test_engine_serves_published_ebgan_bitwise_its_one_row_calls(card):
    """The published EB-GAN generator (RGB head included) at full width,
    served through the engine's bucket graphs: each request's image is
    bitwise its one-row call."""
    from repro_torch.serve import BucketPolicy, GanEngine, GenRequest

    cfg = gan.EBGAN_PUBLISHED
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    eng = GanEngine(BucketPolicy(buckets=(1, 8), max_wait_s=0.0))
    eng.register(cfg, params)
    eng.warmup()
    z = np.random.default_rng(3).standard_normal((8, cfg.z_dim)).astype(np.float32)
    reqs = [GenRequest(cfg.name, z[i : i + 1]) for i in range(8)]
    eng.serve(reqs)
    plan = eng.registry[cfg.name].plans[1]
    for i, r in enumerate(reqs):
        one = gan.generator_apply(params, cfg, z[i : i + 1], plan=plan, device=card)
        assert r.output.shape == (1, 256, 256, 3)
        assert torch.equal(r.output, one.cpu()), i


def test_generator_graph_output_lifetime(card):
    """The executable's output is the graph's buffer: the next call
    overwrites it, and a copy the caller took first keeps its bits."""
    from repro_torch.serve.gan_engine import sequential_executables

    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    fns = sequential_executables(cfg, params, [1, 3])
    z1, z2 = (torch.randn((3, cfg.z_dim), generator=torch.Generator().manual_seed(s))
              for s in (2, 3))
    out1 = fns[3](params, z1)
    kept = out1.cpu()
    out2 = fns[3](params, z2)
    assert out2 is out1
    assert torch.equal(kept, gan.generator_apply(params, cfg, z1).cpu())
    assert torch.equal(out2.cpu(), gan.generator_apply(params, cfg, z2).cpu())
    assert not torch.equal(kept, out2.cpu())
    with pytest.raises(ValueError, match="captured over its own params"):
        fns[1](gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card),
               z1[:1])


def _lm(card, slots=4, max_len=64):
    from repro_torch.serve import ServeEngine

    cfg = reduced(get_config("llama3-8b"))   # bf16, 2 layers
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card)
    return cfg, model, params, ServeEngine(model, params, slots=slots, max_len=max_len)


def test_decode_graph_equals_eager_step_bitwise(card):
    """One decode step through the engine's graph against model.decode_step
    on a copy of the cache: logits and written cache rows bitwise equal,
    n_layers decode launches a replay; the logits buffer is overwritten by
    the next step; other params or another cache raise."""
    from repro_torch.models import layers as L

    cfg, model, params, eng = _lm(card)
    gen = torch.Generator(device=card).manual_seed(1)
    for c in eng.cache:
        for t in c:
            t.copy_(torch.randn(t.shape, generator=gen, device=card))
    copy = [L.KVCache(c.k.clone(), c.v.clone()) for c in eng.cache]
    batch = {"tokens": torch.tensor([[5], [1], [9], [3]], dtype=torch.int32),
             "pos": torch.tensor([40, 3, 63, 0], dtype=torch.int32)}
    (got, cache), replayed = _counted(eng._decode, params, eng.cache, batch)
    assert cache is eng.cache
    want, _ = model.decode_step(params, copy, {k: v.to(card) for k, v in batch.items()})
    assert torch.equal(got, want)
    for c, w in zip(eng.cache, copy):
        assert torch.equal(c.k, w.k) and torch.equal(c.v, w.v)
    decode = {name: d for (fn, name), d in zip(graphs.kernel_counters().slots, replayed)
              if fn is da.decode_attention}
    assert decode["launches"] == cfg.n_layers and sum(replayed) == sum(decode.values())
    kept = got.clone()
    again, _ = eng._decode(params, eng.cache, {"tokens": batch["tokens"] + 1,
                                               "pos": batch["pos"]})
    assert again is got and not torch.equal(again, kept)
    with pytest.raises(ValueError, match="params"):
        eng._decode(dict(params), eng.cache, batch)
    with pytest.raises(ValueError, match="own cache"):
        eng._decode(params, copy, batch)


def test_decode_graph_serves_the_eager_engines_tokens(card):
    """The same requests through the graphed engine and through the same
    engine with its decode step swapped for the eager one: equal tokens."""
    from repro_torch.serve import Request

    cfg, model, params, eng = _lm(card)
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, cfg.vocab_size, size=int(n)).tolist(), int(m))
             for n, m in zip(rng.integers(2, 20, size=6), rng.integers(3, 12, size=6))]
    outs = []
    for decode in (eng._decode, model.decode_step):
        eng._decode = decode
        reqs = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
        eng.run(reqs)
        assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


class _NanAt:
    """Data whose batch is all NaN at the given step indices."""

    def __init__(self, data, steps):
        self.data, self.steps = data, set(steps)

    def batch(self, i):
        x = self.data.batch(i)
        return torch.full_like(x, float("nan")) if i in self.steps else x


def _trainer(card, nan_at=(), batch=4):
    from repro_torch.data import SyntheticImages
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cfg = gan.reduced_config(gan.DCGAN, 8)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2], batch,
                           device=card)
    return GanTrainer(cfg, GanTrainerConfig(global_batch=batch), _NanAt(data, nan_at),
                      log_fn=lambda *a: None)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_trainer_graph_steps_equal_eager_steps_bitwise(deterministic):
    """Three graphed steps against three eager ones from the same state:
    equal scalars and states bit for bit, the eager step's launches a
    replay, one capture; the returned state is the trainer's one buffer
    (an older state the caller kept must be cloned), and the caller's
    first state is copied in, never written."""
    tr = _trainer(deterministic)
    state0 = tr.init_state(torch.Generator().manual_seed(0))
    kept0 = tree_map(torch.clone, state0)
    eager_state, graph_state, buffers = state0, state0, set()
    for step in range(3):
        reals, zs = tr._batches(step)
        (eager_state, stats), eager = _counted(tr._step_eager, eager_state, reals, zs)
        before = tree_map(torch.clone, graph_state)
        (graph_state, metrics), replayed = _counted(tr._step_fn, graph_state, reals, zs)
        assert [metrics[k] for k in ("g_loss", "d_loss", "g_gnorm", "d_gnorm")] \
            == stats.tolist() and not metrics["skipped"]
        assert _equal_trees(graph_state, eager_state)
        if step:   # the first call also ran the warm-up
            assert replayed == eager and tr._graph.launches == eager
            assert not _equal_trees(before, graph_state)
        buffers.add(id(tree_leaves(graph_state)[0]))
    assert len(buffers) == 1 and tree_leaves(graph_state)[0] is \
        tree_leaves(tr._graph.inputs[0])[0]
    assert _equal_trees(state0, kept0)


def test_trainer_graph_nan_step_commits_nothing(deterministic):
    """A non-finite step replays the graph but copies nothing into the
    state buffer: the state is bitwise the one before it, and the next
    finite step commits again."""
    tr = _trainer(deterministic, nan_at=(1,))
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, m0 = tr._step_fn(state, *tr._batches(0))
    after0 = tree_map(torch.clone, state)
    state, m1 = tr._step_fn(state, *tr._batches(1))
    assert (m0["skipped"], m1["skipped"]) == (0, 1)
    assert _equal_trees(state, after0)
    state, m2 = tr._step_fn(state, *tr._batches(2))
    assert m2["skipped"] == 0 and not _equal_trees(state, after0)


def _energy_trainer(card, batch=4):
    from repro_torch.data import SyntheticImages
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cfg = gan.reduced_config(gan.EBGAN_PUBLISHED, 16)
    data = SyntheticImages(cfg.image_hw, cfg.image_channels, batch, device=card)
    tcfg = GanTrainerConfig(global_batch=batch, objective="energy", margin=0.4)
    return GanTrainer(cfg, tcfg, data, log_fn=lambda *a: None)


def test_energy_trainer_graph_steps_equal_eager_steps_bitwise(deterministic):
    """EB-GAN's step (auto-encoder discriminator, hinge, pulling-away term)
    at a sixteenth of the widths: three graphed steps bitwise three eager
    ones, the eight read-back values included, the eager step's launches a
    replay. The decoder takes dW in the discriminator's phase only: a step
    launches the generator's dW and the decoder's once, and dx for the
    decoder twice and the generator once."""
    from repro_torch.train.gan_trainer import ENERGY_STATS

    tr = _energy_trainer(deterministic)
    state0 = tr.init_state(torch.Generator().manual_seed(0))
    eager_state = graph_state = state0
    names = ("g_loss", "d_loss", "g_gnorm", "d_gnorm") + ENERGY_STATS
    for step in range(3):
        reals, zs = tr._batches(step)
        (eager_state, stats), eager = _counted(tr._step_eager, eager_state, reals, zs)
        (graph_state, metrics), replayed = _counted(tr._step_fn, graph_state, reals, zs)
        assert [metrics[k] for k in names] == stats.tolist() and not metrics["skipped"]
        assert _equal_trees(graph_state, eager_state)
        if step:
            assert replayed == eager and tr._graph.launches == eager
    slots = graphs.kernel_counters().slots
    got = {fn.__name__: n for (fn, name), n in zip(slots, eager) if name == "launches"}
    n_gen, n_dec = len(tr.cfg.layers), len(tr.dec_cfg.layers)
    assert got["transpose_conv2d_dw"] == n_gen + n_dec
    assert got["transpose_conv2d_dx"] == n_gen + 2 * n_dec
    assert (got["rgb_head_fwd"], got["rgb_head_dx"], got["rgb_head_dw"]) == (2, 1, 1)


def test_trainer_refuses_a_plan_replaced_after_capture(card):
    tr = _trainer(card)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr._step_fn(state, *tr._batches(0))
    tr.train_plan = gan.generator_plan(tr.cfg, tr.micro, bwd="autograd")
    with pytest.raises(ValueError, match="train_plan"):
        tr._step_fn(state, *tr._batches(1))


def _lm_trainer(card, **cfg_kw):
    from repro_torch.data import SyntheticTokens
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), **cfg_kw)
    model = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=30)
    state = init_train_state(model, torch.Generator(device=card).manual_seed(0), tc,
                             device=card)
    data = SyntheticTokens(cfg.vocab_size, 64, 2, device=card)
    return Trainer(model, make_train_step(model, tc), data, log_fn=lambda *a: None), state


@pytest.mark.parametrize("remat", [False, True])
def test_lm_graphed_train_step_is_bitwise_the_eager_step(card, remat):
    """Three graphed LM steps (one capture, under deterministic algorithms)
    against three eager ones from the same state: equal metrics, params and
    moments bit for bit; the caller's first state is copied in, never
    written; a non-finite step commits nothing."""
    tr, state = _lm_trainer(card, remat=remat)
    kept = tree_map(torch.clone, list(state))
    eager, graphed = state, state
    for step in range(3):
        batch = tr.data.batch(step)
        p, o, m = tr.step_eager(*eager, batch)
        eager = (p, o)
        gp, go, vals = tr._step_fn(*graphed, batch)
        graphed = (gp, go)
        assert vals == {k: float(v) for k, v in m.items()}
        assert _equal_trees([gp, go], [p, o])
    graph = tr._graph
    assert gp is graph.inputs[0] and _equal_trees(list(state), kept)
    with torch.no_grad():
        gp["embed"]["w"].fill_(float("nan"))
    poisoned = tree_map(torch.clone, [gp, go])
    gp, go, vals = tr._step_fn(gp, go, tr.data.batch(3))
    assert not math.isfinite(vals["loss"]) and tr._graph is graph
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    assert all(torch.equal(x.view(ints[x.element_size()]), y.view(ints[y.element_size()]))
               for x, y in zip(tree_leaves([gp, go]), tree_leaves(poisoned)))


def test_failed_capture_raises(card):
    """A function that reads a device value on the host cannot be captured:
    the graph raises, never runs it eagerly instead, and the card goes on
    working."""
    x = torch.ones(4, device=card)
    with pytest.raises(RuntimeError):
        graphs.CudaGraph(lambda t: t * t.sum().item(), x)
    assert (x + 1).sum().item() == 8.0


# ----------------------------------------------- observability and replicas

@pytest.fixture
def tracing():
    """Tracing on, into an isolated tracer; off again afterwards."""
    from repro_torch.obs import trace as obs

    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    obs.enable()
    yield tracer
    obs.disable()
    obs.set_tracer(prev)


def test_traced_engine_replays_count_the_eager_launches(card, tracing):
    """With tracing on, each bucket's batch replays its graph and counts
    exactly its eager call's launches: a span wraps the replay on the host
    and launches nothing; every timeline is complete and reconciles."""
    from repro_torch.serve import BucketPolicy, GanEngine, GenRequest

    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    eng = GanEngine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.0))
    eng.register(cfg, params)
    eng.warmup()
    rng = np.random.default_rng(2)
    for bucket in eng.policy.buckets:
        z = rng.standard_normal((bucket, cfg.z_dim)).astype(np.float32)
        _, eager = _counted(gan.generator_apply, params, cfg, z,
                            plan=eng.registry[cfg.name].plans[bucket], device=card)
        reqs = [GenRequest(cfg.name, z)]
        _, served = _counted(eng.serve, reqs)
        assert served == eager and any(eager)
        assert torch.equal(reqs[0].output, gan.generator_apply(params, cfg, z).cpu())
    assert eng.timeline.incomplete() == []
    assert eng.timeline.reconcile(eng.metrics.conservation())["ok"]
    names = tracing.span_names()
    assert all(names[n] == 4 for n in ("serve.pack", "serve.dispatch", "serve.slice",
                                       "serve.launch", "serve.sync", "serve.copy_out"))


def test_two_replica_supervisor_serves_unbatched_bits(card):
    """Two replicas on one card share the parameters but capture their own
    graphs in their own pools; every served output, a retried one after a
    NaN plane and the inline fallback's too, is bitwise its unbatched
    call; no replica builds after warm-up."""
    from repro_torch.serve import BucketPolicy, GenRequest, Replica, ReplicaSupervisor
    from repro_torch.serve.fault_injection import ServeFaultInjector, ServeFaultPlan

    cfg = gan.reduced_config(gan.DCGAN, 4)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    inj = ServeFaultInjector(ServeFaultPlan(nan_at=(("r1", 2),),
                                            crash_at=(("r0", 6), ("r1", 7))))
    replicas = [Replica(f"r{i}", dispatch_hook=inj.hook) for i in range(2)]
    # a frozen clock: no probe comes due and no dispatch times out, so the
    # routing is the same on every run
    sup = ReplicaSupervisor(replicas, BucketPolicy(buckets=(1, 2, 4, 8),
                                                   max_wait_s=0.0),
                            retry_budget=10, clock=lambda: 0.0)
    sup.register(cfg, params)
    sup.warmup()
    assert replicas[0].pool is not None and replicas[0].pool != replicas[1].pool
    warm = dict(sup.replica_recompiles)
    assert warm == {"r0": 4, "r1": 4} and sup.metrics.recompiles == 0
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(24):
        r = GenRequest(cfg.name, rng.standard_normal(
            (1 + i % 4, cfg.z_dim)).astype(np.float32))
        reqs.append(r)
        sup.serve([r])
    assert [f[0] for f in inj.fired] == ["nan", "crash", "crash"]
    assert all(r.done for r in reqs)
    assert {r.replica for r in reqs} == {"r0", "r1", "inline"}
    for r in reqs:
        assert torch.equal(r.output, gan.generator_apply(params, cfg, r.z).cpu())
    assert sup.replica_recompiles == warm
    assert sup.metrics.nonfinite == 1 and sup.metrics.degraded_batches >= 1
    assert sup.conservation()["ok"]


# ------------------------------------------------------------ operator zoo

# (B, N, n, P, Cin, Cout): the paper's Table 2 (224 x 224 x 3 images at
# batch 4, odd outputs M = 447 and 449 at n = 5 and 3), then every distinct
# Table-4 layer of the four GANs at batch 1
TABLE2_SHAPES = [(4, 224, n, 2, 3, 3) for n in (5, 4, 3)]
ZOO_SHAPES = sorted({(1, hw, cfg.kernel, cfg.padding, cin, cout)
                     for cfg in gan.GAN_ZOO.values()
                     for hw, cin, cout in cfg.layers})
ENTRY_NAMES = sorted(tc.METHODS) + sorted(tc.KERNEL_METHODS)


@pytest.mark.parametrize("shape", TABLE2_SHAPES + ZOO_SHAPES, ids=str)
@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_matches_conventional_ref(card, name, shape):
    """Every method name of the entry, with a bias and relu, within
    1e-4 * max|ref| + 1e-5 of the tap-by-tap oracle on the card."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    got = tc.transpose_conv2d(x, k, pad, method=name, bias=bias, act="relu")
    want = torch.relu(ref.conventional_ref(x, k, pad) + bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.parametrize("kernel", ["fused", "phase"])
@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("shape", TABLE2_SHAPES, ids=str)
def test_kernels_match_plain_at_table2_shapes(card, kernel, epi, shape):
    """Planes of 224 x 224 with 3 channels: the poor layouts, 4-byte
    copies, odd M."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _case(sum(shape), b, n_in, cin, n_k, cout, card)
    bias = bias if epi is not None else None
    launch, plain = KERNELS[kernel]
    got = launch(x, k, pad, epilogue=epi, bias=bias)
    want = plain(x, k, pad, epilogue=epi, bias=bias)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.parametrize("name", ["pallas", "pallas_fused", "pallas_phase"])
def test_kernel_spelling_past_the_largest_kernel_raises(card, name):
    """n = 10 (R = 5 > MAX_R): the kernel's wrapper raises; the entry does
    not give way to a baseline."""
    x, k, _ = _case(0, 1, 8, 4, 10, 4, card)
    with pytest.raises(ValueError, match="takes kernels up to"):
        tc.transpose_conv2d(x, k, 0, method=name)


def test_dilated_segregated_matches_conventional(card):
    x, k, _ = _case(1, 4, 224, 3, 3, 3, card)
    want = dilated_conv2d(x, k, method="conventional")
    got = dilated_conv2d(x, k, method="segregated")
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, 220, 220, 3)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5


def test_autotune_races_the_kernels_by_graph_replay(card, tmp_path, monkeypatch):
    """On the card the kernels race beside the baselines, each timed by a
    CUDA graph's replay; the serving choice is one method per layer for
    every bucket, and a ``fuse="auto"`` plan's batched samples are bitwise
    their batch-1 calls."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import plan as planlib

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.clear_cache(memory_only=True)
    cfg = gan.reduced_config(gan.DCGAN, 4)
    try:
        autotune.tune_gan_zoo(batches=(1, 2), configs=(cfg,), repeats=2)
        for (hw, cin, cout), epi in zip(cfg.layers, gan.generator_epilogues(cfg)):
            rec = autotune.best_entry(2, hw, cfg.kernel, cin, cout, cfg.padding,
                                      epilogue=epi)
            assert set(rec["fwd"]["candidates"]) == {
                *autotune.DEFAULT_CANDIDATES, "fused+postops"}
            assert all(t > 0 for t in rec["fwd"]["candidates"].values())
        plans = {b: gan.generator_plan(cfg, b) for b in (1, 2)}
        assert [lp.method for lp in plans[1]] == [lp.method for lp in plans[2]]
        assert {lp.source for lp in plans[2]} == {"tuned"}
        params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
        z = torch.randn((2, cfg.z_dim), device=card)
        both = gan.generator_apply(params, cfg, z, plan=plans[2])
        for i in range(2):
            one = gan.generator_apply(params, cfg, z[i : i + 1], plan=plans[1])
            assert torch.equal(both[i : i + 1], one)
        assert planlib.plan_follows_fuse(plans[2], "auto")
    finally:
        autotune.clear_cache(memory_only=True)


# ------------------------------------------------ the sharded paths, one card

@pytest.fixture(scope="module")
def host_mesh():
    """``make_host_mesh()``: a 1x1 (data, model) mesh over a one-rank NCCL
    group, made once for these tests and destroyed after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    owned = not dist.is_initialized()
    yield make_host_mesh()
    if owned:
        dist.destroy_process_group()


def _sharded_apply(cfg):
    def apply_fn(p, z, pl):
        return gan.generator_apply(p, cfg, z, plan=pl)
    return apply_fn


@pytest.mark.parametrize("fuse", ["off", "force"])
def test_sharded_generator_on_the_host_mesh_is_bitwise_unsharded(card, host_mesh, fuse):
    """shard_plan_apply on the one-rank NCCL mesh (enter, the generator,
    gather), per layer and through pairs: bitwise the unsharded call, with
    the same kernel launches (NCCL's are not counted)."""
    from repro_torch.distributed.sharding import shard_plan_apply

    cfg = gan.reduced_config(gan.DCGAN, 8)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    apply_fn = _sharded_apply(cfg)
    for bucket in (1, 8):
        plan = gan.generator_plan(cfg, bucket, fuse=fuse)
        z = torch.randn((bucket, cfg.z_dim), device=card)
        want, eager = _counted(apply_fn, params, z, plan)
        got, sharded = _counted(shard_plan_apply, apply_fn, params, z, plan, mesh=host_mesh)
        assert torch.equal(got, want) and sharded == eager


def test_sharded_replica_graphs_on_the_host_mesh(card, host_mesh):
    """Replica(shard=True, mesh=...): each bucket is one graph with the
    collectives inside, bitwise its eager sharded call and the unsharded
    replica's graph, counting the eager call's launches."""
    from repro_torch.distributed.sharding import shard_plan_apply
    from repro_torch.serve import Replica

    cfg = gan.reduced_config(gan.DCGAN, 8)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=card)
    sharded = Replica("dp", fuse="off", shard=True, mesh=host_mesh)
    plain = Replica("plain", fuse="off")
    for rep in (sharded, plain):
        rep.register(cfg, params)
        rep.warmup((1, 8))
    for bucket in (1, 8):
        z = torch.randn((bucket, cfg.z_dim), device=card)
        plan = sharded.registry[cfg.name].plans[bucket]
        want, eager = _counted(shard_plan_apply, _sharded_apply(cfg), params, z, plan,
                               mesh=host_mesh)
        fn = sharded._executable(cfg.name, bucket)
        got, replayed = _counted(fn, params, z)
        assert hasattr(fn, "graph") and replayed == eager
        assert torch.equal(got, want)
        assert torch.equal(plain._executable(cfg.name, bucket)(params, z), want)
    assert sharded.recompiles == 2


def test_data_parallel_trainer_on_the_host_mesh_is_bitwise_plain(deterministic, host_mesh):
    """GanTrainer(data_parallel=True) under the host mesh: three graphed
    steps (the region's collectives captured) bitwise the
    data_parallel=False trainer's, with equal launches."""
    from repro_torch.data import SyntheticImages
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cfg = gan.reduced_config(gan.DCGAN, 8)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2], 4,
                           device=deterministic)
    with use_mesh(host_mesh):
        dp = GanTrainer(cfg, GanTrainerConfig(global_batch=4), data, log_fn=lambda *a: None)
    plain = GanTrainer(cfg, GanTrainerConfig(global_batch=4, data_parallel=False), data,
                       log_fn=lambda *a: None)
    s_dp = dp.init_state(torch.Generator().manual_seed(0))
    s_pl = plain.init_state(torch.Generator().manual_seed(0))
    for step in range(3):
        reals, zs = dp._batches(step)
        with use_mesh(host_mesh):
            (s_dp, m_dp), c_dp = _counted(dp._step_fn, s_dp, reals, zs)
        (s_pl, m_pl), c_pl = _counted(plain._step_fn, s_pl, reals, zs)
        assert m_dp == m_pl and c_dp == c_pl and _equal_trees(s_dp, s_pl)
    with pytest.raises(ValueError, match="mesh changed"):
        dp._step_fn(s_dp, *dp._batches(3))   # captured under the mesh, called without


def test_gloo_mesh_refuses_a_cuda_trainer(card, host_mesh):
    """A CUDA graph captures NCCL collectives only: a CUDA trainer under a
    mesh over a gloo group raises at construction, and nothing runs
    eagerly instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data import SyntheticImages
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cuda",
                                 mesh_dim_names=("data",))
    cfg = gan.reduced_config(gan.DCGAN, 8)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2], 4, device=card)
    with use_mesh(mesh), pytest.raises(ValueError, match="NCCL"):
        GanTrainer(cfg, GanTrainerConfig(global_batch=4), data)


def test_expert_parallel_moe_on_the_host_mesh(card, host_mesh):
    """Reduced DBRX in fp32 (its FSDP gather on): the MoE's expert-parallel
    path on the host mesh within 1e-4 * max|ref| + 1e-5 of the no-mesh
    ``moe``, and ServeEngine's graphed decode step under the mesh bitwise
    the eager step."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import layers as L
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(reduced(get_config("dbrx-132b")), dtype="float32", fsdp=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card)
    p0 = tree_map(lambda t: t[0], params["layers"][0]["ffn"])
    x = torch.randn((2, 16, cfg.d_model), device=card) * 0.5
    want, _ = L.moe(p0, cfg, x)
    with use_mesh(host_mesh):
        assert L._moe_supported_by_shard_map(cfg, 2)
        got, _ = L.moe(p0, cfg, x)
        eng = ServeEngine(model, params, slots=4, max_len=32)
        tok = torch.randint(0, cfg.vocab_size, (4, 1), device=card, dtype=torch.int32)
        pos = torch.full((4,), 3, dtype=torch.int32, device=card)
        graphed = eng._decode(params, eng.cache, {"tokens": tok, "pos": pos})[0].clone()
        eager, _ = model.decode_step(params, eng.cache, {"tokens": tok, "pos": pos})
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
    assert torch.equal(graphed, eager)
