"""Port of the implicit-GEMM kernel (repro_torch.kernels.transpose_conv2d_gemm).

On the CPU: the plain version against the JAX package's Pallas GEMM kernel
in interpret mode (which runs under the installed JAX) across odd kernels,
odd paddings and every epilogue; the launch geometry (each parity's rows,
its own R x R taps, splits and summation order fixed by the shape at every
zoo layer the GEMM serves, batches 1-8); and an emulation of the CUDA
kernel (thread copies into the ring, dead warps, slices, splits and their
order) that must reproduce the same function, write every output once and
give each sample its unbatched bits. The card tests are in
``test_torch_cuda.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jepi
from repro.kernels import ref as jref
from repro.kernels.transpose_conv2d_gemm import transpose_conv2d_pallas_gemm
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import transpose_conv2d_gemm as tcg

EPILOGUES = [
    None,
    epilib.Epilogue(bias=True),
    epilib.Epilogue(bias=True, act="relu"),
    epilib.Epilogue(bias=True, act="tanh"),
    epilib.Epilogue(bias=True, act="leaky_relu", slope=0.2),
]
EPI_IDS = ["none", "b", "b+relu", "b+tanh", "b+leaky0.2"]


def _case(seed, b, n_in, cin, n_k, cout, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n_in, n_in, cin)).astype(dtype)
    k = rng.standard_normal((n_k, n_k, cin, cout)).astype(dtype)
    bias = rng.standard_normal((cout,)).astype(dtype)
    return x, k, bias


def _jax_epi(epi):
    if epi is None:
        return None
    return jepi.Epilogue(bias=epi.bias, act=epi.act, slope=epi.slope)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("n_k,pad,n_in", [(4, 2, 4), (3, 1, 5), (5, 3, 4),
                                          (3, 0, 3)])
def test_plain_matches_jax_gemm_kernel(epi, n_k, pad, n_in):
    x, k, bias = _case(n_k + pad + n_in, 2, n_in, 4, n_k, 6)
    tb = torch.from_numpy(bias) if epi is not None else None
    got = tcg.transpose_conv2d_gemm(
        torch.from_numpy(x), torch.from_numpy(k), pad, epilogue=epi, bias=tb
    ).numpy()
    want = transpose_conv2d_pallas_gemm(
        jnp.asarray(x), jnp.asarray(k), pad, interpret=True,
        epilogue=_jax_epi(epi), bias=jnp.asarray(bias) if tb is not None else None,
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- geometry

def row_decode(g, par, r):
    """The kernel's rows of parity ``par``: GEMM row ``r`` -> ``(b, oh, ow,
    valid)``; rows past the batch and the outputs past an odd ``M`` are
    not valid."""
    plane = g.hp * g.hp
    b, t, u = r // plane, r % plane // g.hp, r % g.hp
    oh, ow = 2 * t + par // 2, 2 * u + par % 2
    return b, oh, ow, (r < g.rows) & (oh < g.m) & (ow < g.m)


@pytest.mark.parametrize("b,n_in,n_k,pad", [
    (8, 4, 4, 2), (1, 4, 4, 2), (2, 7, 3, 0), (3, 5, 5, 1), (1, 3, 4, 3),
])
def test_row_order_is_a_bijection_onto_outputs(b, n_in, n_k, pad):
    """The four parities' rows cover every (b, oh, ow) exactly once; the
    rest of each parity's B*Hp*Hp rows (odd M) and of its last block are
    invalid."""
    g = tcg.gemm_geometry(b, n_in, n_k, pad, 3, 3)
    r = torch.arange(g.n_m * tcg.BLOCK_ROWS)
    flats = []
    for par in range(4):
        bb, oh, ow, ok = row_decode(g, par, r)
        assert torch.equal((oh[ok] % 2) * 2 + ow[ok] % 2,
                           torch.full_like(oh[ok], par))
        flats.append((bb[ok] * g.m + oh[ok]) * g.m + ow[ok])
    flat = torch.cat(flats)
    assert g.rows == b * g.hp * g.hp and flat.numel() == b * g.m * g.m
    assert torch.equal(torch.sort(flat).values, torch.arange(b * g.m * g.m))


def _zoo_gemm_layers():
    """(N, n, P, Cin, Cout) of every zoo generator layer the plan's cold rule
    sends to the GEMM kernel."""
    from repro_torch.kernels.plan import cold_method
    from repro_torch.models import gan

    out = set()
    for cfg in gan.GAN_ZOO.values():
        for n_in, cin, cout in cfg.layers:
            if cold_method(n_in, cfg.kernel, cfg.padding) == "gemm":
                out.add((n_in, cfg.kernel, cfg.padding, cin, cout))
    return sorted(out)


@pytest.mark.parametrize("layer", _zoo_gemm_layers(), ids=str)
def test_splits_and_order_do_not_depend_on_the_batch(layer):
    """At every zoo layer the GEMM serves, the split count and the fields
    that order each output's sum (taps, steps, splits and their step runs)
    are the same at batches 1-8; only the grid's row blocks grow. DCGAN
    L0's grid at batch 1 holds at least two blocks an SM."""
    n_in, n_k, pad, cin, cout = layer
    geos = [tcg.gemm_geometry(b, n_in, n_k, pad, cin, cout) for b in range(1, 9)]
    g1 = geos[0]
    for b, g in enumerate(geos, start=1):
        assert (g.r, g.cpt, g.n_steps, g.splits) == (g1.r, g1.cpt, g1.n_steps, g1.splits)
        assert [g.split_steps(s) for s in range(g.splits)] == [
            g1.split_steps(s) for s in range(g1.splits)]
        assert g.grid[1:] == g1.grid[1:]
        assert g.n_m == -(-b * g.hp * g.hp // tcg.BLOCK_ROWS)
    covered = [i for s in range(g1.splits) for i in g1.split_steps(s)]
    assert covered == list(range(g1.n_steps))
    assert min(len(g1.split_steps(s)) for s in range(g1.splits)) >= tcg.MIN_SPLIT_STEPS
    blocks_b1 = g1.grid[0] * g1.grid[1] * g1.grid[2]
    assert blocks_b1 >= tcg.MIN_BLOCKS or g1.splits == g1.n_steps // tcg.MIN_SPLIT_STEPS
    if layer == (4, 4, 2, 1024, 512):   # DCGAN L0
        assert (g1.splits, blocks_b1) == (17, 272)


def test_zoo_gemm_layers_are_the_head_layers():
    """The GEMM serves the zoo's head layers, and the card test's bitwise
    check runs at each of them."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        from test_torch_cuda import ZOO_GEMM_LAYERS
    finally:
        sys.path.remove(os.path.dirname(__file__))
    assert _zoo_gemm_layers() == [(4, 4, 2, 512, 256), (4, 4, 2, 1024, 512),
                                  (4, 4, 2, 2048, 1024)] == ZOO_GEMM_LAYERS


@pytest.mark.parametrize("b,n_in,n_k,pad", [
    (1, 4, 4, 2), (8, 4, 4, 2), (2, 7, 3, 0), (1, 6, 5, 1), (1, 5, 7, 3),
])
def test_blocks_walk_only_their_paritys_taps(b, n_in, n_k, pad):
    """A block of parity ``par`` walks R*R taps, those of its own sub-kernel
    ``wsels[par]``; every tap it walks is one that its rows read (or lies
    past an odd kernel, zero-filled), and across the four parities each
    HWIO tap is walked exactly once."""
    g = tcg.gemm_geometry(b, n_in, n_k, pad, 3, 3)
    walked = []
    for par in range(4):
        s = g.wsels[par]
        taps = {(2 * (st // g.cpt // g.r) + s // 2, 2 * (st // g.cpt % g.r) + s % 2)
                for st in range(g.n_steps)}
        assert len(taps) == g.r * g.r
        _, oh, ow, ok = row_decode(g, par, torch.arange(g.rows))
        for kh, kw in taps:
            if kh >= n_k or kw >= n_k:
                continue
            walked.append((kh, kw))
            _, vr = tcg.tap_source(n_in, pad, oh, kh)
            _, vc = tcg.tap_source(n_in, pad, ow, kw)
            # the tap's parity test holds for every row of the parity
            assert bool((vr | (oh + kh - pad < 0) | (oh + kh - pad >= 2 * n_in))[ok].all())
            assert bool((vc | (ow + kw - pad < 0) | (ow + kw - pad >= 2 * n_in))[ok].all())
    assert sorted(walked) == [(kh, kw) for kh in range(n_k) for kw in range(n_k)]


def test_tap_source_floors_only_even_nonnegative():
    o = torch.arange(2 * 3 - 3 + 2)
    for k in range(3):
        src, ok = tcg.tap_source(3, 1, o, k)
        a = o + k - 1
        want = (a >= 0) & (a % 2 == 0) & (a // 2 < 3)
        assert torch.equal(ok, want)
        assert torch.equal(src[ok], a[ok] // 2)


# ------------------------------------------- emulation of the CUDA kernel

def _gather(flat, idx, mask):
    """``flat[idx]`` where ``mask``, else 0; an unmasked index past the
    tensor raises IndexError, as a stray read would fault."""
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    if bool((safe < 0).any() | (safe >= flat.numel()).any()):
        raise IndexError("read past the tensor")
    return torch.where(mask, flat[safe], torch.zeros((), dtype=flat.dtype))


def _cp_quad(flat, start, n, vec=False):
    """``tconv::cp_quad`` for a vector of copies: 4 floats from ``start``
    of which ``n`` exist (zeros after; none read when ``n <= 0``). A 16-byte
    copy (``vec``) reads all 4 wherever ``n > 0``."""
    e = torch.arange(4)
    live = n[:, None] > 0 if vec else e[None, :] < n[:, None]
    return _gather(flat, start[:, None] + e, live.expand(-1, 4))


def emulate_gemm_kernel(x, kernel, padding, epi=None, bias=None):
    """What ``gemm_kernel`` (then ``reduce_splits_kernel``) computes, block
    by block, with its own integer arithmetic: each thread's copies into a
    STAGES-deep ring, the warps wholly past the batch skipped, each slice's
    8 x 8 tiles accumulated one contraction index at a time in the kernel's
    order (a product, then a sum: the order is what matters), the slices
    added in slice order, the splits in split order. Returns the output and
    the write count of every (split, b, oh, ow, co) slot."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = tcg.gemm_geometry(b_, n_in, n_k, padding, cin, cout)
    BM, BN, BK = tcg.BLOCK_ROWS, tcg.BLOCK_COUT, tcg.STEP_CIN
    KS, NT, ST = tcg.SLICES, tcg.THREADS, tcg.STAGES
    (org_r, org_c), plane = g.origins(), g.hp * g.hp
    xf, wf = x.reshape(-1), kernel.reshape(-1)
    part = torch.full((g.splits, b_, g.m, g.m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    tid = torch.arange(NT)
    for bx, by, par in itertools.product(*map(range, g.grid)):
        m0, split, co0 = bx * BM, by // g.n_co, (by % g.n_co) * BN
        pr, pc, s = par // 2, par % 2, g.wsels[par]
        ar = m0 + tid // 4                       # the input row a thread stages
        a_live = ar < g.rows
        a_b, a_t, a_u = ar // plane, ar % plane // g.hp, ar % g.hp
        lo = split * g.n_steps // g.splits
        nk = (split + 1) * g.n_steps // g.splits - lo
        ring = [None] * ST

        def stage(step, slot):
            tap, ci0 = step // g.cpt, step % g.cpt * BK
            p, q = tap // g.r, tap % g.r
            ih, iw = org_r[pr] + a_t + p, org_c[pc] + a_u + q
            ci = ci0 + 4 * (tid % 4)
            inb = a_live & (ih >= 0) & (ih < n_in) & (iw >= 0) & (iw < n_in)
            src = ((a_b * n_in + ih) * n_in + iw) * cin + ci
            a_st = torch.full((BM, BK), float("nan"), dtype=x.dtype)
            a_st.view(BM, 4, 4)[tid // 4, tid % 4] = _cp_quad(
                xf, src, torch.where(inb, cin - ci, 0), g.vx)
            kh, kw = 2 * p + s // 2, 2 * q + s % 2
            b_st = torch.full((BK, BN), float("nan"), dtype=x.dtype)
            co = co0 + 4 * (tid % 32)
            for j in range(BK * BN // 4 // NT):
                row = tid // 32 + NT // 32 * j
                inw = (kh < n_k) & (kw < n_k) & (ci0 + row < cin)
                wsrc = ((kh * n_k + kw) * cin + ci0 + row) * cout + co
                b_st.view(BK, BN // 4, 4)[row, tid % 32] = _cp_quad(
                    wf, wsrc, torch.where(inw, cout - co, 0), g.vw)
            assert not (a_st.isnan().any() or b_st.isnan().any())  # every slot staged
            ring[slot] = (a_st, b_st)

        acc = torch.zeros((KS, BM, BN), dtype=x.dtype)
        # warp w of a slice owns rows 16 (w % 2) ..: live iff its first row is
        live_rows = (m0 + torch.arange(BM) // 16 * 16) < g.rows
        for st in range(min(ST - 1, nk)):
            stage(lo + st, st)
        for k in range(nk):
            if k + ST - 1 < nk:
                assert (k + ST - 1) % ST != k % ST   # never the slot being read
                stage(lo + k + ST - 1, (k + ST - 1) % ST)
            a_st, b_st = ring[k % ST]
            for sl in range(KS):
                for kq in range(sl, BK // 4, KS):
                    for kk in range(4):
                        c = 4 * kq + kk
                        prod = a_st[:, c, None] * b_st[None, c, :]
                        acc[sl] += torch.where(live_rows[:, None], prod,
                                               torch.zeros((), dtype=x.dtype))
        v = acc[0]
        for sl in range(1, KS):
            v = v + acc[sl]
        r = m0 + torch.arange(BM)
        bb, oh, ow, ok = row_decode(g, par, r)
        cols = co0 + torch.arange(BN)
        ok_c = cols < cout
        part[split][bb[ok][:, None], oh[ok][:, None], ow[ok][:, None],
                    cols[ok_c][None, :]] = v[ok][:, ok_c]
        writes[split][bb[ok][:, None], oh[ok][:, None], ow[ok][:, None],
                      cols[ok_c][None, :]] += 1
    y = part[0]
    for z in range(1, g.splits):
        y = y + part[z]
    if epi is not None:
        y = epi.apply(y, bias if epi.bias else None)
    return y, writes


EMU_CASES = [   # (b, N, n, P, Cin, Cout, epilogue)
    (2, 4, 4, 2, 18, 3, EPILOGUES[4]),     # DCGAN L0 geometry, ragged Cin and Cout
    (1, 5, 3, 0, 3, 70, EPILOGUES[2]),     # odd M = 7, Cout % 4 != 0
    (1, 4, 5, 1, 2, 5, EPILOGUES[3]),      # n = 5, odd P: taps past the kernel
    (3, 3, 4, 3, 2, 4, EPILOGUES[1]),      # odd P, rows straddle blocks
    (1, 6, 3, 2, 2, 2, None),
    (1, 4, 4, 2, 64, 132, EPILOGUES[2]),   # batch 1: a dead warp, 2 Cout tiles, 16 splits
    (5, 3, 7, 3, 8, 8, EPILOGUES[3]),      # R = 4, 16-byte copies, 2 row blocks
]


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout,epi", EMU_CASES)
def test_emulated_kernel_matches_oracle(b, n_in, n_k, pad, cin, cout, epi):
    x, k, bias = _case(b * n_in + cout, b, n_in, cin, n_k, cout,
                       dtype=np.float64)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    got, writes = emulate_gemm_kernel(tx, tk, pad, epi, tb)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want = jref.conventional_ref(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(k, jnp.float32), pad)
    if epi is not None:
        want = _jax_epi(epi).apply(want, jnp.asarray(bias, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = tcg.transpose_conv2d_gemm_plain(tx, tk, pad, epilogue=epi,
                                            bias=tb if epi is not None else None)
    torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)


def test_emulated_cases_reach_the_designs_corners():
    """The emulated cases split the contraction, leave a warp past the
    batch, take several row and Cout blocks and both copy widths."""
    geos = [tcg.gemm_geometry(*c[:6]) for c in EMU_CASES]
    assert any(g.splits > 1 for g in geos) and any(g.splits == 1 for g in geos)
    assert any(g.rows % tcg.BLOCK_ROWS and g.rows % tcg.BLOCK_ROWS <= 16 for g in geos)
    assert any(g.n_m > 1 for g in geos) and any(g.n_co > 1 for g in geos)
    assert {(g.vx, g.vw) for g in geos} >= {(True, True), (False, False)}
    assert max(g.r for g in geos) == 4


@pytest.mark.parametrize("layer", [(4, 4, 2, 20, 6), (3, 3, 1, 5, 3)], ids=str)
def test_emulated_rows_equal_unbatched_bitwise(layer):
    """In fp32, each sample's rows of a batch-3 emulation equal its own
    batch-1 emulation bit for bit: folding images into a block's rows
    changes no output's sum."""
    n_in, n_k, pad, cin, cout = layer
    x, k, bias = _case(7, 3, n_in, cin, n_k, cout)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    batched, _ = emulate_gemm_kernel(tx, tk, pad, EPILOGUES[2], tb)
    for i in range(3):
        one, _ = emulate_gemm_kernel(tx[i : i + 1], tk, pad, EPILOGUES[2], tb)
        assert torch.equal(one[0], batched[i])


def test_card_shape_lists_reach_both_copy_widths():
    """The card test's SHAPES and chip_smoke.py's GEMM check shapes launch
    the kernel with 16-byte and 4-byte copies of the input and of the
    weights, split and unsplit, and at batch 1."""
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
        from test_torch_cuda import SHAPES
    finally:
        sys.path.remove(root)
    for shapes in (SHAPES, chip_smoke.GEMM_SHAPES):
        geos = [tcg.gemm_geometry(*s) for s in shapes]
        assert {(g.vx, g.vw) for g in geos} == {(True, True), (True, False),
                                                 (False, True), (False, False)}
        assert {g.splits > 1 for g in geos} == {True, False}
        assert any(g.batch == 1 and g.splits > 1 for g in geos)


def test_cpu_tensor_runs_plain_without_launching():
    before = tcg.transpose_conv2d_gemm.launches
    x, k, _ = _case(3, 1, 4, 2, 4, 2)
    tcg.transpose_conv2d_gemm(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert tcg.transpose_conv2d_gemm.launches == before
