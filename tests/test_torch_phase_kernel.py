"""Port of the per-phase kernel (``transpose_conv2d_phase`` in
repro_torch.kernels.transpose_conv2d) and of the ``phase`` plan method.

On the CPU: the plain version against the JAX package's own per-phase
Pallas kernel (which still interprets under the installed JAX) across
geometries and every epilogue; the launch geometry of every Table-4 layer
at batches 1-8 (batch-free but for the grid), its split rule, the card
list's reach over every compiled instance and the constants compiled into
the source; each instance's copy partitions; an emulation of the CUDA
kernel's index math (one parity a block, its own staged window and
sub-kernel, the thread map, cp.async ring, single-parity micro-tile, warp
slices, output tile, Cin splits and their second pass) that must reproduce
the same function and write every output once; the autograd Function's
gradients against
``jax.grad`` of the reference's phase op; and the phase-pinned generator's
gradients against the default plan's. The card tests are in
``test_torch_cuda.py``.
"""
import dataclasses
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jepi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import transpose_conv2d as jtcf
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import plan as planlib
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.models import gan

CSRC = Path(tcf.__file__).parent / "csrc"
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
    k = (rng.standard_normal((n_k, n_k, cin, cout))
         * (n_k * n_k * cin) ** -0.5).astype(dtype)
    bias = rng.standard_normal((cout,)).astype(dtype)
    return x, k, bias


def _jax_epi(epi):
    if epi is None:
        return None
    return jepi.Epilogue(bias=epi.bias, act=epi.act, slope=epi.slope)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("n_in,n_k,pad", [
    (4, 4, 2),    # DCGAN geometry
    (7, 3, 0),    # odd M = 11
    (6, 5, 1),    # n = 5, odd P
    (9, 3, 3),    # odd P, odd M
    (5, 2, 1),    # R = 1
])
def test_plain_matches_reference_phase_kernel(epi, n_in, n_k, pad):
    x, k, bias = _case(n_in * 10 + n_k, 2, n_in, 5, n_k, 6)
    tb = torch.from_numpy(bias) if epi is not None else None
    got = tcf.transpose_conv2d_phase(
        torch.from_numpy(x), torch.from_numpy(k), pad, epilogue=epi, bias=tb
    ).numpy()
    want = jtcf.transpose_conv2d_pallas_phase(
        jnp.asarray(x), jnp.asarray(k), pad, epilogue=_jax_epi(epi),
        bias=jnp.asarray(bias) if epi is not None else None,
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_phase_origins_and_wsels(pad):
    from repro.core import segregation as jseg

    g = tcf.phase_geometry(1, 6, 4, pad, 2, 2)
    assert g.wsels == ((0, 1, 2, 3) if pad % 2 == 0 else (3, 2, 1, 0))
    plans, pad_lo, _ = jseg.plan_phases(6, 4, pad)
    assert g.pad_lo == pad_lo
    assert g.row0s == (plans[0].row0, plans[2].row0)
    assert g.col0s == (plans[0].col0, plans[1].col0)
    assert g.origins() == (tuple(v - pad_lo for v in g.row0s),
                           tuple(v - pad_lo for v in g.col0s))


def _zoo_layers():
    """(N, n, P, Cin, Cout) of every layer of the four Table-4 generators
    at full width."""
    return sorted({(hw, cfg.kernel, cfg.padding, cin, cout)
                   for cfg in gan.GAN_ZOO.values()
                   for hw, cin, cout in cfg.layers})


GEOMETRY_SHAPES = [  # (N, n, P, Cin, Cout) beside the zoo's
    (7, 3, 0, 37, 19),       # odd M = 11
    (9, 7, 3, 5, 33),        # R = 4
    (2, 4, 3, 30, 70),       # a 3 x 3 plane: ks = 4
    (9, 7, 2, 16, 3),        # R = 4, poor layout
]
BUCKETS = (1, 2, 4, 8)


@pytest.mark.parametrize("b", BUCKETS)
@pytest.mark.parametrize("n_in,n_k,pad,cin,cout", _zoo_layers() + GEOMETRY_SHAPES,
                         ids=str)
def test_geometry_covers_plane_and_fits(b, n_in, n_k, pad, cin, cout):
    g = tcf.phase_geometry(b, n_in, n_k, pad, cin, cout)
    lay = tcf.PHASE_LAYOUTS[g.layout]
    assert g.m == 2 * n_in - n_k + 2 * pad and g.hp == (g.m + 1) // 2
    assert g.layout == ("poor" if cout <= tcf.POOR_MAX_COUT else "rich")
    assert g.ks == (4 if g.layout == "rich" and g.hp <= tcf.PHASE_PH
                    and g.r <= tcf.PHASE_KS_MAX_R else 1)
    assert (g.ncg, g.threads) == (lay.ncg, lay.threads) and g.threads % 32 == 0
    # the position groups of a block tile the (th, tw) tile exactly
    npg = g.threads // g.ncg // g.ks
    assert g.tw == tcf.FUSED_PW * lay.pgw(g.ks)
    assert g.th * g.tw == npg * tcf.FUSED_PW * tcf.PHASE_PH
    assert g.n_h * g.th >= g.hp and (g.n_h - 1) * g.th < g.hp
    assert g.n_w * g.tw >= g.hp and (g.n_w - 1) * g.tw < g.hp
    # the staged window holds every row and column the patches read
    assert (g.xh, g.xw) == (g.th + g.r - 1, g.tw + g.r - 1)
    assert g.x_pitch == g.xw + (g.xw - 1) // 4
    assert g.ct == 4 * g.ncg and g.n_co * g.ct >= cout > (g.n_co - 1) * g.ct
    assert g.ci_chunk == lay.ci_chunk(g.r, g.ks) and g.ci_chunk % (4 * g.ks) == 0
    assert g.n_chunks == -(-cin // g.ci_chunk)
    assert 1 <= g.splits <= min(g.n_chunks, tcf.MAX_SPLITS)
    assert sum(len(g.split_chunks(s)) for s in range(g.splits)) == g.n_chunks
    assert all(len(g.split_chunks(s)) >= 1 for s in range(g.splits))
    ring = g.stages * (g.ci_chunk * g.xh * g.x_pitch + g.ci_chunk * g.r * g.r * g.ct)
    out_tile = g.ks * g.th * (g.tw + (g.tw - 1) // 4) * g.ct
    assert g.stages == tcf.PHASE_STAGES
    assert g.smem_bytes == 4 * max(ring, out_tile) <= tcf.SMEM_LIMIT
    assert (g.vx, g.vw) == (cin % 4 == 0, cout % 4 == 0)
    assert g.grid == (g.n_h * g.n_w, g.splits * g.n_co, 4 * b)
    assert g.variant in tcf.phase_variants()


@pytest.mark.parametrize("n_in,n_k,pad,cin,cout", _zoo_layers() + GEOMETRY_SHAPES,
                         ids=str)
def test_geometry_does_not_depend_on_batch(n_in, n_k, pad, cin, cout):
    """Every field but the grid's batch axis -- instance, tiles, Cout tile,
    chunk, splits, hence each output's order of summation -- is a function
    of the shape (the simple kernel's Cout tile read the batch)."""
    g1 = tcf.phase_geometry(1, n_in, n_k, pad, cin, cout)
    for b in range(2, 9):
        g = tcf.phase_geometry(b, n_in, n_k, pad, cin, cout)
        assert g.summation_order == g1.summation_order
        assert g == dataclasses.replace(g1, batch=b)


def test_split_rule():
    """Splits double until an image's four parities hold
    PHASE_SPLIT_TARGET blocks, each split keeps a chunk, and never pass
    MAX_SPLITS."""
    for n_in, n_k, pad, cin, cout in _zoo_layers():
        g = tcf.phase_geometry(8, n_in, n_k, pad, cin, cout)
        per_image = 4 * g.n_h * g.n_w * g.n_co
        if g.splits > 1:
            assert per_image * g.splits // 2 < tcf.PHASE_SPLIT_TARGET
        assert (per_image * g.splits >= tcf.PHASE_SPLIT_TARGET
                or 2 * g.splits > min(g.n_chunks, tcf.MAX_SPLITS))
    assert tcf.phase_geometry(1, 4, 4, 2, 7, 8).splits == 1   # one chunk


def test_variant_shapes_reach_every_variant():
    """The card tests' per-phase list launches every compiled instance with
    both copy widths."""
    from test_torch_cuda import PHASE_VARIANT_SHAPES

    geos = [tcf.phase_geometry(*s) for s in PHASE_VARIANT_SHAPES]
    assert {g.variant for g in geos} == tcf.phase_variants()
    assert len(tcf.phase_variants()) == 10
    for v in tcf.phase_variants():
        widths = {(g.vx, g.vw) for g in geos if g.variant == v}
        assert widths == {(True, True), (False, False)}, v


def test_python_constants_match_the_kernel_source():
    """The layouts, chunks, ring depth and micro-tile compiled into the
    CUDA source are the ones phase_geometry assumes."""
    src = (CSRC / "transpose_conv2d_phase.cu").read_text()
    hdr = (CSRC / "tconv_microkernel.cuh").read_text()
    rich, poor = tcf.PHASE_LAYOUTS["rich"], tcf.PHASE_LAYOUTS["poor"]
    assert f"constexpr int kStages = {tcf.PHASE_STAGES};" in src
    assert (f"NT = L == 0 ? {rich.threads} : {poor.threads};") in src
    assert (f"NCG = L == 0 ? {rich.ncg} : {poor.ncg};") in src
    assert "CI = L == 1 ? 4 : KS == 4 ? 16 : R <= 2 ? 8 : 4;" in src
    assert "PGW = L == 0 ? (KS == 1 ? 2 : 1) : 8;" in src
    assert f"constexpr int kPH = {tcf.PHASE_PH};" in hdr
    assert f"constexpr int kPW = {tcf.FUSED_PW};" in hdr
    assert "return c + (c >> 2);" in hdr and tcf._skew(9) == 11
    for (lay, r, ks) in tcf.phase_variants():
        assert f"launch<{tcf.PHASE_LAYOUTS[lay].code}, {r}, {ks}>(l)" in src
    assert "transpose_conv2d_pallas_phase" in src   # names the TPU kernel


# ------------------------------------------- emulation of the CUDA kernel

def _phase_thread_map(g):
    """Each thread's channel group, warp slice and position group (row,
    column of groups), as the kernel derives them from its index."""
    tid = torch.arange(g.threads)
    cg = tid % g.ncg
    ksl = tid // g.ncg % g.ks
    pg = tid // g.ncg // g.ks
    npg = g.threads // g.ncg // g.ks
    trip = set(zip(cg.tolist(), ksl.tolist(), pg.tolist()))
    assert trip == set(itertools.product(range(g.ncg), range(g.ks), range(npg)))
    pgw = tcf.PHASE_LAYOUTS[g.layout].pgw(g.ks)
    return cg, ksl, pg // pgw, pg % pgw


def _skewed(c):
    return c + (c >> 2)


def _phase_stage(g, x, kernel, chunk, gr0, gc0, s, co0, bb):
    """One ring slot as the kernel's copies fill it: the parity's window
    [ci/4][row][skewed col][4] (the skew's gap columns are never written:
    NaN) and its one sub-kernel's weights [ci][p][q][ct], zero-filled past
    the input, the kernel, Cin and Cout."""
    n_in, cin = x.shape[1], x.shape[3]
    n_k, cout = kernel.shape[0], kernel.shape[3]
    CI, R = g.ci_chunk, g.r
    ci0 = chunk * CI
    xs = torch.full((CI // 4, g.xh, g.x_pitch, 4), float("nan"), dtype=x.dtype)
    rows = gr0 + torch.arange(g.xh)
    cols = gc0 + torch.arange(g.xw)
    n_ci = max(0, min(CI, cin - ci0))
    vals = torch.zeros((g.xh, g.xw, CI), dtype=x.dtype)
    ok = ((rows >= 0) & (rows < n_in))[:, None] & ((cols >= 0) & (cols < n_in))[None]
    src = x[bb][rows.clamp(0, n_in - 1)][:, cols.clamp(0, n_in - 1), ci0 : ci0 + n_ci]
    vals[..., :n_ci] = torch.where(ok[..., None], src, torch.zeros_like(src))
    xs[:, :, _skewed(torch.arange(g.xw)), :] = (
        vals.reshape(g.xh, g.xw, CI // 4, 4).permute(2, 0, 1, 3))
    ws = torch.zeros((CI, R, R, g.ct), dtype=x.dtype)
    for p, q in itertools.product(range(R), range(R)):
        kh, kw = 2 * p + (s >> 1), 2 * q + (s & 1)
        if kh < n_k and kw < n_k:
            blk = kernel[kh, kw, ci0 : ci0 + CI, co0 : co0 + g.ct]
            ws[: blk.shape[0], p, q, : blk.shape[1]] = blk
    return chunk, xs, ws


def emulate_phase_kernel(x, kernel, padding, epi=None, bias=None, geometry=None):
    """What csrc/transpose_conv2d_phase.cu computes, block by block, with
    its own index arithmetic (threads vectorised): the thread map, the
    cp.async ring, each thread's single-parity micro-tile (mac_p1: tap row
    outer, weights held, output rows walked), the warp slices of each chunk,
    the skewed output tile and its slice sums, the split partition and the
    split-ordered second pass. Unwritten outputs stay NaN; a patch read
    outside the staged window raises IndexError or reads NaN. ``geometry``
    overrides the launch geometry (e.g. its splits). Returns the output and
    per-element write counts of the output and of each split's partial
    sums."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = geometry or tcf.phase_geometry(b_, n_in, n_k, padding, cin, cout)
    R, PW, PH, NS = g.r, tcf.FUSED_PW, tcf.PHASE_PH, g.stages
    PC = PW + R - 1
    cg, ksl, pgr, pgc = _phase_thread_map(g)
    org_r, org_c = g.origins()
    m = g.m
    out = torch.full((b_, m, m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros((b_, m, m, cout), dtype=torch.int64)
    part = torch.full((g.splits, b_, m, m, cout), float("nan"), dtype=x.dtype)
    pwrites = torch.zeros(part.shape, dtype=torch.int64)
    owp = _skewed(g.tw - 1) + 1
    for bx, by, bz in itertools.product(range(g.n_h * g.n_w),
                                        range(g.splits * g.n_co), range(4 * b_)):
        t0, u0 = (bx // g.n_w) * g.th, (bx % g.n_w) * g.tw
        split, co0 = by // g.n_co, (by % g.n_co) * g.ct
        bb, par = bz >> 2, bz & 3
        pr, pc, s = par >> 1, par & 1, g.wsels[par]
        gr0, gc0 = org_r[pr] + t0, org_c[pc] + u0
        live = (t0 + PH * pgr < g.hp) & (u0 + PW * pgc < g.hp)
        chunks = g.split_chunks(split)
        nk = len(chunks)
        ring = [None] * NS
        for st in range(NS - 1):
            if st < nk:
                ring[st] = _phase_stage(g, x, kernel, chunks[st], gr0, gc0, s, co0, bb)
        acc = torch.zeros((g.threads, PH, PW, 4), dtype=x.dtype)
        for k in range(nk):
            if k + NS - 1 < nk:   # refills the slot chunk k - 1 was read from
                assert (k + NS - 1) % NS != k % NS
                ring[(k + NS - 1) % NS] = _phase_stage(
                    g, x, kernel, chunks[k + NS - 1], gr0, gc0, s, co0, bb)
            chunk, xs, ws = ring[k % NS]
            assert chunk == chunks[k]
            for sl in range(g.ks):
                th_ = torch.nonzero(live & (ksl == sl)).flatten()
                for c4 in range(sl, g.ci_chunk // 4, g.ks):
                    for p in range(R):
                        # the 4 R weight float4s of tap row p, in registers
                        wq = torch.stack([torch.stack([
                            ws[4 * c4 + cc, p, q][4 * cg[th_, None] + torch.arange(4)]
                            for cc in range(4)], 1) for q in range(R)], 1)
                        for tr in range(PH):
                            row = PH * pgr[th_] + tr + p
                            cols = _skewed(PW * pgc[th_, None] + torch.arange(PC))
                            if th_.numel() and (row.max() >= g.xh
                                                or cols.max() >= g.x_pitch):
                                raise IndexError("read past the staged window")
                            xr = xs[c4, row[:, None], cols]      # (threads, PC, 4)
                            for q, cc in itertools.product(range(R), range(4)):
                                xv = xr[:, torch.arange(PW) + q, cc]
                                acc[th_, tr] += xv[:, :, None] * wq[:, q, cc, None, :]
        # the micro-tiles go to the [ks][th][skewed tw][ct] tile, each slot
        # once; then the block writes (row, column, quad) in order, the
        # slices added in order
        tile = torch.full((g.ks, g.th, owp, g.ct), float("nan"), dtype=x.dtype)
        filled = torch.zeros(tile.shape, dtype=torch.int64)
        for tr, j in itertools.product(range(PH), range(PW)):
            r_ = (PH * pgr + tr)[:, None]
            c_ = _skewed(PW * pgc + j)[:, None]
            ch = 4 * cg[:, None] + torch.arange(4)
            sl_ = ksl[:, None].expand_as(ch)
            tile[sl_, r_.expand_as(ch), c_.expand_as(ch), ch] = acc[:, tr, j]
            filled.index_put_((sl_, r_.expand_as(ch), c_.expand_as(ch), ch),
                              torch.ones_like(ch), accumulate=True)
        cols = _skewed(torch.arange(g.tw))
        assert int(filled[:, :, cols].min()) == int(filled[:, :, cols].max()) == 1
        i = torch.arange(g.th * g.tw * g.ncg)
        cq, oc, orow = i % g.ncg, i // g.ncg % g.tw, i // g.ncg // g.tw
        oh, ow = 2 * (t0 + orow) + pr, 2 * (u0 + oc) + pc
        for e in range(4):
            co = co0 + 4 * cq + e
            ok = (oh < m) & (ow < m) & (co < cout)
            y = tile[0, orow[ok], _skewed(oc[ok]), (4 * cq + e)[ok]]
            for sl in range(1, g.ks):
                y = y + tile[sl, orow[ok], _skewed(oc[ok]), (4 * cq + e)[ok]]
            idx = (oh[ok], ow[ok], co[ok])
            if g.splits > 1:
                part[split, bb][idx] = y
                pwrites[split, bb].index_put_(idx, torch.ones_like(idx[0]),
                                              accumulate=True)
                continue
            if epi is not None:
                y = epi.apply(y, bias[co[ok]] if epi.bias else None)
            out[bb][idx] = y
            writes[bb].index_put_(idx, torch.ones_like(idx[0]), accumulate=True)
    if g.splits > 1:   # the second pass: splits in order, then the epilogue
        y = part[0]
        for sp in range(1, g.splits):
            y = y + part[sp]
        out = epi.apply(y, bias if epi.bias else None) if epi is not None else y
        writes = torch.ones_like(writes)
    return out, writes, pwrites


def _ring_wraps(g):
    return any(len(g.split_chunks(s)) > g.stages for s in range(g.splits))


EMULATED = [  # (b, N, n, P, Cin, Cout, epilogue, splits or None)
    (2, 4, 4, 2, 5, 3, EPILOGUES[4], None),     # DCGAN geometry, poor, 4-byte
    (1, 7, 3, 0, 3, 19, EPILOGUES[2], None),    # odd M = 11, Cout % 4 != 0
    (1, 6, 5, 1, 17, 6, EPILOGUES[3], None),    # n = 5, odd P, R = 3 chunks of 4
    (1, 12, 4, 3, 2, 9, EPILOGUES[1], None),    # odd P, 2 x 2 spatial tiles
    (1, 9, 3, 2, 2, 140, None, None),           # n = 3, even P, two Cout tiles
    (2, 4, 4, 2, 40, 8, EPILOGUES[2], None),    # a 4 x 4 plane: ks = 4, 16-byte, split
    (1, 3, 2, 1, 36, 12, EPILOGUES[4], 1),      # ks = 4, R = 1, one split of 3 chunks
    (1, 10, 4, 2, 16, 4, EPILOGUES[3], 2),      # poor, 16-byte, split
    (1, 5, 8, 4, 8, 12, EPILOGUES[1], None),    # R = 4, even P
    (1, 6, 4, 2, 44, 70, EPILOGUES[4], 1),      # one split of 6 chunks: the ring wraps
    (1, 5, 3, 1, 33, 5, EPILOGUES[2], 3),       # 5 chunks in 3 uneven splits
    (1, 5, 2, 0, 7, 8, None, None),             # R = 1, ks = 1
]


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout,epi,splits", EMULATED)
def test_emulated_kernel_matches_oracle(b, n_in, n_k, pad, cin, cout, epi, splits):
    x, k, bias = _case(b + n_in + cout, b, n_in, cin, n_k, cout,
                       dtype=np.float64)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    g = tcf.phase_geometry(b, n_in, n_k, pad, cin, cout)
    if splits is not None:
        g = dataclasses.replace(g, splits=splits)
    got, writes, pwrites = emulate_phase_kernel(tx, tk, pad, epi, tb, geometry=g)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    if g.splits > 1:
        assert int(pwrites.min()) == 1 and int(pwrites.max()) == 1
    want = jref.conventional_ref(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(k, jnp.float32), pad)
    if epi is not None:
        want = _jax_epi(epi).apply(want, jnp.asarray(bias, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = tcf.transpose_conv2d_phase_plain(tx, tk, pad, epilogue=epi,
                                             bias=tb if epi else None)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_emulated_cases_reach_each_feature():
    """The emulator cases above reach both layouts, both warp roles (ks 1
    and 4), 4- and 16-byte copies, R = 1 to 4, a split pass and a ring that
    wraps."""
    geos = []
    for b, n_in, n_k, pad, cin, cout, _, splits in EMULATED:
        g = tcf.phase_geometry(b, n_in, n_k, pad, cin, cout)
        geos.append(dataclasses.replace(g, splits=splits) if splits else g)
    assert {g.layout for g in geos} == {"rich", "poor"}
    assert {g.ks for g in geos} == {1, 4}
    assert {(g.vx, g.vw) for g in geos} == {(a, b) for a in (0, 1) for b in (0, 1)}
    assert {g.r for g in geos} == {1, 2, 3, 4}
    assert any(g.splits > 1 for g in geos) and any(map(_ring_wraps, geos))


def _input_copies(g):
    """The (channel group, row, column) of the window each thread's input
    copies fill in a chunk, as stage() steps them: a fixed channel group,
    the pixel advancing NT / C4 at a time with one carry."""
    c4n, xw = g.ci_chunk // 4, g.xw
    step = g.threads // c4n
    out = []
    for tid in range(g.threads):
        c4, r, c = tid % c4n, tid // c4n // xw, tid // c4n % xw
        while r < g.xh:
            if c >= xw:
                c, r = c - xw, r + 1
                if r >= g.xh:
                    break
            out.append((c4, r, c))
            r, c = r + step // xw, c + step % xw
    return out


def _weight_copies(g):
    """The (row = (ci, p, q), 16-byte piece) each thread's weight copies
    fill in a chunk: a fixed piece, the row advancing NT / NCG at a time."""
    rows = g.ci_chunk * g.r * g.r
    return [(row, tid % g.ncg) for tid in range(g.threads)
            for row in range(tid // g.ncg, rows, g.threads // g.ncg)]


@pytest.mark.parametrize("variant", sorted(tcf.phase_variants()), ids=str)
def test_copies_fill_each_slot_once(variant):
    from test_torch_cuda import PHASE_VARIANT_SHAPES

    g = next(g for g in map(lambda s: tcf.phase_geometry(*s), PHASE_VARIANT_SHAPES)
             if g.variant == variant)
    assert g.threads % (g.ci_chunk // 4) == 0
    want = itertools.product(range(g.ci_chunk // 4), range(g.xh), range(g.xw))
    assert sorted(_input_copies(g)) == sorted(want)
    want = itertools.product(range(g.ci_chunk * g.r * g.r), range(g.ncg))
    assert sorted(_weight_copies(g)) == sorted(want)


# ------------------------------------------------------------- wrapper

def test_wrapper_checks_operands():
    x = torch.zeros((1, 4, 4, 3))
    k = torch.zeros((4, 4, 3, 2))
    with pytest.raises(ValueError, match="disagree"):
        tcf.transpose_conv2d_phase(x, k, 2, epilogue=EPILOGUES[1])
    with pytest.raises(ValueError, match="Cin"):
        tcf.transpose_conv2d_phase(x, torch.zeros((4, 4, 5, 2)), 2)


def test_cpu_tensor_runs_plain_without_launching():
    before = (tcf.transpose_conv2d_phase.launches,
              tcf.transpose_conv2d_phase.reduce_launches)
    x, k, _ = _case(3, 1, 4, 64, 4, 16)   # a split shape
    assert tcf.phase_geometry(1, 4, 4, 2, 64, 16).splits > 1
    tcf.transpose_conv2d_phase(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert (tcf.transpose_conv2d_phase.launches,
            tcf.transpose_conv2d_phase.reduce_launches) == before


# ---------------------------------------------------- plan and gradients

def test_phase_is_pinned_only():
    """The cold rule never picks the per-phase kernel; pinning does."""
    for n_in in (1, 2, 4, 8, 16, 32, 64):
        assert planlib.plan_layer(2, n_in, 4, 8, 8, 2).method != "phase"
    lp = planlib.plan_layer(2, 8, 4, 8, 8, 2, method="phase")
    assert (lp.method, lp.source) == ("phase", "pinned")


@pytest.mark.parametrize("epi", EPILOGUES[1:], ids=EPI_IDS[1:])
def test_phase_fn_gradients_match_jax_reference(epi):
    """``execute_layer`` of a ``phase`` plan (the kernel's plain version on
    the CPU, the segregated backward) against ``jax.grad`` of the
    reference's phase op with its lax backward."""
    x, k, bias = _case(11, 2, 5, 4, 4, 3)
    rng = np.random.default_rng(12)
    r = rng.standard_normal((2, 10, 10, 3)).astype(np.float32)
    lp = planlib.plan_layer(2, 5, 4, 4, 3, 2, method="phase", epilogue=epi)
    tx, tk, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias))
    (planlib.execute_layer(lp, tx, tk, bias=tb) * torch.from_numpy(r)).sum().backward()

    def loss(xx, kk, bb):
        y = jops.transpose_conv2d_pallas_phase(xx, kk, 2, "lax", _jax_epi(epi), bb)
        return jnp.sum(y * r)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(bias))
    for got, w in zip((tx.grad, tk.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_phase_generator_gradients_match_default_plan():
    """The reduced DCGAN generator's parameter gradients through a plan
    pinned to ``phase`` and through the default (cold-rule) plan."""
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((2, cfg.z_dim)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(
        (2, 64, 64, cfg.layers[-1][2])).astype(np.float32))
    grads = {}
    for method in ("phase", "auto"):
        live = {k: {n: t.detach().clone().requires_grad_(True)
                    for n, t in v.items()} for k, v in params.items()}
        plan = gan.generator_plan(cfg, 2, method=method)
        (gan.generator_apply(live, cfg, z, plan=plan, device="cpu") * r).sum().backward()
        grads[method] = {f"{k}.{n}": t.grad for k, v in live.items()
                         for n, t in v.items()}
    assert {lp.method for lp in gan.generator_plan(cfg, 2, method="phase")} == {"phase"}
    for key, want in grads["auto"].items():
        got = grads["phase"][key]
        tol = 1e-5 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= tol, key
