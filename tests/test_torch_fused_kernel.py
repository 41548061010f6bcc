"""Port of the phase-fused kernel (repro_torch.kernels.transpose_conv2d).

On the CPU: the plain version against the JAX package's oracles and lax
form across geometries and every epilogue; the launch geometry of every
Table-4 layer at buckets 1-8 (fits the card, a summation order free of the
batch); each instance's copy partitions; and an emulation of the CUDA
kernel's index math (thread map, cp.async ring, register patches, output
tile, Cin splits and their second pass) that must reproduce the function
and write every output once.
The JAX package's own fused kernel cannot run under the installed JAX
(``pl.unblocked`` is gone), so it is not called. The card tests are in
``test_torch_cuda.py``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transpose_conv as jtc
from repro.kernels import epilogue as jepi
from repro.kernels import ref as jref
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.models import gan

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


@pytest.mark.parametrize("n_k,pad", [(n, p) for n in (2, 3, 4, 5)
                                     for p in range(n)] + [(3, 2)])
def test_plain_matches_jax_oracles(n_k, pad):
    x, k, _ = _case(n_k * 10 + pad, 2, 5, 3, n_k, 4)
    got = tcf.transpose_conv2d_fused_plain(torch.from_numpy(x),
                                           torch.from_numpy(k), pad).numpy()
    for oracle in (jref.unified_segregated_ref, jref.conventional_ref):
        want = np.asarray(jax.jit(oracle, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(k), pad))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("n_k,pad,n_in", [(4, 2, 4), (3, 1, 6), (5, 0, 5)])
def test_plain_epilogue_matches_jax_unified(epi, n_k, pad, n_in):
    x, k, bias = _case(7, 2, n_in, 6, n_k, 5)
    tb = torch.from_numpy(bias) if epi is not None else None
    got = tcf.transpose_conv2d_fused(
        torch.from_numpy(x), torch.from_numpy(k), pad, epilogue=epi, bias=tb
    ).numpy()
    want = jax.jit(jtc.transpose_conv_unified, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(k), pad)
    if epi is not None:
        want = _jax_epi(epi).apply(want, jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_phase_offsets_and_wsels(pad):
    """Odd padding swaps the sub-kernel roles (paper §3.4), and the phase
    origins are the ones the oracle's phase plans read."""
    from repro.core import segregation as jseg

    g = tcf.fused_geometry(1, 6, 4, pad, 2, 2)
    want_wsels = (0, 1, 2, 3) if pad % 2 == 0 else (3, 2, 1, 0)
    assert g.wsels == want_wsels
    plans, pad_lo, _ = jseg.plan_phases(6, 4, pad)
    assert g.pad_lo == pad_lo == pad // 2
    assert (g.base_r + g.roffs[0], g.base_r + g.roffs[1]) == (
        plans[0].row0, plans[2].row0)
    assert (g.base_c + g.coffs[0], g.base_c + g.coffs[1]) == (
        plans[0].col0, plans[1].col0)


def _zoo_layers():
    """(N, n, P, Cin, Cout) of every layer of the four Table-4 generators
    at full width."""
    return sorted({(hw, cfg.kernel, cfg.padding, cin, cout)
                   for cfg in gan.GAN_ZOO.values()
                   for hw, cin, cout in cfg.layers})


GEOMETRY_SHAPES = [  # (N, n, P, Cin, Cout) beside the zoo's
    (7, 3, 0, 37, 19),       # odd M = 11
    (6, 5, 1, 20, 70),       # n = 5, odd P
    (9, 7, 3, 5, 33),        # R = 4, odd P
    (9, 8, 4, 64, 64),       # R = 4, even P: the largest ring
    (9, 7, 2, 16, 3),        # R = 4, poor layout
]
BUCKETS = (1, 2, 4, 8)


@pytest.mark.parametrize("b", BUCKETS)
@pytest.mark.parametrize("n_in,n_k,pad,cin,cout", _zoo_layers() + GEOMETRY_SHAPES,
                         ids=str)
def test_geometry_covers_plane_and_fits(b, n_in, n_k, pad, cin, cout):
    g = tcf.fused_geometry(b, n_in, n_k, pad, cin, cout)
    lay = tcf.FUSED_LAYOUTS[g.layout]
    assert g.m == 2 * n_in - n_k + 2 * pad and g.hp == (g.m + 1) // 2
    assert g.roffs == g.coffs == (0, g.d) and g.d in (0, 1)
    assert (g.ncg, g.npg, g.tw) == (lay.ncg, lay.npg, lay.tw)
    assert g.th * g.tw == g.npg * tcf.FUSED_PW and g.tw % tcf.FUSED_PW == 0
    assert g.n_h * g.th >= g.hp and (g.n_h - 1) * g.th < g.hp
    assert g.n_w * g.tw >= g.hp and (g.n_w - 1) * g.tw < g.hp
    # the staged tile holds every row and column the register patches read
    assert g.xh == g.th - 1 + g.patch_rows == g.th + g.d + g.r - 1
    assert g.xw == g.tw - tcf.FUSED_PW + g.patch_cols == g.tw + g.d + g.r - 1
    assert g.x_pitch % 2 == 1 and g.xw <= g.x_pitch <= g.xw + 1
    assert g.ct == 4 * g.ncg and g.n_co * g.ct >= cout > (g.n_co - 1) * g.ct
    assert g.ci_chunk % 4 == 0 and g.n_chunks == -(-cin // g.ci_chunk)
    assert 1 <= g.splits <= min(g.n_chunks, tcf.MAX_SPLITS)
    assert all(len(g.split_chunks(s)) >= 1 for s in range(g.splits))
    assert sum(len(g.split_chunks(s)) for s in range(g.splits)) == g.n_chunks
    assert 128 <= g.threads <= 1024 and g.threads % 32 == 0   # >= 4 warps
    ring = g.stages * (g.ci_chunk * g.xh * g.x_pitch
                       + g.ci_chunk * 4 * g.r * g.r * g.ct)
    out_tile = 2 * g.th * 2 * g.tw * (g.ct + 4) + 4 * ((2 * g.tw - 1) >> 3)
    assert g.stages == tcf.FUSED_STAGES
    assert g.smem_bytes == 4 * max(ring, out_tile)
    assert g.smem_bytes <= tcf.SMEM_LIMIT == 232_448
    assert (g.vx, g.vw) == (cin % 4 == 0, cout % 4 == 0)
    assert g.grid == (g.n_h * g.n_w, g.splits * g.n_co, b)


@pytest.mark.parametrize("n_in,n_k,pad,cin,cout", _zoo_layers() + GEOMETRY_SHAPES,
                         ids=str)
def test_summation_order_does_not_depend_on_batch(n_in, n_k, pad, cin, cout):
    """Everything but the grid's batch axis -- variant, chunk, splits,
    hence each output's order of summation -- is a function of the shape."""
    g1 = tcf.fused_geometry(1, n_in, n_k, pad, cin, cout)
    for b in BUCKETS[1:]:
        g = tcf.fused_geometry(b, n_in, n_k, pad, cin, cout)
        assert g.summation_order == g1.summation_order
        assert g == dataclasses.replace(g1, batch=b)


def test_cout_tile_rule():
    """The layout, hence the Cout tile, follows Cout alone."""
    assert tcf.fused_geometry(8, 32, 4, 2, 128, 3).ct == 4        # Cout = 3
    assert tcf.fused_geometry(8, 32, 4, 2, 128, 3).layout == "poor"
    assert tcf.fused_geometry(8, 8, 4, 2, 512, 256).ct == 64
    assert tcf.fused_geometry(1, 8, 4, 2, 512, 256).ct == 64
    assert tcf.fused_geometry(64, 32, 4, 2, 64, 5).layout == "rich"


def test_cin_split_rule():
    """Splits double until an image holds SPLIT_TARGET blocks, each split
    keeps a chunk, and never pass MAX_SPLITS."""
    for n_in, n_k, pad, cin, cout in _zoo_layers():
        g = tcf.fused_geometry(8, n_in, n_k, pad, cin, cout)
        per_image = g.n_h * g.n_w * g.n_co
        if g.splits > 1:
            assert per_image * g.splits // 2 < tcf.SPLIT_TARGET
        assert (per_image * g.splits >= tcf.SPLIT_TARGET
                or 2 * g.splits > min(g.n_chunks, tcf.MAX_SPLITS))
    assert tcf.fused_geometry(1, 4, 4, 2, 7, 8).splits == 1   # one chunk


def test_variant_shapes_reach_every_variant():
    """The card tests' variant list launches every instance the geometry
    can choose."""
    from test_torch_cuda import VARIANT_SHAPES

    got = {tcf.fused_geometry(*s).variant for s in VARIANT_SHAPES}
    assert got == tcf.fused_variants() and len(got) == 16
    copies = {(g.vx, g.vw) for g in map(lambda s: tcf.fused_geometry(*s),
                                         VARIANT_SHAPES)}
    assert copies == {(a, b) for a in (False, True) for b in (False, True)}


# ------------------------------------------- emulation of the CUDA kernel

def _thread_map(g):
    """Each thread's channel group and first position (tile row, column),
    as the kernel derives them from its index."""
    tid = torch.arange(g.threads)
    lane, warp = tid % 32, tid // 32
    wcg = min(g.ncg, 4)
    wpg, cgw = 32 // wcg, g.ncg // wcg
    cg = lane // wpg + wcg * (warp % cgw)
    pg = lane % wpg + wpg * (warp // cgw)
    pairs = set(zip(cg.tolist(), pg.tolist()))
    assert pairs == set(itertools.product(range(g.ncg), range(g.npg)))
    pgr = g.tw // tcf.FUSED_PW
    return cg, pg // pgr, (pg % pgr) * tcf.FUSED_PW


def _stage(g, x, kernel, chunk, t0, u0, co0, bb):
    """One ring slot as the kernel's copies fill it: the halo tile
    [ci/4][row][pitch][4] (the pitch column beyond the staged ones is never
    written: NaN) and the weights [ci][s][p][q][ct], zero-filled past the
    input, the kernel, Cin and Cout."""
    n_in, cin = x.shape[1], x.shape[3]
    n_k, cout = kernel.shape[0], kernel.shape[3]
    ci0, CI, R = chunk * g.ci_chunk, g.ci_chunk, g.r
    xs = torch.full((CI // 4, g.xh, g.x_pitch, 4), float("nan"), dtype=x.dtype)
    rows = g.base_r - g.pad_lo + t0 + torch.arange(g.xh)
    cols = g.base_c - g.pad_lo + u0 + torch.arange(g.xw)
    vals = torch.zeros((g.xh, g.xw, CI), dtype=x.dtype)
    n_ci = max(0, min(CI, cin - ci0))
    ok = ((rows >= 0) & (rows < n_in))[:, None] & ((cols >= 0) & (cols < n_in))[None]
    src = x[bb][rows.clamp(0, n_in - 1)][:, cols.clamp(0, n_in - 1), ci0 : ci0 + n_ci]
    vals[..., :n_ci] = torch.where(ok[..., None], src, torch.zeros_like(src))
    xs[:, :, : g.xw, :] = vals.reshape(g.xh, g.xw, CI // 4, 4).permute(2, 0, 1, 3)
    ws = torch.zeros((CI, 4, R, R, g.ct), dtype=x.dtype)
    for s, p, q in itertools.product(range(4), range(R), range(R)):
        kh, kw = 2 * p + (s >> 1), 2 * q + (s & 1)
        if kh < n_k and kw < n_k:
            blk = kernel[kh, kw, ci0 : ci0 + CI, co0 : co0 + g.ct]
            ws[: blk.shape[0], s, p, q, : blk.shape[1]] = blk
    return chunk, xs, ws


def emulate_fused_kernel(x, kernel, padding, epi=None, bias=None, geometry=None):
    """What csrc/transpose_conv2d_fused.cu computes, block by block, with
    its own index arithmetic (threads vectorised): the thread map, the
    cp.async ring, each thread's register patch and micro-tile, the split
    partition and the split-ordered second pass. Unwritten outputs stay
    NaN; a patch read outside the staged tile raises IndexError or reads
    NaN. ``geometry`` overrides the launch geometry (e.g. its splits).
    Returns the output and per-element write counts of the output and of
    each split's partial sums."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = geometry or tcf.fused_geometry(b_, n_in, n_k, padding, cin, cout)
    R, D, PW, NS = g.r, g.d, tcf.FUSED_PW, g.stages
    cg, tr, tc = _thread_map(g)
    m = g.m
    out = torch.full((b_, m, m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros((b_, m, m, cout), dtype=torch.int64)
    part = torch.full((g.splits, b_, m, m, cout), float("nan"), dtype=x.dtype)
    pwrites = torch.zeros(part.shape, dtype=torch.int64)
    for bx, by, bb in itertools.product(range(g.n_h * g.n_w),
                                        range(g.splits * g.n_co), range(b_)):
        t0, u0 = (bx // g.n_w) * g.th, (bx % g.n_w) * g.tw
        split, co0 = by // g.n_co, (by % g.n_co) * g.ct
        chunks = g.split_chunks(split)
        nk = len(chunks)
        ring = [None] * NS
        for s in range(NS - 1):
            if s < nk:
                ring[s] = _stage(g, x, kernel, chunks[s], t0, u0, co0, bb)
        acc = torch.zeros((g.threads, 4, PW, 4), dtype=x.dtype)
        for k in range(nk):
            if k + NS - 1 < nk:   # refills the slot chunk k - 1 was read from
                assert (k + NS - 1) % NS != k % NS
                ring[(k + NS - 1) % NS] = _stage(g, x, kernel, chunks[k + NS - 1],
                                                 t0, u0, co0, bb)
            chunk, xs, ws = ring[k % NS]
            assert chunk == chunks[k]
            for c4 in range(g.ci_chunk // 4):
                for rho in range(g.patch_rows):
                    rows = tr + rho
                    cols = tc[:, None] + torch.arange(g.patch_cols)
                    if rows.max() >= g.xh or cols.max() >= g.xw:
                        raise IndexError("read past the staged tile")
                    xr = xs[c4, rows[:, None], cols]          # (threads, PC, 4)
                    for pr in range(2):
                        p = rho - pr * D
                        if not 0 <= p < R:
                            continue
                        for q, pc, cc in itertools.product(range(R), range(2),
                                                           range(4)):
                            par = 2 * pr + pc
                            wv = ws[4 * c4 + cc, g.wsels[par], p, q][
                                4 * cg[:, None] + torch.arange(4)]   # (threads, 4)
                            xv = xr[:, torch.arange(PW) + pc * D + q, cc]
                            acc[:, par] += xv[:, :, None] * wv[:, None, :]
        # the micro-tiles go to the [2 th][2 tw][ct] tile in shared memory,
        # each slot once; then the block writes (row, column, quad) in order
        tile = torch.full((2 * g.th, 2 * g.tw, g.ct), float("nan"), dtype=x.dtype)
        filled = torch.zeros(tile.shape, dtype=torch.int64)
        for par, j in itertools.product(range(4), range(PW)):
            r_, c_ = 2 * tr + (par >> 1), 2 * (tc + j) + (par & 1)
            ch = 4 * cg[:, None] + torch.arange(4)
            tile[r_[:, None], c_[:, None], ch] = acc[:, par, j]
            filled.index_put_((r_[:, None].expand_as(ch), c_[:, None].expand_as(ch), ch),
                              torch.ones_like(ch), accumulate=True)
        assert int(filled.min()) == int(filled.max()) == 1
        i = torch.arange(2 * g.th * 2 * g.tw * g.ncg)
        cq, oc, orow = i % g.ncg, i // g.ncg % (2 * g.tw), i // g.ncg // (2 * g.tw)
        for e in range(4):
            co = co0 + 4 * cq + e
            live = (2 * t0 + orow < m) & (2 * u0 + oc < m) & (co < cout)
            y = tile[orow[live], oc[live], (4 * cq + e)[live]]
            idx = ((2 * t0 + orow)[live], (2 * u0 + oc)[live], co[live])
            if g.splits > 1:
                part[split, bb][idx] = y
                pwrites[split, bb].index_put_(idx, torch.ones_like(idx[0]),
                                              accumulate=True)
                continue
            if epi is not None:
                y = epi.apply(y, bias[co[live]] if epi.bias else None)
            out[bb][idx] = y
            writes[bb].index_put_(idx, torch.ones_like(idx[0]), accumulate=True)
    if g.splits > 1:   # the second pass: splits in order, then the epilogue
        y = part[0]
        for s in range(1, g.splits):
            y = y + part[s]
        out = epi.apply(y, bias if epi.bias else None) if epi is not None else y
        writes = torch.ones_like(writes)
    return out, writes, pwrites


def _weight_copies(g):
    """The (channel, stacked tap, 16-byte piece) each thread's weight
    copies fill in a chunk, as the kernel's stage() assigns them."""
    R, NT, NCG, CI = g.r, g.threads, g.ncg, g.ci_chunk
    wrow, q = 4 * R * R, 4 * R * R * g.ncg
    out = []
    for tid in range(NT):
        if NT % q == 0:   # one (tap, piece) of every (NT / q)-th channel
            m = NT // q
            ci = tid // q
            if ci < CI:
                for j in range(CI // m if CI >= m else 1):
                    out.append((ci + j * m, tid // NCG % wrow, tid % NCG))
        else:
            for i in range(tid, CI * wrow * NCG, NT):
                out.append((i // NCG // wrow, i // NCG % wrow, i % NCG))
    return out


@pytest.mark.parametrize("layout,r", itertools.product(("rich", "poor"),
                                                       range(1, 5)))
def test_weight_copies_fill_each_piece_once(layout, r):
    cout = 64 if layout == "rich" else 3
    g = tcf.fused_geometry(1, 6, 2 * r, 0, 16, cout)
    assert (g.layout, g.r) == (layout, r)
    got = _weight_copies(g)
    want = itertools.product(range(g.ci_chunk), range(4 * r * r), range(g.ncg))
    assert sorted(got) == sorted(want)


def _input_copies(g):
    """The (channel group, row, column) of the staged tile each thread's
    input copies fill in a chunk, as stage() steps them: a fixed channel
    group, the pixel advancing NT / C4 at a time with one carry."""
    c4n, xw, step = g.ci_chunk // 4, g.xw, g.threads // (g.ci_chunk // 4)
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


@pytest.mark.parametrize("layout,r,pad", itertools.product(
    ("rich", "poor"), range(1, 5), (0, 1)))
def test_input_copies_fill_each_pixel_once(layout, r, pad):
    cout = 64 if layout == "rich" else 3
    g = tcf.fused_geometry(1, 6, 2 * r, pad, 16, cout)
    want = itertools.product(range(g.ci_chunk // 4), range(g.xh), range(g.xw))
    assert sorted(_input_copies(g)) == sorted(want)


def _ring_wraps(g):
    return any(len(g.split_chunks(s)) > g.stages for s in range(g.splits))


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout,epi,splits", [
    (2, 4, 4, 2, 5, 3, EPILOGUES[4], None),   # DCGAN geometry, poor, 4-byte
    (1, 7, 3, 0, 3, 19, EPILOGUES[2], None),  # odd M = 11, Cout % 4 != 0
    (1, 6, 5, 1, 17, 6, EPILOGUES[3], None),  # n = 5, odd P, R = 3 chunks of 4
    (1, 12, 4, 3, 2, 9, EPILOGUES[1], None),  # odd P, 2 x 2 spatial tiles
    (1, 9, 3, 2, 2, 40, None, None),          # n = 3, even P
    (2, 5, 4, 2, 24, 8, EPILOGUES[2], 2),     # rich, 16-byte, 3 chunks in 2 splits
    (1, 10, 4, 2, 16, 4, EPILOGUES[3], 2),    # poor, 16-byte, split
    (1, 5, 8, 4, 8, 12, EPILOGUES[1], None),  # R = 4, even P
    (1, 6, 4, 2, 44, 70, EPILOGUES[4], 1),    # one split of 6 chunks: the ring wraps
    (1, 5, 3, 1, 33, 5, EPILOGUES[2], 3),     # 5 chunks in 3 uneven splits
])
def test_emulated_kernel_matches_oracle(b, n_in, n_k, pad, cin, cout, epi, splits):
    x, k, bias = _case(b + n_in + cout, b, n_in, cin, n_k, cout,
                       dtype=np.float64)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    g = tcf.fused_geometry(b, n_in, n_k, pad, cin, cout)
    if splits is not None:
        g = dataclasses.replace(g, splits=splits)
    got, writes, pwrites = emulate_fused_kernel(tx, tk, pad, epi, tb, geometry=g)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    if g.splits > 1:
        assert int(pwrites.min()) == 1 and int(pwrites.max()) == 1
    want = jref.conventional_ref(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(k, jnp.float32), pad)
    if epi is not None:
        want = _jax_epi(epi).apply(want, jnp.asarray(bias, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_emulated_cases_reach_each_feature():
    """The emulator cases above reach the poor layout, 4- and 16-byte
    copies, R = 4, a split pass and a ring that wraps."""
    cases = test_emulated_kernel_matches_oracle.pytestmark[0].args[1]
    geos = []
    for b, n_in, n_k, pad, cin, cout, _, splits in cases:
        g = tcf.fused_geometry(b, n_in, n_k, pad, cin, cout)
        geos.append(dataclasses.replace(g, splits=splits) if splits else g)
    assert {g.layout for g in geos} == {"rich", "poor"}
    assert {(g.vx, g.vw) for g in geos} == {(a, b) for a in (0, 1) for b in (0, 1)}
    assert {g.d for g in geos} == {0, 1} and max(g.r for g in geos) == 4
    assert any(g.splits > 1 for g in geos) and any(map(_ring_wraps, geos))


def test_ptxas_report_reads_registers_and_spills():
    """chip_smoke reads each fused instance's registers and spills from
    nvcc's -Xptxas -v log with this parser."""
    from repro_torch.kernels import _build

    name = "_ZN12_GLOBAL__N_112fused_kernelILi16ELi16ELi8ELi8ELi2ELi1EEEvPKfS2_"
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers, 8 bytes "
           "cumulative stack size\n")
    rep = _build.ptxas_report(log)
    assert rep == {name: {"registers": 168, "stack": 8, "spill_stores": 4,
                          "spill_loads": 12}}
    assert _build.template_args(name.split("fused_kernelI", 1)[1]) == (
        16, 16, 8, 8, 2, 1)


# ------------------------------------------------------------- wrapper

def test_wrapper_checks_operands():
    x = torch.zeros((1, 4, 4, 3))
    k = torch.zeros((4, 4, 3, 2))
    with pytest.raises(ValueError, match="disagree"):
        tcf.transpose_conv2d_fused(x, k, 2, epilogue=EPILOGUES[1])
    with pytest.raises(ValueError, match="Cin"):
        tcf.transpose_conv2d_fused(x, torch.zeros((4, 4, 5, 2)), 2)
    with pytest.raises(ValueError, match="bias"):
        tcf.transpose_conv2d_fused(x, k, 2, epilogue=EPILOGUES[1],
                                   bias=torch.zeros(3))


def test_cpu_tensor_runs_plain_without_launching():
    before = (tcf.transpose_conv2d_fused.launches,
              tcf.transpose_conv2d_fused.reduce_launches)
    x, k, _ = _case(3, 1, 8, 64, 4, 16)   # a split shape
    assert tcf.fused_geometry(1, 8, 4, 2, 64, 16).splits > 1
    tcf.transpose_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert (tcf.transpose_conv2d_fused.launches,
            tcf.transpose_conv2d_fused.reduce_launches) == before

