"""Port of the segregated backward (repro_torch.kernels.transpose_conv2d_bwd
and repro_torch.kernels.ops).

On the CPU: the plain versions of the three kernels against the JAX
package (its epilogue-grad Pallas kernel in interpret mode; ``jax.vjp`` of
``transpose_conv_unified`` composed with ``Epilogue.apply`` for dx, dw and
db -- the reference's own dx and dw Pallas kernels cannot run under the
installed JAX, whose Pallas lacks ``pl.unblocked``); the autograd Functions
by ``gradcheck`` and against ``jax.grad`` of the reference's custom VJP;
and emulations of the dx and dw CUDA kernels' block-level index math, which
must give the same function and write every output exactly once. The card
tests are in ``test_torch_cuda.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transpose_conv as jtc
from repro.kernels import epilogue as jepi
from repro.kernels import ops as jops
from repro.kernels import transpose_conv2d_bwd as jbwd
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import ops
from repro_torch.kernels import plan as planlib
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.kernels import transpose_conv2d_bwd as bw
from test_torch_gemm_kernel import _cp_quad, _gather

EPILOGUES = [
    None,
    epilib.Epilogue(bias=True),
    epilib.Epilogue(bias=True, act="relu"),
    epilib.Epilogue(bias=True, act="tanh"),
    epilib.Epilogue(bias=True, act="leaky_relu", slope=0.2),
]
EPI_IDS = ["none", "b", "b+relu", "b+tanh", "b+leaky0.2"]


def _jax_epi(epi):
    if epi is None:
        return None
    return jepi.Epilogue(bias=epi.bias, act=epi.act, slope=epi.slope)


def _case(seed, b, n_in, n_k, pad, cin, cout, dtype=np.float32):
    """x, fan-in scaled kernel, bias and a cotangent of the output."""
    rng = np.random.default_rng(seed)
    m = 2 * n_in - n_k + 2 * pad
    x = rng.standard_normal((b, n_in, n_in, cin)).astype(dtype)
    k = (rng.standard_normal((n_k, n_k, cin, cout))
         * (n_k * n_k * cin) ** -0.5).astype(dtype)
    bias = (0.1 * rng.standard_normal((cout,))).astype(dtype)
    g = rng.standard_normal((b, m, m, cout)).astype(dtype)
    return x, k, bias, g


def _jax_layer_vjp(x, k, bias, g, pad, epi):
    """(dx, dk, db) of ``epi.apply(unified(x, k) + b)`` by ``jax.vjp``."""
    je = _jax_epi(epi)

    def layer(a, w, b):
        y = jtc.transpose_conv_unified(a, w, pad)
        return je.apply(y, b) if je is not None else y

    @jax.jit
    def grads(a, w, b, gg):
        return jax.vjp(layer, a, w, b)[1](gg)

    return [np.asarray(t) for t in grads(*map(jnp.asarray, (x, k, bias, g)))]


# ------------------------------------------------------------ epilogue-grad

@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
def test_epilogue_grad_plain_matches_pallas(epi):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    y = np.tanh(rng.standard_normal(g.shape)).astype(np.float32)
    y[0, 0, 0, :] = 0.0   # relu'(0): the kernel and the plain version say 0
    got = bw.epilogue_grad_plain(torch.from_numpy(g), torch.from_numpy(y), epi)
    want = jbwd.epilogue_grad_pallas(jnp.asarray(g), jnp.asarray(y),
                                     _jax_epi(epi), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_epilogue_grad_passes_g_through_without_activation():
    g, y = torch.ones(1, 2, 2, 3), torch.zeros(1, 2, 2, 3)
    before = bw.epilogue_grad.launches
    for epi in EPILOGUES[:2]:
        assert bw.epilogue_grad(g, y, epi) is g
    assert bw.epilogue_grad.launches == before


# ---------------------------------------------------- dx and dw against jax

BWD_CASES = [(n, p, 5) for n in (2, 3, 4, 5) for p in range(n)]   # n odd: odd M


@pytest.mark.parametrize("n_k,pad,n_in", BWD_CASES)
def test_dx_dw_db_plain_match_jax_vjp(n_k, pad, n_in):
    """Every kernel size 2..5 and padding 0..n-1, one epilogue each in turn;
    fp32 within 1e-5."""
    epi = EPILOGUES[(n_k + pad) % len(EPILOGUES)]
    _check_layer_bwd(11 * n_k + pad, 2, n_in, n_k, pad, 3, 4, epi)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("n_in,n_k,pad", [(4, 4, 2), (6, 3, 2)])
def test_gan_geometry_every_epilogue(epi, n_in, n_k, pad):
    """The GAN case (4x4, P = 2) and an odd-M case with each epilogue."""
    _check_layer_bwd(n_in + n_k, 2, n_in, n_k, pad, 5, 3, epi)


def _check_layer_bwd(seed, b, n_in, n_k, pad, cin, cout, epi):
    x, k, bias, g = _case(seed, b, n_in, n_k, pad, cin, cout)
    tx, tk, tb, tg = map(torch.from_numpy, (x, k, bias, g))
    y = tcf.transpose_conv2d_fused_plain(tx, tk, pad, epilogue=epi,
                                         bias=tb if epi is not None else None)
    gm = bw.epilogue_grad_plain(tg, y, epi)
    dx = bw.transpose_conv2d_dx_plain(gm, tk, n_in, pad)
    dw, db = bw.transpose_conv2d_dw_plain(tx, gm, n_k, pad, with_db=True)
    dx_ref, dw_ref, db_ref = _jax_layer_vjp(x, k, bias, g, pad, epi)
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=1e-5, atol=1e-5)
    if epi is not None and epi.bias:
        np.testing.assert_allclose(db.numpy(), db_ref, rtol=1e-5, atol=1e-5)
    # the composer, on CPU tensors, runs the same plain versions; so do the
    # plain versions given g, y and the epilogue (the card's fold)
    cdx, cdw, cdb = bw.transpose_conv2d_bwd(tx, tk, tg, pad, epilogue=epi, y=y)
    assert torch.equal(cdx, dx) and torch.equal(cdw, dw)
    assert (cdb is None) == (epi is None or not epi.bias)
    fdw, fdb = bw.transpose_conv2d_dw_plain(tx, tg, n_k, pad, with_db=True, y=y,
                                            epilogue=epi)
    assert torch.equal(bw.transpose_conv2d_dx_plain(tg, tk, n_in, pad, y=y, epilogue=epi),
                       dx)
    assert torch.equal(fdw, dw) and torch.equal(fdb, db)


# ------------------------------------------------------------------ autograd

def _plan(method, epi, bwd="segregated", shape=(1, 3, 4, 2, 2, 2)):
    b, n_in, n_k, pad, cin, cout = shape
    return planlib.plan_layer(b, n_in, n_k, cin, cout, pad, "float64",
                              method=method, epilogue=epi, bwd=bwd)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("fn,method", [(ops.TconvFusedFn, "fused"),
                                       (ops.TconvGemmFn, "gemm")])
def test_gradcheck(fn, method, epi):
    x, k, bias, _ = _case(5, 1, 3, 4, 2, 2, 2, dtype=np.float64)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias)]
    if epi is None or not epi.bias:
        args[2] = None
    lp = _plan(method, epi)
    assert torch.autograd.gradcheck(lambda *a: fn.apply(*a, lp), tuple(args))


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
def test_grads_match_jax_custom_vjp(epi):
    """Gradients through TconvGemmFn against ``jax.grad`` of the reference's
    ``transpose_conv2d_pallas_gemm`` (interpret mode, ``bwd="lax"``)."""
    n_in, n_k, pad, cin, cout = 4, 4, 2, 3, 5
    x, k, bias, r = _case(17, 2, n_in, n_k, pad, cin, cout)
    je = _jax_epi(epi)
    has_b = epi is not None and epi.bias

    def jloss(a, w, b):
        y = jops.transpose_conv2d_pallas_gemm(
            a, w, pad, bwd="lax", epilogue=je, bias=b if has_b else None)
        return jnp.sum(y * jnp.asarray(r))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, bias)))
    tx, tk, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias))
    lp = planlib.plan_layer(2, n_in, n_k, cin, cout, pad, method="gemm",
                            epilogue=epi)
    y = ops.TconvGemmFn.apply(tx, tk, tb if has_b else None, lp)
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    if has_b:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
def test_segregated_and_autograd_backwards_agree(epi):
    x, k, bias, r = _case(23, 2, 5, 3, 1, 4, 6, dtype=np.float64)
    has_b = epi is not None and epi.bias
    grads = {}
    for bwd in ops.BWD_METHODS:
        tx, tk, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias))
        lp = _plan("fused", epi, bwd, shape=(2, 5, 3, 1, 4, 6))
        y = ops.TconvFusedFn.apply(tx, tk, tb if has_b else None, lp)
        (y * torch.from_numpy(r)).sum().backward()
        grads[bwd] = (tx.grad, tk.grad, tb.grad)
    for a, b in zip(grads["segregated"], grads["autograd"]):
        if a is None:
            assert b is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_dx_is_skipped_when_the_input_needs_no_grad(monkeypatch):
    calls = []
    orig = bw.transpose_conv2d_dx
    monkeypatch.setattr(bw, "transpose_conv2d_dx",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, k, bias, _ = _case(1, 1, 4, 4, 2, 2, 3)
    tk = torch.from_numpy(k).requires_grad_(True)
    lp = _plan("fused", EPILOGUES[2], shape=(1, 4, 4, 2, 2, 3))
    ops.TconvFusedFn.apply(torch.from_numpy(x), tk, torch.from_numpy(bias),
                           lp).sum().backward()
    assert tk.grad is not None and not calls


def test_unknown_bwd_method_raises():
    with pytest.raises(ValueError, match="bwd"):
        planlib.plan_layer(1, 4, 4, 2, 2, 2, bwd="lax")


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("pad", [0, 1, 2, 3])
@pytest.mark.parametrize("n_k", [2, 3, 4, 5, 7])
def test_dw_tap_table_has_one_writer_per_tap(n_k, pad):
    """Each HWIO tap is read by exactly one (phase, p, q); the stacked taps
    past an odd kernel are in no entry, so they are never written."""
    table = bw.dw_tap_table(n_k, pad)
    assert sorted((kh, kw) for kh, kw, *_ in table) == [
        (kh, kw) for kh in range(n_k) for kw in range(n_k)]
    ws = bw.wsels(pad)
    stacked = {(ph, p, q) for _, _, ph, p, q in table}
    assert len(stacked) == len(table)
    r = (n_k + 1) // 2
    for ph, p, q in itertools.product(range(4), range(r), range(r)):
        s = ws[ph]
        inside = 2 * p + s // 2 < n_k and 2 * q + s % 2 < n_k
        assert ((ph, p, q) in stacked) == inside


def test_split_counts_depend_on_the_shape_only():
    """The split counts, and with them each sum's order, are fixed by the
    layer's shape: the DCGAN layers at batch 8 split as below, the same in
    every process."""
    bw.bwd_geometry.cache_clear()
    dcgan = [(8, 4, 4, 2, 1024, 512), (8, 8, 4, 2, 512, 256),
             (8, 16, 4, 2, 256, 128), (8, 32, 4, 2, 128, 3)]
    got = [(bw.bwd_geometry(*s).dx_splits, bw.bwd_geometry(*s).dw_splits)
           for s in dcgan]
    assert got == [(16, 1), (8, 2), (4, 8), (1, 16)]
    for s in dcgan:
        g = bw.bwd_geometry(*s)
        # a rich dx grid fills the card in one wave; its splits run over
        # whole contraction steps, each split keeping several
        if g.dx_layout == "rich":
            assert bw.DX_MIN_BLOCKS - g.dx_grid[0] * g.dx_grid[1] < (
                g.dx_grid[0] * g.dx_grid[1] * g.dx_splits) <= bw.DX_MIN_BLOCKS
            covered = [i for z in range(g.dx_splits) for i in g.dx_split_steps(z)]
            assert covered == list(range(g.dx_steps))
            assert min(len(g.dx_split_steps(z)) for z in range(g.dx_splits)) >= (
                bw.DX_MIN_SPLIT_STEPS)
        assert g.dw_grid[0] * g.dw_grid[1] * g.dw_splits >= bw.DW_MIN_BLOCKS
        # a rich split holds whole ring stages, a poor one whole rows
        step = g.hp if g.dw_layout == "poor" else bw.BK
        assert g.dw_positions_per_split % step == 0
        assert g.dw_positions_per_split * g.dw_splits >= g.dw_positions


def test_card_shape_lists_reach_every_dw_instance():
    """The card test's SHAPES and chip_smoke.py's BWD_SHAPES each launch
    every compiled dw instance (the rich and narrow tiles, the poor layout
    at R = 1-4)."""
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
        from test_torch_cuda import SHAPES
    finally:
        sys.path.remove(root)
    for shapes in (SHAPES, chip_smoke.BWD_SHAPES):
        assert {bw.bwd_geometry(*s).dw_variant for s in shapes} == bw.dw_variants()


def test_fold_shape_lists_reach_every_dx_and_dw_instance():
    """The card test's FOLD_SHAPES and chip_smoke.py's BWD_SHAPES (where its
    backward check holds the fold bitwise) reach every compiled dx and dw
    instance, and the unaligned shapes' y takes the 4-byte copies of a
    Cout that is a multiple of 4."""
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
        from test_torch_cuda import DX_UNALIGNED_SHAPES, FOLD_SHAPES, offset_view
    finally:
        sys.path.remove(root)
    for shapes in (FOLD_SHAPES, chip_smoke.BWD_SHAPES):
        geos = [bw.bwd_geometry(*s) for s in shapes]
        assert {g.dx_variant for g in geos} == bw.dx_variants()
        assert {g.dw_variant for g in geos} == bw.dw_variants()
    for shape in DX_UNALIGNED_SHAPES + chip_smoke.DX_UNALIGNED_SHAPES:
        b, n_in, n_k, pad, cin, cout = shape
        m = 2 * n_in - n_k + 2 * pad
        g, k = torch.empty((b, m, m, cout)), torch.empty((n_k, n_k, cin, cout))
        assert bw.dx_copy_widths(g, k, g)[0]
        assert not bw.dx_copy_widths(g, k, offset_view(g))[0]


def test_card_shape_lists_reach_every_dx_instance_and_copy_width():
    """The card tests (SHAPES, and DX_UNALIGNED_SHAPES through offset views)
    and chip_smoke.py's backward check (BWD_SHAPES and its
    DX_UNALIGNED_SHAPES) each launch every compiled dx instance (the rich
    tile; the poor layout at R = 1-4); each layout with the 16-byte and the
    4-byte gm and weight copies that ``bw.dx_copy_widths`` chooses, the
    4-byte ones both at a ragged Cout and with unaligned operands at a Cout
    that is a multiple of 4; and the poor layout with 16-byte and 4-byte dx
    stores."""
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
        from test_torch_cuda import DX_UNALIGNED_SHAPES, SHAPES, offset_view
    finally:
        sys.path.remove(root)

    def operands(shape, unaligned):
        b, n_in, n_k, pad, cin, cout = shape
        m = 2 * n_in - n_k + 2 * pad
        gm, k = torch.empty((b, m, m, cout)), torch.empty((n_k, n_k, cin, cout))
        return (offset_view(gm), offset_view(k)) if unaligned else (gm, k)

    for shapes, unaligned in ((SHAPES, DX_UNALIGNED_SHAPES),
                              (chip_smoke.BWD_SHAPES, chip_smoke.DX_UNALIGNED_SHAPES)):
        launches = [(s, False) for s in shapes] + [(s, True) for s in unaligned]
        geos = [bw.bwd_geometry(*s) for s, _ in launches]
        assert {g.dx_variant for g in geos} == bw.dx_variants()
        widths = [(g.dx_layout, g.cout % 4 == 0, *bw.dx_copy_widths(*operands(s, u)))
                  for (s, u), g in zip(launches, geos)]
        for layout in ("rich", "poor"):
            mine = [w[1:] for w in widths if w[0] == layout]
            assert {vg for _, vg, _ in mine} == {True, False}
            assert (True, False) in {(c4, vg) for c4, vg, _ in mine}   # unaligned
            assert (False, False) in {(c4, vg) for c4, vg, _ in mine}  # ragged
            assert layout == "rich" or {vx for _, _, vx in mine} == {True, False}


# ------------------------------------------------- emulation of the kernels

def _emulate_dx_rich(gm, kernel, g, vg, y=None, act=None):
    """``dx_kernel``: per (128-row block, 128-Cin block, split) block, each
    thread's copies (16-byte where ``vg``) of two gm rows (their pixel for
    each tap resolved by the thread) and two weight rows into a
    DX_STAGES-deep ring of 16-channel Cout steps, then 8 x 8 tiles (rows
    rg + 16 i, Cin cg + 16 j) accumulated one contraction index at a time in
    the kernel's order. With ``act`` folded, ``gm`` is ``g``: each thread
    loads its two ``g`` pieces and their ``y`` pieces (same mapping, same
    zero fill) and stores ``g * act'(y)`` into the slot."""
    b, m, _, cout = gm.shape
    n_k, cin, n_in, r = kernel.shape[0], kernel.shape[2], g.n_in, g.r
    (bm, bn), bk, st_n = bw.DX_TILES["rich"], bw.BK, bw.DX_STAGES
    rows, plane = g.dx_rows, n_in * n_in
    part = torch.full((g.dx_splits, rows, cin), float("nan"), dtype=gm.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    gflat, wflat = gm.reshape(-1), kernel.reshape(-1)
    yflat = y.reshape(-1) if act is not None else None
    tid = torch.arange(256)
    rg, cg = tid // 16, tid % 16
    for bx, by, z in itertools.product(*map(range, g.dx_grid)):
        m0, ci0 = bx * bm, by * bn
        ring = [None] * st_n

        def stage(step, slot):
            tap, co0 = step // g.dx_cpt, step % g.dx_cpt * bk
            ph, p, q = tap // (r * r), tap % (r * r) // r, tap % r
            pr, pc, s = ph // 2, ph % 2, g.wsels[ph]
            kh, kw = 2 * p + s // 2, 2 * q + s % 2
            co = co0 + 4 * (tid % 4)
            a_st = torch.full((bm, bk), float("nan"), dtype=gm.dtype)
            b_st = torch.full((bn, bk), float("nan"), dtype=gm.dtype)
            for h in range(2):
                row = tid // 4 + 64 * h
                rr = m0 + row
                rb = torch.where(rr < rows, rr // plane, -1)
                ri, rj = rr % plane // n_in, rr % n_in
                t, u = ri + g.roffs[pr] - p, rj + g.coffs[pc] - q
                oh, ow = 2 * t + pr, 2 * u + pc
                ok = (rb >= 0) & (t >= 0) & (u >= 0) & (oh < m) & (ow < m)
                src = ((rb * m + oh) * m + ow) * cout + co
                n = torch.where(ok, cout - co, 0)
                piece = _cp_quad(gflat, src, n, vg)
                if act is not None:   # g and y into registers, stored folded
                    piece = act.grad_from_y(piece, _cp_quad(yflat, src, n, vg))
                a_st.view(bm, 4, 4)[row, tid % 4] = piece
                ci = ci0 + row
                okw = (kh < n_k) & (kw < n_k) & (ci < cin)
                wsrc = ((kh * n_k + kw) * cin + ci) * cout + co
                b_st.view(bn, 4, 4)[row, tid % 4] = _cp_quad(
                    wflat, wsrc, torch.where(okw, cout - co, 0), vg)
            assert not (a_st.isnan().any() or b_st.isnan().any())  # every slot staged
            ring[slot] = (a_st, b_st)

        lo = z * g.dx_steps // g.dx_splits
        nk = (z + 1) * g.dx_steps // g.dx_splits - lo
        acc = torch.zeros((bm, bn), dtype=gm.dtype)
        for st in range(min(st_n - 1, nk)):
            stage(lo + st, st)
        for k in range(nk):
            if k + st_n - 1 < nk:
                assert (k + st_n - 1) % st_n != k % st_n   # never the slot being read
                stage(lo + k + st_n - 1, (k + st_n - 1) % st_n)
            a_st, b_st = ring[k % st_n]
            for c in range(bk):
                acc += a_st[:, c, None] * b_st[None, :, c]
        # thread (rg, cg) writes rows rg + 16 i, Cin cg + 16 j
        rr = m0 + rg[:, None] + 16 * torch.arange(8)          # (256, 8)
        cc = ci0 + cg[:, None] + 16 * torch.arange(8)
        for i in range(8):
            for j in range(8):
                ok = (rr[:, i] < rows) & (cc[:, j] < cin)
                vals = acc[rr[ok, i] - m0, cc[ok, j] - ci0]
                part[z, rr[ok, i], cc[ok, j]] = vals
                writes[z, rr[ok, i], cc[ok, j]] += 1
    return part, writes


def _emulate_dx_poor(gm, kernel, g, vg, y=None, act=None):
    """``dx_poor_kernel``: per (32 position groups, 32 Cin) block, the 4 R R
    taps x 32 Cin of weights staged [tap][ci][4 co] (Cout zero-padded), and
    each thread (a group of 8 positions along a row x a Cin quad) walking
    each parity's row taps with a window of 8 + R - 1 gm pixels, each one
    float4: a 16-byte load where ``vg``, else Cout 4-byte loads and zeros.
    With ``act`` folded, ``gm`` is ``g`` and each loaded pixel takes
    ``act'`` of the ``y`` pixel loaded beside it, zeros included; pixels
    outside the plane are zeros, never loaded (the kernel loads and folds
    each pixel once a position group and shares the window through shared
    memory: the values are these)."""
    b, m, _, cout = gm.shape
    n_k, cin, n_in, r = kernel.shape[0], kernel.shape[2], g.n_in, g.r
    np_, (_, ct) = bw.DX_POOR_NP, bw.DX_TILES["poor"]
    gpr = -(-n_in // np_)
    n_groups = b * n_in * gpr
    part = torch.full((1, g.dx_rows, cin), float("nan"), dtype=gm.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    gflat, wflat = gm.reshape(-1), kernel.reshape(-1)

    def pixel(bb, oh, ow):
        src, n = torch.tensor([((bb * m + oh) * m + ow) * cout]), torch.tensor([cout])
        v = _cp_quad(gflat, src, n, vg)[0]
        if act is not None:
            v = act.grad_from_y(v, _cp_quad(y.reshape(-1), src, n, vg)[0])
        return v

    for bx, by, _ in itertools.product(*map(range, g.dx_grid)):
        ci0 = by * ct
        ws = torch.full((4 * r * r * ct, 4), float("nan"), dtype=gm.dtype)
        rows = torch.arange(4 * r * r * ct)
        tap, ci = rows // ct, ci0 + rows % ct
        ph, p, q = tap // (r * r), tap // r % r, tap % r
        sub = torch.tensor(g.wsels)[ph]
        kh, kw = 2 * p + sub // 2, 2 * q + sub % 2
        ok = (kh < n_k) & (kw < n_k) & (ci < cin)
        ws[rows] = _cp_quad(wflat, ((kh * n_k + kw) * cin + ci) * cout,
                            torch.where(ok, cout, 0), vg)
        assert not ws.isnan().any()
        ws = ws.reshape(4 * r * r, ct, 4)
        # the threads of a position group (its Cin quads) at once
        for grp in range(bx * (256 // (ct // 4)), (bx + 1) * (256 // (ct // 4))):
            if grp >= n_groups:
                continue
            bb, i, j0 = grp // (n_in * gpr), grp // gpr % n_in, grp % gpr * np_
            acc = torch.zeros((np_, ct), dtype=gm.dtype)
            for ph_ in range(4):
                pr, pc = ph_ // 2, ph_ % 2
                u0 = j0 + g.coffs[pc] - (r - 1)
                for p_ in range(r):
                    t = i + g.roffs[pr] - p_
                    oh = 2 * t + pr
                    if t < 0 or oh >= m:
                        continue
                    win = [pixel(bb, oh, 2 * (u0 + mm) + pc) if u0 + mm >= 0
                           and 2 * (u0 + mm) + pc < m
                           else torch.zeros(4, dtype=gm.dtype)
                           for mm in range(np_ + r - 1)]
                    for q_ in range(r):
                        wv = ws[(ph_ * r + p_) * r + q_]          # (ct ci, 4 co)
                        for n in range(np_):
                            gv = win[n + r - 1 - q_]
                            for e in range(4):
                                acc[n] = acc[n] + gv[e] * wv[:, e]
            c_idx = ci0 + torch.arange(ct)
            okc = c_idx < cin
            for n in range(np_):
                j = j0 + n
                if j >= n_in:
                    break
                row = (bb * n_in + i) * n_in + j
                part[0, row, c_idx[okc]] = acc[n, okc]
                writes[0, row, c_idx[okc]] += 1
    return part, writes


def emulate_dx_kernel(gm, kernel, n_in, padding, vg=None, y=None, epilogue=None):
    """What the dx kernel of the layer's layout (then ``sum_splits_kernel``)
    computes, block by block, with its own index arithmetic; ``vg`` is the
    gm and weight copy width the wrapper chose (``bw.dx_copy_widths``).
    With an activation ``epilogue``, ``gm`` is the cotangent ``g`` and the
    kernel applies ``act'(y)`` as it stages it. Returns dx and the write
    count of every (split, row, ci) slot."""
    b, m, _, cout = gm.shape
    n_k, cin = kernel.shape[0], kernel.shape[2]
    g = bw.bwd_geometry(b, n_in, n_k, padding, cin, cout)
    act = bw._activation(epilogue)
    if vg is None:
        vg = bw.dx_copy_widths(gm, kernel, y if act else None)[0]
    run = _emulate_dx_poor if g.dx_layout == "poor" else _emulate_dx_rich
    part, writes = run(gm, kernel, g, vg, y, act)
    dx = part[0]
    for z in range(1, g.dx_splits):
        dx = dx + part[z]
    return dx.reshape(b, n_in, n_in, cin), writes


def _emulate_dw_rich(x, gm, g, with_db, y=None, act=None):
    """``dw_kernel``: per (Cin x Cout tile, HWIO tap, split) block, the ring
    of 16-position stages (each thread stages position ``tid // 16`` of a
    stage: its x row and gm row pieces ``tid % 16 + 16 j``), the 8 x 8
    micro-tiles accumulated one position at a time, and db from the staged
    gm rows. With ``act`` folded, ``gm`` is ``g``: each thread loads its
    ``g`` pieces and their ``y`` pieces with the same mask and stores
    ``g * act'(y)`` into the stage, so the micro-tiles and db read gm."""
    b, n_in, _, cin = x.shape
    m, cout, n_k = gm.shape[1], gm.shape[3], g.n_k
    bm, bn = g.dw_tile
    n_co = -(-cout // bn)
    plane, pos = g.hp * g.hp, g.dw_positions
    part = torch.full((g.dw_splits, n_k, n_k, cin, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    db_part = torch.full((g.dw_splits, 4, cout), float("nan"), dtype=x.dtype)
    db_writes = torch.zeros(db_part.shape, dtype=torch.int64)
    xflat, gflat = x.reshape(-1), gm.reshape(-1)
    yflat = y.reshape(-1) if act is not None else None
    tid = torch.arange(256)
    kk, lane16 = tid // 16, tid % 16
    tx, ty = tid % (bn // 8), tid // (bn // 8)
    # a thread's 8 x 8 outputs: rows ty*4 + i and bm/2 + ty*4 + i, columns alike
    rows = torch.cat([ty[:, None] * 4 + torch.arange(4), bm // 2 + ty[:, None] * 4
                      + torch.arange(4)], 1)
    cols = torch.cat([tx[:, None] * 4 + torch.arange(4), bn // 2 + tx[:, None] * 4
                      + torch.arange(4)], 1)
    for bx, tap, z in itertools.product(*map(range, g.dw_grid)):
        ci0, co0 = (bx // n_co) * bm, (bx % n_co) * bn
        kh, kw = tap // n_k, tap % n_k
        ph = g.phase_of_sub[2 * (kh % 2) + kw % 2]
        pr, pc, p, q = ph // 2, ph % 2, kh // 2, kw // 2
        do_db = with_db and p == 0 and q == 0 and ci0 == 0
        acc = torch.zeros((bm, bn), dtype=x.dtype)
        dbacc = torch.zeros(bn, dtype=x.dtype)
        k_begin = z * g.dw_positions_per_split
        k_end = min(pos, k_begin + g.dw_positions_per_split)
        steps = -(-(k_end - k_begin) // bw.BK) if k_end > k_begin else 0
        for st in range(steps):
            k = k_begin + st * bw.BK + kk                 # each thread's position
            bb, rem = k // plane, k % plane
            t, u = rem // g.hp, rem % g.hp
            oh, ow = 2 * t + pr, 2 * u + pc
            gok = (k < k_end) & (oh < m) & (ow < m)
            ih = g.row0s[pr] + t + p - g.pad_lo
            iw = g.col0s[pc] + u + q - g.pad_lo
            xok = gok & (ih >= 0) & (ih < n_in) & (iw >= 0) & (iw < n_in)
            xsrc = ((bb * n_in + ih) * n_in + iw) * cin
            gsrc = ((bb * m + oh) * m + ow) * cout
            xs = torch.full((bw.BK, bm), float("nan"), dtype=x.dtype)
            gs = torch.full((bw.BK, bn), float("nan"), dtype=x.dtype)
            for j in range(bm // 64):
                ci = ci0 + 4 * (lane16 + 16 * j)[:, None] + torch.arange(4)
                xs[kk[:, None], ci - ci0] = _gather(
                    xflat, xsrc[:, None] + ci, xok[:, None] & (ci < cin))
            for j in range(bn // 64):
                co = co0 + 4 * (lane16 + 16 * j)[:, None] + torch.arange(4)
                live = gok[:, None] & (co < cout)
                piece = _gather(gflat, gsrc[:, None] + co, live)
                if act is not None:   # g and y into registers, stored folded
                    piece = act.grad_from_y(piece, _gather(yflat, gsrc[:, None] + co, live))
                gs[kk[:, None], co - co0] = piece
            assert not (xs.isnan().any() or gs.isnan().any())   # every slot staged
            for c in range(bw.BK):   # one position at a time, as the kernel
                if do_db:
                    dbacc += gs[c]
                acc += xs[c][:, None] * gs[c][None, :]
        ci, co = ci0 + rows, co0 + cols                    # (256, 8) each
        for i in range(8):
            for e in range(8):
                ok = (ci[:, i] < cin) & (co[:, e] < cout)
                part[z, kh, kw, ci[ok, i], co[ok, e]] = acc[rows[ok, i], cols[ok, e]]
                writes[z, kh, kw, ci[ok, i], co[ok, e]] += 1
        if do_db:
            c = co0 + torch.arange(bn)
            db_part[z, ph, c[c < cout]] = dbacc[c < cout]
            db_writes[z, ph, c[c < cout]] += 1
    return part, writes, db_part, db_writes


def _emulate_dw_poor(x, gm, g, with_db, y=None, act=None):
    """``dw_poor_kernel``: per (64-Cin block, phase x row tap p, split)
    block, 16 row slices of 16 threads (a Cin quad each) walk their rows
    with a sliding window of R x pixels, then the slices' sums are added in
    slice order. With ``act`` folded, ``gm`` is ``g`` and each g pixel
    takes ``act'`` of the y pixel loaded beside it (zeros past Cout on
    both) before it feeds the taps and db."""
    b, n_in, _, cin = x.shape
    m, cout, n_k, r = gm.shape[1], gm.shape[3], g.n_k, g.r
    part = torch.full((g.dw_splits, n_k, n_k, cin, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    db_part = torch.full((g.dw_splits, 4, cout), float("nan"), dtype=x.dtype)
    db_writes = torch.zeros(db_part.shape, dtype=torch.int64)
    rows_per_split = g.dw_positions_per_split // g.hp
    n_rows = b * g.hp
    for bx, by, z in itertools.product(*map(range, g.dw_grid)):
        ph, p = by // r, by % r
        pr, pc = ph // 2, ph % 2
        sub = g.wsels[ph]
        kh = 2 * p + (sub >> 1)
        ci = bx * 64 + torch.arange(64)                    # 16 quads of 4
        db_block = with_db and p == 0 and bx == 0
        u_end = min(g.hp, (m - pc + 1) // 2)
        r_begin = z * rows_per_split
        r_end = min(n_rows, r_begin + rows_per_split)
        acc = torch.zeros((16, r, 64, 4), dtype=x.dtype)   # (slice, q, ci, co)
        dbacc = torch.zeros((16, 4), dtype=x.dtype)
        for sl in range(16):
            if not (kh < n_k or db_block):
                break
            for row in range(r_begin + sl, r_end, 16):
                bb, t = row // g.hp, row % g.hp
                oh = 2 * t + pr
                if oh >= m:
                    continue
                ih = g.row0s[pr] + t + p - g.pad_lo
                row_ok = kh < n_k and 0 <= ih < n_in

                def pixel(iw):
                    v = torch.zeros(64, dtype=x.dtype)
                    if row_ok and 0 <= iw < n_in:
                        v[ci < cin] = x[bb, ih, iw, ci[ci < cin]]
                    return v

                iw0 = g.col0s[pc] - g.pad_lo
                win = [None] + [pixel(iw0 + qq) for qq in range(r - 1)]
                for u in range(u_end):
                    win = win[1:] + [pixel(iw0 + u + r - 1)]
                    gv = torch.zeros(4, dtype=x.dtype)
                    gv[:cout] = gm[bb, oh, 2 * u + pc, :cout]
                    if act is not None:
                        yv = torch.zeros(4, dtype=x.dtype)
                        yv[:cout] = y[bb, oh, 2 * u + pc, :cout]
                        gv = act.grad_from_y(gv, yv)
                    for qq in range(r):
                        acc[sl, qq] += win[qq][:, None] * gv[None, :]
                    dbacc[sl] += gv
        tot = acc[0]
        for sl in range(1, 16):
            tot = tot + acc[sl]
        for qq in range(r):
            kw = 2 * qq + (sub & 1)
            if kh >= n_k or kw >= n_k:
                continue
            ok = ci < cin
            part[z, kh, kw, ci[ok], :] = tot[qq, ok, :cout]
            writes[z, kh, kw, ci[ok], :] += 1
        if db_block:
            db = dbacc[0]
            for sl in range(1, 16):
                db = db + dbacc[sl]
            db_part[z, ph] = db[:cout]
            db_writes[z, ph] += 1
    return part, writes, db_part, db_writes


def emulate_dw_kernel(x, gm, n_k, padding, with_db=True, y=None, epilogue=None):
    """What the dw kernel of the layer's layout (then ``sum_splits_kernel``)
    computes, block by block; with an activation ``epilogue``, ``gm`` is the
    cotangent ``g`` and the kernel applies ``act'(y)`` as it stages it.
    Returns dw, db and the write counts of the dw and db slots."""
    b, n_in, _, cin = x.shape
    g = bw.bwd_geometry(b, n_in, n_k, padding, cin, gm.shape[3])
    run = _emulate_dw_poor if g.dw_layout == "poor" else _emulate_dw_rich
    part, writes, db_part, db_writes = run(x, gm, g, with_db, y, bw._activation(epilogue))
    dw = part[0]
    for z in range(1, g.dw_splits):
        dw = dw + part[z]
    db = db_part.reshape(-1, gm.shape[3])
    db_sum = db[0]
    for i in range(1, db.shape[0]):
        db_sum = db_sum + db[i]
    return dw, db_sum, writes, db_writes


EMU_CASES = [   # (b, N, n, P, Cin, Cout)
    (2, 4, 4, 2, 5, 3),      # DCGAN geometry, Cout = 3 (the poor dw layout)
    (1, 7, 3, 0, 3, 19),     # odd M = 11, Cout not a multiple of 16
    (1, 6, 5, 1, 70, 6),     # n = 5, odd P, two Cin blocks of dx
    (2, 5, 3, 1, 2, 20),     # odd M = 11, odd P
    (1, 9, 2, 1, 4, 33),     # n = 2, M = 18
    (1, 5, 4, 2, 8, 72),     # the rich dw tile (Cout > 64), ragged in it
    (1, 9, 7, 3, 70, 2),     # the poor layout at R = 4, two Cin blocks, odd M
    (3, 7, 4, 2, 6, 9),      # two rich dx row blocks
    (1, 3, 4, 2, 130, 5),    # two rich dx Cin blocks
    (2, 5, 2, 1, 8, 4),      # poor dx R = 1: 16-byte gm pixels and dx stores
    (1, 6, 5, 2, 12, 1),     # poor dx R = 3, Cout = 1
    (2, 17, 4, 2, 6, 3),     # poor dx: 4 blocks of position groups, rows ragged in them
]


@pytest.mark.parametrize("shape", EMU_CASES, ids=str)
def test_emulated_dx_kernel_writes_once_and_matches(shape):
    b, n_in, n_k, pad, cin, cout = shape
    x, k, _, g = _case(sum(shape), b, n_in, n_k, pad, cin, cout, dtype=np.float64)
    tk, tg = torch.from_numpy(k), torch.from_numpy(g)
    got, writes = emulate_dx_kernel(tg, tk, n_in, pad)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want = bw.transpose_conv2d_dx_plain(tg, tk, n_in, pad)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 5, 2, 1, 8, 4), (1, 5, 4, 2, 8, 8)], ids=str)
def test_emulated_dx_kernel_with_4_byte_copies(shape):
    """The 4-byte gm and weight copies that unaligned operands take at a
    Cout that is a multiple of 4 (poor at Cout 4, rich at Cout 8) give the
    same dx as the 16-byte ones."""
    b, n_in, n_k, pad, cin, cout = shape
    _, k, _, g = _case(sum(shape) + 2, b, n_in, n_k, pad, cin, cout, dtype=np.float64)
    tk, tg = torch.from_numpy(k), torch.from_numpy(g)
    want = bw.transpose_conv2d_dx_plain(tg, tk, n_in, pad)
    for vg in (True, False):
        got, writes = emulate_dx_kernel(tg, tk, n_in, pad, vg=vg)
        assert int(writes.min()) == 1 and int(writes.max()) == 1
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", EMU_CASES, ids=str)
def test_emulated_dw_kernel_writes_once_and_matches(shape):
    b, n_in, n_k, pad, cin, cout = shape
    x, _, _, g = _case(sum(shape) + 1, b, n_in, n_k, pad, cin, cout,
                       dtype=np.float64)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw, db, writes, db_writes = emulate_dw_kernel(tx, tg, n_k, pad)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    assert int(db_writes.min()) == 1 and int(db_writes.max()) == 1
    want_dw, want_db = bw.transpose_conv2d_dw_plain(tx, tg, n_k, pad, with_db=True)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_db, rtol=1e-12, atol=1e-12)


def test_emulated_kernels_split_at_the_dcgan_tail():
    """At a DCGAN L3-like shape the dw contraction really splits (and the
    emulation still writes each slot once and matches)."""
    shape = (2, 32, 4, 2, 3, 3)
    g = bw.bwd_geometry(*shape)
    assert g.dw_splits > 1 and g.dw_layout == "poor" and g.dw_tile == (64, 4)
    b, n_in, n_k, pad, cin, cout = shape
    x, _, _, gm = _case(9, b, n_in, n_k, pad, cin, cout, dtype=np.float64)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gm)
    dw, db, writes, _ = emulate_dw_kernel(tx, tg, n_k, pad)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want_dw, want_db = bw.transpose_conv2d_dw_plain(tx, tg, n_k, pad, with_db=True)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_db, rtol=1e-12, atol=1e-12)


# ----------------------------------------- act' folded into dx and dw staging

FOLD_CASES = [   # (b, N, n, P, Cin, Cout), the kernels emulated
    ((2, 4, 4, 2, 5, 3), "dx dw"),     # DCGAN geometry: poor dx R = 2, poor dw
    ((2, 5, 2, 1, 8, 4), "dx dw"),     # poor dx R = 1: 16-byte and 4-byte g, y pixels
    ((1, 7, 3, 0, 3, 19), "dx dw"),    # odd M = 11: rich dx ragged Cout, narrow dw
    ((1, 5, 4, 2, 8, 8), "dx dw"),     # rich dx: 16-byte and 4-byte g, y copies
    ((1, 5, 4, 2, 8, 72), "dx dw"),    # the rich dw tile, ragged in it
    ((1, 9, 7, 3, 36, 2), "dx dw"),    # poor at R = 4, two dx Cin blocks, odd M
    ((2, 32, 4, 2, 3, 3), "dw"),       # the DCGAN tail: the poor dw contraction split
]


def _fold_case(shape, epi, seed):
    """x, kernel, g and the saved output y (fp32) of a layer with ``epi``;
    a few y exactly 0, where relu's and leaky's act' take their else side."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias, g = map(torch.from_numpy, _case(seed, b, n_in, n_k, pad, cin, cout))
    y = tcf.transpose_conv2d_fused_plain(x, k, pad, epilogue=epi,
                                         bias=bias if epi is not None else None)
    y[0, 0, :2] = 0.0
    return x, k, g, y


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("shape,which", FOLD_CASES, ids=str)
def test_emulated_fold_is_bitwise_the_kernels_on_gm(shape, which, epi):
    """Each dx and dw instance, applying ``act'(y)`` to each piece of ``g``
    it stages (zero-filled borders and past-Cout lanes included), gives the
    bits the same instance gives on ``gm = epilogue_grad_plain(g, y, epi)``
    -- at every copy width dx can take -- and writes each slot once."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, g, y = _fold_case(shape, epi, seed=sum(shape) + 5)
    gm = bw.epilogue_grad_plain(g, y, epi)
    if "dx" in which:
        for vg in ((True, False) if cout % 4 == 0 else (False,)):
            got, writes = emulate_dx_kernel(g, k, n_in, pad, vg=vg, y=y, epilogue=epi)
            want, _ = emulate_dx_kernel(gm, k, n_in, pad, vg=vg)
            assert int(writes.min()) == 1 and int(writes.max()) == 1
            assert torch.equal(got, want), (vg, (got - want).abs().max())
    if "dw" in which:
        dw, db, writes, db_writes = emulate_dw_kernel(x, g, n_k, pad, y=y, epilogue=epi)
        want_dw, want_db, _, _ = emulate_dw_kernel(x, gm, n_k, pad)
        assert int(writes.min()) == 1 and int(writes.max()) == 1
        assert int(db_writes.min()) == 1 and int(db_writes.max()) == 1
        assert torch.equal(dw, want_dw) and torch.equal(db, want_db)


@pytest.mark.parametrize("epi", EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize("shape", [(2, 4, 4, 2, 3, 5), (2, 5, 3, 1, 4, 3)], ids=str)
def test_folded_plain_wrappers_match_jax_custom_vjp(shape, epi):
    """dx, dw and db of the wrappers given ``g``, ``y`` and the epilogue (on
    the CPU: the plain epilogue-grad, then plain dx and dw) against
    ``jax.grad`` of the reference's ``transpose_conv2d_pallas_gemm``
    (interpret mode, ``bwd="lax"``) within 1e-5."""
    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias, r = _case(sum(shape) + 31, b, n_in, n_k, pad, cin, cout)
    je = _jax_epi(epi)
    has_b = epi is not None and epi.bias

    def jloss(a, w, bb):
        out = jops.transpose_conv2d_pallas_gemm(
            a, w, pad, bwd="lax", epilogue=je, bias=bb if has_b else None)
        return jnp.sum(out * jnp.asarray(r))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, bias)))
    tx, tk, tb, tr = map(torch.from_numpy, (x, k, bias, r))
    y = tcf.transpose_conv2d_fused_plain(tx, tk, pad, epilogue=epi,
                                         bias=tb if has_b else None)
    dx = bw.transpose_conv2d_dx(tr, tk, n_in, pad, y=y, epilogue=epi)
    dw, db = bw.transpose_conv2d_dw(tx, tr, n_k, pad, with_db=True, y=y, epilogue=epi)
    for got, ref in ((dx, want[0]), (dw, want[1])) + (((db, want[2]),) if has_b else ()):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_folded_wrappers_need_y_for_an_activation():
    x, k, _, g = map(torch.from_numpy, _case(2, 1, 4, 4, 2, 2, 3))
    with pytest.raises(ValueError, match="saved output"):
        bw.transpose_conv2d_dx(g, k, 4, 2, epilogue=EPILOGUES[2])
    with pytest.raises(ValueError, match="saved output"):
        bw.transpose_conv2d_dw(x, g, 4, 2, epilogue=EPILOGUES[3])
    with pytest.raises(ValueError, match="differ"):
        bw.transpose_conv2d_dx(g, k, 4, 2, y=g[:, 1:], epilogue=EPILOGUES[2])


# ------------------------------------------------------------------ wrappers

def test_cpu_tensors_run_plain_without_launching():
    counters = (bw.epilogue_grad, bw.transpose_conv2d_dx, bw.transpose_conv2d_dw)
    before = [c.launches for c in counters] + [bw.epilogue_grad.folded_launches]
    x, k, bias, g = _case(2, 1, 4, 4, 2, 2, 3)
    tx, tk, tg = map(torch.from_numpy, (x, k, g))
    ty = torch.tanh(tg)
    bw.transpose_conv2d_bwd(tx, tk, tg, 2, epilogue=EPILOGUES[3], y=ty)
    bw.transpose_conv2d_dx(tg, tk, 4, 2, y=ty, epilogue=EPILOGUES[3])
    bw.transpose_conv2d_dw(tx, tg, 4, 2, y=ty, epilogue=EPILOGUES[3])
    assert [c.launches for c in counters] + [bw.epilogue_grad.folded_launches] == before


def test_composer_needs_y_for_an_activation():
    x, k, _, g = _case(2, 1, 4, 4, 2, 2, 3)
    with pytest.raises(ValueError, match="saved output"):
        bw.transpose_conv2d_bwd(*map(torch.from_numpy, (x, k, g)), 2,
                                epilogue=EPILOGUES[2])
