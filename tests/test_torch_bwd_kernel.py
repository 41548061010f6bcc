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
    # the composer, on CPU tensors, runs the same plain versions
    cdx, cdw, cdb = bw.transpose_conv2d_bwd(tx, tk, tg, pad, epilogue=epi, y=y)
    assert torch.equal(cdx, dx) and torch.equal(cdw, dw)
    assert (cdb is None) == (epi is None or not epi.bias)


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
    assert got == [(8, 1), (4, 1), (2, 2), (1, 32)]
    for s in dcgan:
        g = bw.bwd_geometry(*s)
        assert g.dx_grid[0] * g.dx_grid[1] * g.dx_splits >= bw.MIN_BLOCKS
        assert g.dw_positions_per_split % bw.BK == 0
        assert g.dw_positions_per_split * g.dw_splits >= g.dw_positions


# ------------------------------------------------- emulation of the kernels

def _gather(flat, idx, mask):
    """``flat[idx]`` where ``mask``, else 0; an unmasked index past the
    tensor raises IndexError, as a stray read would fault."""
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    if bool((safe >= flat.numel()).any()):
        raise IndexError("read past the tensor")
    return torch.where(mask, flat[safe], torch.zeros((), dtype=flat.dtype))


def emulate_dx_kernel(gm, kernel, n_in, padding):
    """What ``dx_kernel`` (then ``sum_splits_kernel``) computes, block by
    block, with its own index arithmetic. Returns dx and the write count of
    every (split, row, ci) slot."""
    b, m, _, cout = gm.shape
    n_k, cin = kernel.shape[0], kernel.shape[2]
    g = bw.bwd_geometry(b, n_in, n_k, padding, cin, cout)
    (bm, bn), r = bw.DX_TILE, g.r
    rows, plane = b * n_in * n_in, n_in * n_in
    part = torch.full((g.dx_splits, rows, cin), float("nan"), dtype=gm.dtype)
    writes = torch.zeros((g.dx_splits, rows, cin), dtype=torch.int64)
    gflat, wflat = gm.reshape(-1), kernel.reshape(-1)
    for bx, by, z in itertools.product(*map(range, g.dx_grid)):
        rr = bx * bm + torch.arange(bm)
        live = rr < rows
        rb, ri, rj = rr // plane, (rr % plane) // n_in, rr % n_in
        ci = by * bn + torch.arange(bn)
        acc = torch.zeros((bm, bn), dtype=gm.dtype)
        t0 = z * g.dx_taps_per_split
        for tap in range(t0, min(g.dx_taps, t0 + g.dx_taps_per_split)):
            ph, p, q = tap // (r * r), (tap // r) % r, tap % r
            s = g.wsels[ph]
            kh, kw = 2 * p + s // 2, 2 * q + s % 2
            if kh >= n_k or kw >= n_k:
                continue
            pr, pc = ph // 2, ph % 2
            t, u = ri + g.roffs[pr] - p, rj + g.coffs[pc] - q
            oh, ow = 2 * t + pr, 2 * u + pc
            ok = live & (t >= 0) & (u >= 0) & (oh < m) & (ow < m)
            if not bool(ok.any()):
                continue
            src = ((rb * m + oh) * m + ow) * cout
            for co0 in range(0, cout, bw.BK):
                co = co0 + torch.arange(bw.BK)
                a = _gather(gflat, src[:, None] + co[None, :],
                            ok[:, None] & (co < cout)[None, :])
                wi = ((kh * n_k + kw) * cin + ci[:, None]) * cout + co[None, :]
                bmat = _gather(wflat, wi, (ci < cin)[:, None] & (co < cout)[None, :])
                acc += a @ bmat.T
        keep_r, keep_c = rr[live], ci[ci < cin]
        part[z][keep_r[:, None], keep_c[None, :]] = acc[live][:, ci < cin]
        writes[z][keep_r[:, None], keep_c[None, :]] += 1
    dx = part[0]
    for z in range(1, g.dx_splits):
        dx = dx + part[z]
    return dx.reshape(b, n_in, n_in, cin), writes


def emulate_dw_kernel(x, gm, n_k, padding, with_db=True):
    """What ``dw_kernel`` (then ``sum_splits_kernel``) computes, block by
    block. Returns dw, db and the write counts of the dw and db slots."""
    b, n_in, _, cin = x.shape
    m, cout = gm.shape[1], gm.shape[3]
    g = bw.bwd_geometry(b, n_in, n_k, padding, cin, cout)
    bm, bn = g.dw_tile
    n_co = -(-cout // bn)
    plane, pos = g.hp * g.hp, g.dw_positions
    part = torch.full((g.dw_splits, n_k, n_k, cin, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros(part.shape, dtype=torch.int64)
    db_part = torch.full((g.dw_splits, 4, cout), float("nan"), dtype=x.dtype)
    db_writes = torch.zeros(db_part.shape, dtype=torch.int64)
    xflat, gflat = x.reshape(-1), gm.reshape(-1)
    for bx, tap, z in itertools.product(*map(range, g.dw_grid)):
        ci0, co0 = (bx // n_co) * bm, (bx % n_co) * bn
        kh, kw = tap // n_k, tap % n_k
        ph = g.phase_of_sub[2 * (kh % 2) + kw % 2]
        pr, pc, p, q = ph // 2, ph % 2, kh // 2, kw // 2
        ci, co = ci0 + torch.arange(bm), co0 + torch.arange(bn)
        do_db = with_db and p == 0 and q == 0 and ci0 == 0
        acc = torch.zeros((bm, bn), dtype=x.dtype)
        dbacc = torch.zeros(bn, dtype=x.dtype)
        k_begin = z * g.dw_positions_per_split
        k_end = min(pos, k_begin + g.dw_positions_per_split)
        for k0 in range(k_begin, k_end, bw.BK):
            k = k0 + torch.arange(bw.BK)
            bb, rem = k // plane, k % plane
            t, u = rem // g.hp, rem % g.hp
            oh, ow = 2 * t + pr, 2 * u + pc
            gok = (k < k_end) & (oh < m) & (ow < m)
            ih = g.row0s[pr] + t + p - g.pad_lo
            iw = g.col0s[pc] + u + q - g.pad_lo
            xok = gok & (ih >= 0) & (ih < n_in) & (iw >= 0) & (iw < n_in)
            xsrc = ((bb * n_in + ih) * n_in + iw) * cin
            gsrc = ((bb * m + oh) * m + ow) * cout
            a = _gather(xflat, xsrc[:, None] + ci[None, :],
                        xok[:, None] & (ci < cin)[None, :])
            bmat = _gather(gflat, gsrc[:, None] + co[None, :],
                           gok[:, None] & (co < cout)[None, :])
            acc += a.T @ bmat
            if do_db:
                dbacc += bmat.sum(0)
        ci_ok, co_ok = ci[ci < cin], co[co < cout]
        part[z, kh, kw][ci_ok[:, None], co_ok[None, :]] = acc[ci < cin][:, co < cout]
        writes[z, kh, kw][ci_ok[:, None], co_ok[None, :]] += 1
        if do_db:
            db_part[z, ph, co_ok] = dbacc[co < cout]
            db_writes[z, ph, co_ok] += 1
    dw = part[0]
    for z in range(1, g.dw_splits):
        dw = dw + part[z]
    db = db_part.reshape(-1, cout)
    db_sum = db[0]
    for i in range(1, db.shape[0]):
        db_sum = db_sum + db[i]
    return dw, db_sum, writes, db_writes


EMU_CASES = [   # (b, N, n, P, Cin, Cout)
    (2, 4, 4, 2, 5, 3),      # DCGAN geometry, Cout = 3 (the 128 x 16 dw tile)
    (1, 7, 3, 0, 3, 19),     # odd M = 11, Cout not a multiple of 16
    (1, 6, 5, 1, 70, 6),     # n = 5, odd P, two Cin blocks of dx
    (2, 5, 3, 1, 2, 20),     # odd M = 11, odd P
    (1, 9, 2, 1, 4, 33),     # n = 2, M = 18
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
    assert g.dw_splits > 1 and g.dw_tile == (128, 16)
    b, n_in, n_k, pad, cin, cout = shape
    x, _, _, gm = _case(9, b, n_in, n_k, pad, cin, cout, dtype=np.float64)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gm)
    dw, db, writes, _ = emulate_dw_kernel(tx, tg, n_k, pad)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want_dw, want_db = bw.transpose_conv2d_dw_plain(tx, tg, n_k, pad, with_db=True)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_db, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ wrappers

def test_cpu_tensors_run_plain_without_launching():
    counters = (bw.epilogue_grad, bw.transpose_conv2d_dx, bw.transpose_conv2d_dw)
    before = [c.launches for c in counters]
    x, k, bias, g = _case(2, 1, 4, 4, 2, 2, 3)
    tx, tk, tg = map(torch.from_numpy, (x, k, g))
    bw.transpose_conv2d_bwd(tx, tk, tg, 2, epilogue=EPILOGUES[3], y=torch.tanh(tg))
    assert [c.launches for c in counters] == before


def test_composer_needs_y_for_an_activation():
    x, k, _, g = _case(2, 1, 4, 4, 2, 2, 3)
    with pytest.raises(ValueError, match="saved output"):
        bw.transpose_conv2d_bwd(*map(torch.from_numpy, (x, k, g)), 2,
                                epilogue=EPILOGUES[2])
