"""Port of the implicit-GEMM kernel (repro_torch.kernels.transpose_conv2d_gemm).

On the CPU: the plain version against the JAX package's Pallas GEMM kernel
in interpret mode (which runs under the installed JAX) across odd kernels,
odd paddings and every epilogue; the launch geometry and phase-major row
order; and an emulation of the CUDA kernel's index math (row decode, tap
predicate, per-block tap skip, masked tiles) that must reproduce the same
function and write every output once. The card tests are in
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

@pytest.mark.parametrize("b,n_in,n_k,pad", [
    (8, 4, 4, 2), (1, 4, 4, 2), (2, 7, 3, 0), (3, 5, 5, 1), (1, 3, 4, 3),
])
def test_row_order_is_a_bijection_onto_outputs(b, n_in, n_k, pad):
    """Phase-major rows cover every (b, oh, ow) exactly once; the rest of
    the 4*B*Hp*Hp rows (odd M) and of the last block are invalid."""
    g = tcg.gemm_geometry(b, n_in, n_k, pad, 3, 3)
    r = torch.arange(g.n_m * tcg.BLOCK_ROWS)
    bb, oh, ow, ok = tcg.row_decode(g, r)
    assert g.rows == 4 * b * g.hp * g.hp >= b * g.m * g.m
    assert int(ok.sum()) == b * g.m * g.m
    flat = (bb[ok] * g.m + oh[ok]) * g.m + ow[ok]
    assert torch.equal(torch.sort(flat).values, torch.arange(b * g.m * g.m))
    parity = (oh % 2) * 2 + ow % 2
    assert torch.equal(parity[ok], (r[ok] // (b * g.hp * g.hp)))


def _taps_run(g):
    """Taps each row block runs: those at least one valid row reads."""
    runs = []
    for bx in range(g.n_m):
        r = bx * tcg.BLOCK_ROWS + torch.arange(tcg.BLOCK_ROWS)
        _, oh, ow, ok = tcg.row_decode(g, r)
        n = 0
        for kh, kw in itertools.product(range(g.n_k), range(g.n_k)):
            _, vr = tcg.tap_source(g, oh, kh)
            _, vc = tcg.tap_source(g, ow, kw)
            n += bool((ok & vr & vc).any())
        runs.append(n)
    return runs


def test_head_layer_blocks_skip_parity_zero_taps():
    """DCGAN L0 (4x4 kernel, P=2): a block of one output parity runs the 4
    taps that parity reads, not all 16; at batch 1 a block spans two
    parities and runs 8."""
    assert set(_taps_run(tcg.gemm_geometry(8, 4, 4, 2, 1024, 512))) == {4}
    assert set(_taps_run(tcg.gemm_geometry(1, 4, 4, 2, 1024, 512))) == {8}


def test_tap_source_floors_only_even_nonnegative():
    g = tcg.gemm_geometry(1, 3, 3, 1, 1, 1)
    o = torch.arange(g.m)
    for k in range(3):
        src, ok = tcg.tap_source(g, o, k)
        a = o + k - 1
        want = (a >= 0) & (a % 2 == 0) & (a // 2 < 3)
        assert torch.equal(ok, want)
        assert torch.equal(src[ok], a[ok] // 2)


# ------------------------------------------- emulation of the CUDA kernel

BK = 16


def _c_tap_source(oh, ow, kh, kw, n, pad):
    ar, ac = oh + kh - pad, ow + kw - pad
    if ar < 0 or ac < 0 or ar & 1 or ac & 1:
        return -1
    if ar >> 1 >= n or ac >> 1 >= n:
        return -1
    return (ar >> 1) * n + (ac >> 1)


def emulate_gemm_kernel(x, kernel, padding, epi=None, bias=None):
    """What csrc/transpose_conv2d_gemm.cu computes, block by block, with
    its own integer arithmetic. Unwritten outputs stay NaN."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = tcg.gemm_geometry(b_, n_in, n_k, padding, cin, cout)
    BM, BN = tcg.BLOCK_ROWS, tcg.BLOCK_COUT
    xf = x.reshape(-1, cin)
    out = torch.full((b_, g.m, g.m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros((b_, g.m, g.m, cout), dtype=torch.int64)
    for bx, by in itertools.product(range(g.n_m), range(g.n_co)):
        m0, co0 = bx * BM, by * BN
        rb, roh, rw = [], [], []
        for tid in range(BM):
            r = m0 + tid
            plane = g.hp * g.hp
            per_phase = b_ * plane
            ph, rem = r // per_phase, r % per_phase
            tu = rem % plane
            oh = 2 * (tu // g.hp) + (ph >> 1)
            ow = 2 * (tu % g.hp) + (ph & 1)
            ok = ph < 4 and oh < g.m and ow < g.m
            rb.append(rem // plane if ok else -1)
            roh.append(oh)
            rw.append(ow)
        acc = torch.zeros((BM, BN), dtype=x.dtype)
        for tap in range(n_k * n_k):
            kh, kw = tap // n_k, tap % n_k
            src = [_c_tap_source(roh[i], rw[i], kh, kw, n_in, padding)
                   if rb[i] >= 0 else -1 for i in range(BM)]
            if max(src) < 0:
                continue
            for ci0 in range(0, cin, BK):
                a = torch.zeros((BM, BK), dtype=x.dtype)
                for i in range(BM):
                    if src[i] >= 0:
                        row = xf[rb[i] * n_in * n_in + src[i], ci0 : ci0 + BK]
                        a[i, : row.shape[0]] = row
                bt = torch.zeros((BK, BN), dtype=x.dtype)
                blk = kernel[kh, kw, ci0 : ci0 + BK, co0 : co0 + BN]
                bt[: blk.shape[0], : blk.shape[1]] = blk
                acc += a @ bt
        n_c = min(BN, cout - co0)
        for i in range(BM):
            if rb[i] < 0:
                continue
            y = acc[i, :n_c]
            if epi is not None:
                y = epi.apply(y, bias[co0 : co0 + n_c] if epi.bias else None)
            out[rb[i], roh[i], rw[i], co0 : co0 + n_c] = y
            writes[rb[i], roh[i], rw[i], co0 : co0 + n_c] += 1
    return out, writes


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout,epi", [
    (2, 4, 4, 2, 18, 3, EPILOGUES[4]),     # DCGAN L0 geometry, cin > BK
    (1, 5, 3, 0, 3, 70, EPILOGUES[2]),     # odd M = 7, Cout % BN != 0
    (1, 4, 5, 1, 2, 5, EPILOGUES[3]),      # n = 5, odd P
    (3, 3, 4, 3, 2, 4, EPILOGUES[1]),      # odd P, rows straddle blocks
    (1, 6, 3, 2, 2, 2, None),
])
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


def test_cpu_tensor_runs_plain_without_launching():
    before = tcg.transpose_conv2d_gemm.launches
    x, k, _ = _case(3, 1, 4, 2, 4, 2)
    tcg.transpose_conv2d_gemm(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert tcg.transpose_conv2d_gemm.launches == before

