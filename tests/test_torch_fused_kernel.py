"""Port of the phase-fused kernel (repro_torch.kernels.transpose_conv2d).

On the CPU: the plain version against the JAX package's oracles and lax
form across geometries and every epilogue; the launch geometry; and an
emulation of the CUDA kernel's block-level index math (staged halo tile,
sub-kernel reads straight from the HWIO kernel, phase origins, masked
stores) that must reproduce the same function and write every output once.
The JAX package's own fused kernel cannot run under the installed JAX
(``pl.unblocked`` is gone), so it is not called. The card tests are in
``test_torch_cuda.py``.
"""
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


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout", [
    (8, 8, 4, 2, 512, 256),     # DCGAN L1
    (8, 16, 4, 2, 256, 128),    # DCGAN L2
    (8, 32, 4, 2, 128, 3),      # DCGAN L3
    (1, 4, 4, 2, 1024, 512),    # DCGAN L0 pinned to the fused kernel
    (2, 7, 3, 0, 37, 19),       # odd M = 11
    (2, 6, 5, 1, 20, 70),       # n = 5, odd P
    (3, 9, 7, 3, 5, 33),        # R = 4
])
def test_geometry_covers_plane_and_fits(b, n_in, n_k, pad, cin, cout):
    g = tcf.fused_geometry(b, n_in, n_k, pad, cin, cout)
    assert g.m == 2 * n_in - n_k + 2 * pad and g.hp == (g.m + 1) // 2
    assert g.th * g.tw <= tcf.POSITIONS_PER_BLOCK
    assert g.n_h * g.th >= g.hp and (g.n_h - 1) * g.th < g.hp
    assert g.n_w * g.tw >= g.hp and (g.n_w - 1) * g.tw < g.hp
    assert g.xh == g.th + max(g.roffs) + g.r - 1
    assert g.xw == g.tw + max(g.coffs) + g.r - 1
    assert g.ct in (4, 8, 16, 32) and g.n_co * g.ct >= cout
    assert g.threads == g.ct // 4 * 32 <= 256
    assert g.smem_bytes <= 227 * 1024 and g.ci_chunk == tcf.CIN_CHUNK
    assert g.grid == (g.n_h * g.n_w, g.n_co, b)


def test_cout_tile_rule():
    assert tcf.fused_geometry(8, 32, 4, 2, 128, 3).ct == 4       # Cout = 3
    assert tcf.fused_geometry(8, 8, 4, 2, 512, 256).ct == 8      # fill SMs
    assert tcf.fused_geometry(64, 32, 4, 2, 64, 64).ct == 32     # large grid


# ------------------------------------------- emulation of the CUDA kernel

def emulate_fused_kernel(x, kernel, padding, epi=None, bias=None):
    """What csrc/transpose_conv2d_fused.cu computes, block by block, with
    its own index arithmetic (threads vectorised). Unwritten outputs stay
    NaN; a halo read past the staged tile raises IndexError."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = tcf.fused_geometry(b_, n_in, n_k, padding, cin, cout)
    R, CI, CT = g.r, g.ci_chunk, g.ct
    out = torch.full((b_, g.m, g.m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros((b_, g.m, g.m, cout), dtype=torch.int64)
    pos = torch.arange(32)[:, None] + 32 * torch.arange(2)[None, :]
    live = pos < g.th * g.tw
    pos = torch.where(live, pos, torch.zeros_like(pos))
    tl, ul = pos // g.tw, pos % g.tw
    for bx, by, bb in itertools.product(range(g.n_h * g.n_w), range(g.n_co),
                                        range(b_)):
        t0, u0, co0 = (bx // g.n_w) * g.th, (bx % g.n_w) * g.tw, by * CT
        acc = torch.zeros((4, 32, 2, CT), dtype=x.dtype)
        for ci0 in range(0, cin, CI):
            xs = torch.zeros((CI, g.xh, g.xw), dtype=x.dtype)
            for r, c in itertools.product(range(g.xh), range(g.xw)):
                gr = g.base_r + t0 + r - g.pad_lo
                gc = g.base_c + u0 + c - g.pad_lo
                if 0 <= gr < n_in and 0 <= gc < n_in:
                    n_ci = min(CI, cin - ci0)
                    xs[:n_ci, r, c] = x[bb, gr, gc, ci0 : ci0 + n_ci]
            ws = torch.zeros((4, R, R, CI, CT), dtype=x.dtype)
            for s, p, q in itertools.product(range(4), range(R), range(R)):
                kh, kw = 2 * p + (s >> 1), 2 * q + (s & 1)
                if kh < n_k and kw < n_k:
                    blk = kernel[kh, kw, ci0 : ci0 + CI, co0 : co0 + CT]
                    ws[s, p, q, : blk.shape[0], : blk.shape[1]] = blk
            for ci in range(CI):  # channels past Cin are staged as zeros
                for p, q, par in itertools.product(range(R), range(R), range(4)):
                    pr, pc = par >> 1, par & 1
                    wv = ws[g.wsels[par], p, q, ci]
                    ri, cj = tl + g.roffs[pr] + p, ul + g.coffs[pc] + q
                    if ri.max() >= g.xh or cj.max() >= g.xw:
                        raise IndexError("read past the staged tile")
                    xv = xs[ci, ri, cj]
                    acc[par] += xv[..., None] * wv
        for par, pg, j in itertools.product(range(4), range(32), range(2)):
            oh = 2 * (t0 + int(tl[pg, j])) + (par >> 1)
            ow = 2 * (u0 + int(ul[pg, j])) + (par & 1)
            if not live[pg, j] or oh >= g.m or ow >= g.m:
                continue
            n_c = min(CT, cout - co0)
            y = acc[par, pg, j, :n_c]
            if epi is not None:
                y = epi.apply(y, bias[co0 : co0 + n_c] if epi.bias else None)
            out[bb, oh, ow, co0 : co0 + n_c] = y
            writes[bb, oh, ow, co0 : co0 + n_c] += 1
    return out, writes


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout,epi", [
    (2, 4, 4, 2, 5, 3, EPILOGUES[4]),      # DCGAN geometry, Cout = 3
    (1, 7, 3, 0, 3, 19, EPILOGUES[2]),     # odd M = 11, Cout % tile != 0
    (1, 6, 5, 1, 17, 6, EPILOGUES[3]),     # n = 5, odd P, two cin chunks
    (1, 12, 4, 3, 2, 9, EPILOGUES[1]),     # odd P, two spatial tiles
    (1, 9, 3, 2, 2, 40, None),             # n = 3, even P, two cout tiles
])
def test_emulated_kernel_matches_oracle(b, n_in, n_k, pad, cin, cout, epi):
    x, k, bias = _case(b + n_in + cout, b, n_in, cin, n_k, cout,
                       dtype=np.float64)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    got, writes = emulate_fused_kernel(tx, tk, pad, epi, tb)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want = jref.conventional_ref(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(k, jnp.float32), pad)
    if epi is not None:
        want = _jax_epi(epi).apply(want, jnp.asarray(bias, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


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
    before = tcf.transpose_conv2d_fused.launches
    x, k, _ = _case(3, 1, 4, 2, 4, 2)
    tcf.transpose_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert tcf.transpose_conv2d_fused.launches == before

