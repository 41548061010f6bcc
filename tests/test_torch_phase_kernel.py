"""Port of the per-phase kernel (``transpose_conv2d_phase`` in
repro_torch.kernels.transpose_conv2d) and of the ``phase`` plan method.

On the CPU: the plain version against the JAX package's own per-phase
Pallas kernel (which still interprets under the installed JAX) across
geometries and every epilogue; the launch geometry; an emulation of the
CUDA kernel's block-level index math (one parity a block, its own staged
window and sub-kernel, masked stores) that must reproduce the same function
and write every output once; the autograd Function's gradients against
``jax.grad`` of the reference's phase op; and the phase-pinned generator's
gradients against the default plan's. The card tests are in
``test_torch_cuda.py``.
"""
import itertools

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


@pytest.mark.parametrize("b,n_in,n_k,pad,cin,cout", [
    (8, 4, 4, 2, 1024, 512),    # DCGAN L0
    (8, 8, 4, 2, 512, 256),     # DCGAN L1
    (8, 16, 4, 2, 256, 128),    # DCGAN L2
    (8, 32, 4, 2, 128, 3),      # DCGAN L3
    (2, 7, 3, 0, 37, 19),       # odd M = 11
    (3, 9, 7, 3, 5, 33),        # R = 4
])
def test_geometry_covers_plane_and_fits(b, n_in, n_k, pad, cin, cout):
    g = tcf.phase_geometry(b, n_in, n_k, pad, cin, cout)
    assert g.m == 2 * n_in - n_k + 2 * pad and g.hp == (g.m + 1) // 2
    assert g.th * g.tw <= tcf.POSITIONS_PER_BLOCK
    assert g.n_h * g.th >= g.hp and (g.n_h - 1) * g.th < g.hp
    assert g.n_w * g.tw >= g.hp and (g.n_w - 1) * g.tw < g.hp
    assert (g.xh, g.xw) == (g.th + g.r - 1, g.tw + g.r - 1)
    assert g.ct in (4, 8, 16, 32) and g.n_co * g.ct >= cout
    assert g.grid == (g.n_h * g.n_w, g.n_co, 4 * b)
    assert g.smem_bytes <= 227 * 1024


# ------------------------------------------- emulation of the CUDA kernel

def emulate_phase_kernel(x, kernel, padding, epi=None, bias=None):
    """What csrc/transpose_conv2d_phase.cu computes, block by block, with its
    own index arithmetic (threads vectorised). Unwritten outputs stay NaN;
    a read past the staged window raises IndexError."""
    b_, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = tcf.phase_geometry(b_, n_in, n_k, padding, cin, cout)
    R, CI, CT = g.r, g.ci_chunk, g.ct
    out = torch.full((b_, g.m, g.m, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros((b_, g.m, g.m, cout), dtype=torch.int64)
    pos = torch.arange(32)[:, None] + 32 * torch.arange(2)[None, :]
    live = pos < g.th * g.tw
    pos = torch.where(live, pos, torch.zeros_like(pos))
    tl, ul = pos // g.tw, pos % g.tw
    for bx, by, bz in itertools.product(range(g.n_h * g.n_w), range(g.n_co),
                                        range(4 * b_)):
        bb, par = bz >> 2, bz & 3
        pr, pc, s = par >> 1, par & 1, g.wsels[par]
        t0, u0, co0 = (bx // g.n_w) * g.th, (bx % g.n_w) * g.tw, by * CT
        gr0 = g.row0s[pr] + t0 - g.pad_lo
        gc0 = g.col0s[pc] + u0 - g.pad_lo
        acc = torch.zeros((32, 2, CT), dtype=x.dtype)
        for ci0 in range(0, cin, CI):
            xs = torch.zeros((CI, g.xh, g.xw), dtype=x.dtype)
            n_ci = min(CI, cin - ci0)
            for r, c in itertools.product(range(g.xh), range(g.xw)):
                if 0 <= gr0 + r < n_in and 0 <= gc0 + c < n_in:
                    xs[:n_ci, r, c] = x[bb, gr0 + r, gc0 + c, ci0 : ci0 + n_ci]
            ws = torch.zeros((R, R, CI, CT), dtype=x.dtype)
            for p, q in itertools.product(range(R), range(R)):
                kh, kw = 2 * p + (s >> 1), 2 * q + (s & 1)
                if kh < n_k and kw < n_k:
                    blk = kernel[kh, kw, ci0 : ci0 + CI, co0 : co0 + CT]
                    ws[p, q, : blk.shape[0], : blk.shape[1]] = blk
            for ci, p, q in itertools.product(range(CI), range(R), range(R)):
                ri, cj = tl + p, ul + q
                if ri.max() >= g.xh or cj.max() >= g.xw:
                    raise IndexError("read past the staged window")
                acc += xs[ci, ri, cj][..., None] * ws[p, q, ci]
        for pg, j in itertools.product(range(32), range(2)):
            oh = 2 * (t0 + int(tl[pg, j])) + pr
            ow = 2 * (u0 + int(ul[pg, j])) + pc
            if not live[pg, j] or oh >= g.m or ow >= g.m:
                continue
            n_c = min(CT, cout - co0)
            y = acc[pg, j, :n_c]
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
    got, writes = emulate_phase_kernel(tx, tk, pad, epi, tb)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
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


# ------------------------------------------------------------- wrapper

def test_wrapper_checks_operands():
    x = torch.zeros((1, 4, 4, 3))
    k = torch.zeros((4, 4, 3, 2))
    with pytest.raises(ValueError, match="disagree"):
        tcf.transpose_conv2d_phase(x, k, 2, epilogue=EPILOGUES[1])
    with pytest.raises(ValueError, match="Cin"):
        tcf.transpose_conv2d_phase(x, torch.zeros((4, 4, 5, 2)), 2)


def test_cpu_tensor_runs_plain_without_launching():
    before = tcf.transpose_conv2d_phase.launches
    x, k, _ = _case(3, 1, 4, 2, 4, 2)
    tcf.transpose_conv2d_phase(torch.from_numpy(x), torch.from_numpy(k), 2)
    assert tcf.transpose_conv2d_phase.launches == before


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
