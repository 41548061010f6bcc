"""Port of the layer-pair kernel and the plan's pair pass
(repro_torch.kernels.transpose_conv2d_pair, repro_torch.kernels.plan).
Ports of ``tests/test_pair_fusion.py`` with the Hopper budget in place of
the TPU's VMEM.

On the CPU: the plain version against the JAX package's own pair kernel
(which still interprets under the installed JAX); an emulation of the CUDA
kernel's index math (cluster ranks over interface quads and row bands, the
ring, the warps' contraction splits, the consumer staging windows from the
owners' slices) that must produce each interface element once, write each
output once, and give the plain version's result; the launch arguments of
every zoo pair at buckets 1-8;
the zoo classification and ``pair_legal``'s reasons; the pair pass; the
fused generator against the reference's fused generator on the same
weights; pair gradients; and the memory the pairs keep on chip. The card
tests are in ``test_torch_cuda.py``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jepi
from repro.kernels import ops as jops
from repro.kernels import plan as jplan
from repro.kernels import ref as jref
from repro.kernels import transpose_conv2d_pair as jpair
from repro.models import gan as jgan
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import plan as planlib
from repro_torch.kernels import transpose_conv2d_pair as pairlib
from repro_torch.models import gan
from repro_torch.weights import from_jax_params

RELU = epilib.Epilogue(bias=True, act="relu")
TANH = epilib.Epilogue(bias=True, act="tanh")
LEAKY = epilib.Epilogue(bias=True, act="leaky_relu", slope=0.2)
BIAS = epilib.Epilogue(bias=True)

PAIRS = [  # (n_in, n_k, P, C0, C1, C2)
    (4, 4, 2, 8, 6, 4),      # DCGAN geometry
    (5, 3, 1, 3, 5, 2),      # odd extent, odd kernel, odd P
    (7, 5, 2, 2, 3, 3),      # odd extent + n = 5
    (6, 4, 1, 2, 2, 2),      # P < n // 2
    (5, 3, 3, 4, 7, 5),      # odd P = 3
]


def _jax_epi(epi):
    if epi is None:
        return None
    return jepi.Epilogue(bias=epi.bias, act=epi.act, slope=epi.slope)


def _pair_data(seed, n_in, n_k, c0, c1, c2, batch=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n_in, n_in, c0)).astype(dtype)
    k1 = (rng.standard_normal((n_k, n_k, c0, c1))
          * (n_k * n_k * c0) ** -0.5).astype(dtype)
    k2 = (rng.standard_normal((n_k, n_k, c1, c2))
          * (n_k * n_k * c1) ** -0.5).astype(dtype)
    b1 = rng.standard_normal((c1,)).astype(dtype)
    b2 = rng.standard_normal((c2,)).astype(dtype)
    return x, k1, k2, b1, b2


# --------------------------------------------------------- kernel numerics

@pytest.mark.parametrize("e1,e2", [(LEAKY, TANH), (None, None), (RELU, BIAS)],
                         ids=["leaky-tanh", "none", "relu-bias"])
@pytest.mark.parametrize("n_in,n_k,pad,c0,c1,c2", PAIRS)
def test_plain_matches_reference_pair_kernel(n_in, n_k, pad, c0, c1, c2, e1,
                                             e2):
    x, k1, k2, b1, b2 = _pair_data(n_in + c0, n_in, n_k, c0, c1, c2)
    t = torch.from_numpy
    got = pairlib.transpose_conv2d_pair(
        t(x), t(k1), t(k2), pad, epilogue1=e1, bias1=t(b1) if e1 else None,
        epilogue2=e2, bias2=t(b2) if e2 else None,
    ).numpy()
    want = jpair.transpose_conv2d_pair_pallas(
        jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2), pad,
        epilogue1=_jax_epi(e1), bias1=jnp.asarray(b1) if e1 else None,
        epilogue2=_jax_epi(e2), bias2=jnp.asarray(b2) if e2 else None,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_in,n_k,pad", [(4, 4, 2), (5, 3, 1), (7, 5, 2),
                                          (6, 4, 1), (5, 3, 3), (16, 4, 2)])
def test_pair_geometry_is_the_reference(n_in, n_k, pad):
    assert pairlib.pair_geometry(n_in, n_k, pad) == jpair.pair_geometry(
        n_in, n_k, pad)


def test_wrapper_checks_operands_and_runs_plain_on_cpu():
    x, k1, k2, b1, b2 = map(torch.from_numpy, _pair_data(0, 4, 4, 3, 4, 2))
    with pytest.raises(ValueError, match="chain"):
        pairlib.transpose_conv2d_pair(x, k1, k1, 2)
    with pytest.raises(ValueError, match="disagree"):
        pairlib.transpose_conv2d_pair(x, k1, k2, 2, epilogue1=RELU)
    before = pairlib.transpose_conv2d_pair.launches
    pairlib.transpose_conv2d_pair(x, k1, k2, 2, epilogue1=RELU, bias1=b1)
    assert pairlib.transpose_conv2d_pair.launches == before


# ------------------------------------------- emulation of the CUDA kernel

def _emulate_tile(t, cin, cout, w, n_k, co0, nst, ring, wsels, r, d,
                  stage_x, emit):
    """One ``run_tile`` of csrc/transpose_conv2d_pair.cu, thread by thread
    (threads vectorised): the ring of ``ring`` slots filled ``ring - 1``
    stages ahead, each thread's micro-tile from its split's quad of a stage,
    then the splits' sums added in split order and handed to ``emit(v,
    out_row, out_col, channel)``. ``stage_x(st)`` returns the staged input
    window ``[ks][xh][xp][4]`` of stage ``st`` (pitch columns past ``xwr``
    NaN, so a stray read shows)."""
    nt, pw, wrow = pairlib.THREADS, pairlib.PW, 4 * r * r
    npg = t.th * t.tw // pw
    nts = t.ncg * npg
    tid = torch.arange(nt)
    s, tis = tid // nts, tid % nts
    active = s < t.ks
    cgi, pg = tis // npg, tis % npg
    pgr = t.tw // pw
    tr, tc = pg // pgr, (pg % pgr) * pw
    sa, ca, tra, tca = (v[active] for v in (s, cgi, tr, tc))
    ci_n = 4 * t.ks

    def stage_w(st):
        # [ci][tap][quad][4] of k's rows [ci_n st, ci_n (st + 1)), zero past
        # the kernel's taps and channels
        ws = torch.zeros((ci_n, wrow, t.ncg, 4), dtype=w.dtype)
        for spq in range(wrow):
            sub, p, q = spq // (r * r), spq // r % r, spq % r
            kh, kw = 2 * p + (sub >> 1), 2 * q + (sub & 1)
            if kh >= n_k or kw >= n_k:
                continue
            for cq in range(t.ncg):
                ci0, c = st * ci_n, co0 + 4 * cq
                n_ci, n_co = min(ci_n, cin - ci0), min(4, cout - c)
                if n_ci > 0 and n_co > 0:
                    ws[:n_ci, spq, cq, :n_co] = w[kh, kw, ci0 : ci0 + n_ci, c : c + n_co]
        return ws

    slots = [None] * ring

    def stage(st):
        slots[st % ring] = (st, stage_x(st), stage_w(st))

    acc = torch.zeros((int(active.sum()), 4, pw, 4), dtype=w.dtype)
    for st in range(ring - 1):
        if st < nst:
            stage(st)
    for k in range(nst):
        if k + ring - 1 < nst:
            assert (k + ring - 1) % ring != k % ring   # never the slot in use
            stage(k + ring - 1)
        got, xs, ws = slots[k % ring]
        assert got == k
        for rho in range(r + d):
            for pr in range(2):
                p = rho - pr * d
                if not 0 <= p < r:
                    continue
                for q in range(r):
                    for pc in range(2):
                        par = 2 * pr + pc
                        cols = tca[:, None] + torch.arange(pw) + pc * d + q
                        if int((tra + rho).max()) >= t.xh or int(cols.max()) >= t.xwr:
                            raise IndexError("read past the staged window")
                        xv = xs[sa[:, None], (tra + rho)[:, None], cols]   # (T, j, cc)
                        spq = (wsels[par] * r + p) * r + q
                        wv = ws[4 * sa[:, None] + torch.arange(4), spq, ca[:, None]]
                        acc[:, par] += torch.einsum("tjc,tck->tjk", xv, wv)
    # the splits' sums [split][slot][micro-tile], added in split order
    red = torch.full((t.ks, 4 * pw * 4, nts), float("nan"), dtype=w.dtype)
    red[sa, :, tis[active]] = acc.reshape(-1, 4 * pw * 4)
    ct = 4 * t.ncg
    for i in range(4 * pw * 4 * nts):
        c, ocol, orow = i % ct, i // ct % (2 * t.tw), i // ct // (2 * t.tw)
        par, u = 2 * (orow & 1) + (ocol & 1), ocol >> 1
        slot = (par * pw + u % pw) * 4 + (c & 3)
        at = (c >> 2) * npg + (orow >> 1) * pgr + u // pw
        v = red[0, slot, at]
        for z in range(1, t.ks):
            v = v + red[z, slot, at]
        emit(v, orow, ocol, c)


def emulate_pair_kernel(x, k1, k2, padding, e1=None, b1=None, e2=None,
                        b2=None):
    """What csrc/transpose_conv2d_pair.cu computes, block by block: each
    cluster rank's interface quads over its band of padded rows,
    ``[qpr][rpb][s2][4]``, in its own buffer (the zero halo around them)
    from its producer tiles, then the consumer's work tiles round-robin
    over the ranks, each ring stage staging its interface window from the
    owners' buffers. Returns the
    output, how many times each interface element and each output element
    was written, and the shared memory (bytes) the emulated buffers take in
    one block."""
    b_, n_in, _, c0 = x.shape
    n_k, c1, c2 = k1.shape[0], k1.shape[3], k2.shape[3]
    g = pairlib.pair_launch_geometry(n_in, n_k, padding, c0, c1, c2)
    r, d = g.r, g.d
    out = torch.full((b_, g.m2, g.m2, c2), float("nan"), dtype=x.dtype)
    out_writes = torch.zeros((b_, g.m2, g.m2, c2), dtype=torch.int64)
    if_writes = torch.zeros((b_, c1, g.s2, g.s2), dtype=torch.int64)

    def window(t):
        xs = torch.zeros((t.ks, t.xh, t.xp, 4), dtype=x.dtype)
        xs[:, :, t.xwr:] = float("nan")     # the pitch's columns: never read
        return xs

    for bb in range(b_):
        ifaces = [torch.zeros((g.qpr, g.rpb, g.s2, 4), dtype=x.dtype)
                  for _ in range(g.cl)]
        # ---- producer, one rank at a time: its quads over its row band
        t = g.t1
        for rank in range(g.cl):
            c1_lo = rank // g.n_bands * g.mc
            c1_hi = min(c1_lo + g.mc, c1)
            r0 = rank % g.n_bands * g.rpb
            oh_lo, oh_hi = max(0, r0 - g.pad_lo2), min(g.m1, r0 + g.rpb - g.pad_lo2)
            t_lo = oh_lo // 2
            n_sp = (-(-((oh_hi + 1) // 2 - t_lo) // t.th) * g.n_w1
                    if oh_hi > oh_lo else 0)
            for tile in range(n_sp * g.nct1):
                sp = tile % n_sp
                t0, u0 = t_lo + (sp // g.n_w1) * t.th, (sp % g.n_w1) * t.tw
                co0 = c1_lo + (tile // n_sp) * 4 * t.ncg

                def stage_x(st):
                    xs = window(t)
                    for q4, rr, cc in itertools.product(range(t.ks), range(t.xh),
                                                        range(t.xwr)):
                        gr, gc = g.org1r + t0 + rr, g.org1c + u0 + cc
                        gci = (st * t.ks + q4) * 4
                        n = min(4, c0 - gci)
                        if 0 <= gr < n_in and 0 <= gc < n_in and n > 0:
                            xs[q4, rr, cc, :n] = x[bb, gr, gc, gci : gci + n]
                    return xs

                def emit(v, orow, ocol, c):
                    oh, ow, ch = 2 * t0 + orow, 2 * u0 + ocol, co0 + c
                    if not oh_lo <= oh < oh_hi or ow >= g.m1 or ch >= c1_hi:
                        return
                    if e1 is not None:
                        v = e1.apply(v, b1[ch] if e1.bias else None)
                    cl_, rr, cc = ch - c1_lo, g.pad_lo2 + oh, g.pad_lo2 + ow
                    ifaces[rank][cl_ >> 2, rr - r0, cc, cl_ & 3] = v
                    if_writes[bb, ch, rr, cc] += 1

                _emulate_tile(t, c0, c1, k1, n_k, co0, g.nst1, g.ring, g.wsels,
                              r, d, stage_x, emit)
        # ---- consumer: work tiles round-robin over the ranks
        t = g.t2
        for rank in range(g.cl):
            for work in range(rank, g.n_sp2 * g.n_co2, g.cl):
                sp = work % g.n_sp2
                t0, u0 = (sp // g.n_w2) * t.th, (sp % g.n_w2) * t.tw
                co0 = (work // g.n_sp2) * 4 * t.ncg

                def stage_x(st):
                    xs = window(t)
                    for q4, rr, cc in itertools.product(range(t.ks), range(t.xh),
                                                        range(t.xwr)):
                        gq = st * t.ks + q4
                        gr, gc = g.b0r + t0 + rr, g.b0c + u0 + cc
                        if gq * 4 < c1 and gr < g.s2 and gc < g.s2:
                            owner = gq // g.qpr * g.n_bands + gr // g.rpb
                            xs[q4, rr, cc] = ifaces[owner][gq % g.qpr, gr % g.rpb, gc]
                    return xs

                def emit(v, orow, ocol, c):
                    oh, ow, ch = 2 * t0 + orow, 2 * u0 + ocol, co0 + c
                    if oh >= g.m2 or ow >= g.m2 or ch >= c2:
                        return
                    if e2 is not None:
                        v = e2.apply(v, b2[ch] if e2.bias else None)
                    out[bb, oh, ow, ch] = v
                    out_writes[bb, oh, ow, ch] += 1

                _emulate_tile(t, c1, c2, k2, n_k, co0, g.nst2, g.ring, g.wsels,
                              r, d, stage_x, emit)
    wrow = 4 * r * r

    def stage_floats(t):   # a window and the weights
        return t.ks * t.xh * t.xp * 4 + 4 * t.ks * wrow * 4 * t.ncg

    smem = 4 * (g.qpr * g.rpb * g.s2 * 4
                + max(g.ring * stage_floats(g.t1), g.ring * stage_floats(g.t2),
                      pairlib.THREADS * 4 * pairlib.PW * 4))
    return out, if_writes, out_writes, smem


EMULATED = [  # (n_in, n_k, P, C0, C1, C2, batch)
    (4, 4, 2, 64, 32, 16, 2),    # reduced DCGAN head pair (scale 16)
    (16, 4, 2, 16, 8, 2, 1),     # reduced DCGAN tail pair
    (4, 4, 2, 17, 37, 9, 1),     # C1 past one rank's quads, C2 ragged
    (5, 3, 1, 3, 5, 2, 2),       # odd extent, n = 3, odd P
    (7, 5, 3, 2, 10, 5, 1),      # n = 5, odd P = 3; 3 ranks
    (32, 4, 2, 2, 2, 2, 1),      # reduced EB-GAN tail pair: tiled planes
    (4, 4, 2, 256, 64, 8, 1),    # the head producer's in-block split, 8 ring stages
    (3, 8, 3, 6, 10, 4, 1),      # R = 4 on a small plane: idle threads
    (16, 4, 2, 8, 4, 2, 1),      # one interface quad: 9 row bands, odd pad_lo2
]


@pytest.mark.parametrize("n_in,n_k,pad,c0,c1,c2,batch", EMULATED)
def test_emulated_pair_kernel_matches_plain(n_in, n_k, pad, c0, c1, c2,
                                            batch):
    x, k1, k2, b1, b2 = map(torch.from_numpy, _pair_data(
        c0 + c1, n_in, n_k, c0, c1, c2, batch=batch, dtype=np.float64))
    got, if_writes, out_writes, smem = emulate_pair_kernel(
        x, k1, k2, pad, LEAKY, b1, TANH, b2)
    g = pairlib.pair_launch_geometry(n_in, n_k, pad, c0, c1, c2)
    lo, m1 = g.pad_lo2, g.m1
    inner = if_writes[:, :, lo : lo + m1, lo : lo + m1]
    assert int(inner.min()) == 1 and int(inner.max()) == 1
    assert int(if_writes.sum()) == inner.numel()        # the halo stays zero
    assert int(out_writes.min()) == 1 and int(out_writes.max()) == 1
    want = pairlib.transpose_conv2d_pair_plain(
        x, k1, k2, pad, epilogue1=LEAKY, bias1=b1, epilogue2=TANH, bias2=b2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10)
    # the launch asks for what the emulated block holds
    assert 0 <= g.smem_bytes - smem < 32


def test_emulated_cases_reach_the_designs_corners():
    """EMULATED reaches an in-block contraction split at a head producer,
    a ring that wraps, idle threads, 4-byte copies (a ragged C0), more than
    one cluster rank, and interface row bands."""
    geos = [pairlib.pair_launch_geometry(*c[:6]) for c in EMULATED]
    assert any(gg.hp1 <= 4 and gg.ks1 > 1 for gg in geos)
    assert any(max(gg.nst1, gg.nst2) > gg.ring for gg in geos)
    assert any(gg.ncg1 * gg.th1 * gg.tw1 // pairlib.PW * gg.ks1 < pairlib.THREADS
               for gg in geos)
    assert any(c[3] % 4 for c in EMULATED)
    assert any(gg.cl > 1 for gg in geos)
    assert any(gg.n_bands > 1 for gg in geos)


@pytest.mark.parametrize("name", sorted(gan.GAN_ZOO))
def test_pair_geometry_is_batch_free_at_every_zoo_pair(name):
    """At every full-size Table-4 pair the plan fuses, the kernel's launch
    arguments at buckets 1-8 differ in the batch alone: partition, tiles,
    ring and shared memory (and with them every sum's order) come from the
    pair's shape."""
    cfg = gan.GAN_ZOO[name]
    seen = {}
    for bucket in range(1, 9):
        plan = planlib.compile_plan(cfg, bucket, epilogues=gan.generator_epilogues(cfg),
                                    fuse="force")
        for i, e in enumerate(plan.entries):
            if not isinstance(e, planlib.FusedPairPlan):
                continue
            g = pairlib.pair_launch_geometry(e.first.n_in, e.first.n_k, e.first.padding,
                                             e.first.cin, e.first.cout, e.second.cout)
            ints = g.geometry_ints(bucket)
            assert ints[0] == bucket
            seen.setdefault(i, set()).add((tuple(ints[1:]), g.smem_bytes))
    assert seen and all(len(v) == 1 for v in seen.values())


def test_card_shape_lists_reach_every_pair_instance():
    """The card test's PAIR_SHAPES and chip_smoke.py's PAIR_CHECKS each
    launch every compiled (R, d) instance of the pair kernel, and every one
    of their shapes fits a block's shared memory."""
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
        from test_torch_cuda import PAIR_SHAPES
    finally:
        sys.path.remove(root)
    for shapes in (PAIR_SHAPES, chip_smoke.PAIR_CHECKS):
        geos = [pairlib.pair_launch_geometry(s[1], s[2], s[3], *s[4:]) for s in shapes]
        assert {g.variant for g in geos} == pairlib.pair_variants()
        assert all(g.smem_bytes <= pairlib.PAIR_SMEM_BUDGET_BYTES for g in geos)


def test_fast_division_is_exact_where_the_kernel_uses_it():
    """The pair kernel divides copy indices (below 2^16) by run-time
    extents (window planes and rows, quads a rank, rows a band) with a
    multiply by ``m = floor((2^32 - 1) / d) + 1`` and the high word; exact
    for every such n and d."""
    n = np.arange(1 << 16, dtype=np.uint64)
    for d in range(2, 1 << 12):
        m = np.uint64(0xFFFFFFFF // d + 1)
        assert np.array_equal((n * m) >> np.uint64(32), n // np.uint64(d)), d


# ------------------------------------------ shared memory budget, legality

def test_pair_smem_bytes_deterministic_and_monotone():
    a = pairlib.pair_smem_bytes(4, 4, 256, 128, 64, 2)
    assert a == pairlib.pair_smem_bytes(4, 4, 256, 128, 64, 2)
    g = pairlib.pair_launch_geometry(4, 4, 2, 256, 128, 64)
    # a larger plane grows the interface slice every block holds (the ring
    # beside it follows each phase's tile: a 4x4 plane stages the widest
    # weight chunks, so the total need not grow)
    assert pairlib.pair_launch_geometry(8, 4, 2, 256, 128, 64).iface_bytes > g.iface_bytes
    # more interface channels grow each block's slice
    assert pairlib.pair_launch_geometry(4, 4, 2, 256, 256, 64).iface_bytes > g.iface_bytes
    assert g.smem_bytes == a and g.iface_bytes < a
    assert a <= pairlib.PAIR_SMEM_BUDGET_BYTES
    assert (g.cl * g.mc >= 128 and (g.cl - 1) * g.mc < 128
            and g.cl <= pairlib.CLUSTER_MAX)


def test_zoo_fusion_classification_full_size():
    """Full-size zoo, plan compile only: every head pair fits the Hopper
    budget; EB-GAN's 64x64x128->64->64 tail pair needs a 540,800 B interface
    slice per block (128 x 128 x 64 fp32 over 8 blocks, halo included) and
    stays per layer. The same classification as the reference's."""
    expected = {
        "dcgan": [True, True],
        "artgan": [True, True],
        "gpgan": [True, True],
        "ebgan": [True, True, False],
    }
    for name, want in expected.items():
        cfg = gan.GAN_ZOO[name]
        plan = planlib.compile_plan(
            cfg, 1, epilogues=gan.generator_epilogues(cfg), fuse="force"
        )
        got = [isinstance(e, planlib.FusedPairPlan) for e in plan.entries]
        assert got == [w for w in want if w] + [False] * (2 * want.count(False))
        assert len(plan) == len(cfg.layers)
        for i, ok in enumerate(want):
            (hw, c0, c1), (_, _, c2) = cfg.layers[2 * i], cfg.layers[2 * i + 1]
            need = pairlib.pair_smem_bytes(hw, 4, c0, c1, c2, 2)
            assert (need <= pairlib.PAIR_SMEM_BUDGET_BYTES) == ok, (name, i)


def test_pair_legal_reasons():
    lp1 = planlib.plan_layer(2, 4, 4, 8, 6, 2, epilogue=RELU)
    lp2 = planlib.plan_layer(2, 8, 4, 6, 4, 2, epilogue=RELU)
    ok, why = planlib.pair_legal(lp1, lp2)
    assert ok, why

    ok, why = planlib.pair_legal(planlib.plan_layer(2, 4, 4, 8, 6, 2), lp2)
    assert not ok and "bias" in why

    lp2_badchain = planlib.plan_layer(2, 8, 4, 5, 4, 2, epilogue=RELU)
    ok, why = planlib.pair_legal(lp1, lp2_badchain)
    assert not ok and "channel chain" in why

    lp2_far = planlib.plan_layer(2, 16, 4, 6, 4, 2, epilogue=RELU)
    ok, why = planlib.pair_legal(lp1, lp2_far)
    assert not ok and "adjacent" in why

    lp2_bf16 = planlib.plan_layer(2, 8, 4, 6, 4, 2, dtype="bfloat16",
                                  epilogue=RELU)
    ok, why = planlib.pair_legal(lp1, lp2_bf16)
    assert not ok and "float32" in why

    lp1_bf16 = planlib.plan_layer(2, 4, 4, 8, 6, 2, dtype="bfloat16",
                                  epilogue=RELU)
    ok, why = planlib.pair_legal(lp1_bf16, lp2)
    assert not ok and "float32" in why

    # the Hopper budget: EB-GAN's full-size tail pair
    big1 = planlib.plan_layer(1, 64, 4, 128, 64, 2, epilogue=RELU)
    big2 = planlib.plan_layer(1, 128, 4, 64, 64, 2, epilogue=RELU)
    ok, why = planlib.pair_legal(big1, big2)
    assert not ok and "shared memory" in why


# ------------------------------------------------------- plan pass behaviour

def test_no_fusion_unless_asked():
    cfg = gan.reduced_config(gan.DCGAN)
    epis = gan.generator_epilogues(cfg)
    for plan in (planlib.compile_plan(cfg, 2, epilogues=epis),
                 planlib.compile_plan(cfg, 2, epilogues=epis, fuse="off"),
                 gan.generator_plan(cfg, 2),
                 *planlib.compile_plan_buckets(cfg, [1, 2],
                                               epilogues=epis).values()):
        assert not any(isinstance(e, planlib.FusedPairPlan)
                       for e in plan.entries)


def test_fuse_auto_raises_until_the_autotuner(tmp_path, monkeypatch):
    """``fuse="auto"`` no longer raises: it reads the autotuner's pair race
    and, on an empty cache, leaves every pair back to back on every device
    (the port's cold rule), so it compiles the ``fuse="off"`` plan. Any
    other value still raises."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    cfg = gan.reduced_config(gan.DCGAN)
    epis = gan.generator_epilogues(cfg)
    auto = planlib.compile_plan(cfg, 2, epilogues=epis, fuse="auto")
    assert auto == planlib.compile_plan(cfg, 2, epilogues=epis, fuse="off")
    assert auto.describe() == planlib.compile_plan(
        cfg, 2, epilogues=epis, fuse="off").describe()
    assert not any(isinstance(e, planlib.FusedPairPlan) for e in auto.entries)
    with pytest.raises(ValueError, match="fuse"):
        planlib.fuse_pairs(gan.generator_plan(cfg, 2), fuse="sometimes")


def test_fuse_pairs_idempotent():
    cfg = gan.reduced_config(gan.DCGAN)
    plan = planlib.compile_plan(
        cfg, 2, epilogues=gan.generator_epilogues(cfg), fuse="force"
    )
    assert all(isinstance(e, planlib.FusedPairPlan) for e in plan.entries)
    again = planlib.fuse_pairs(plan, fuse="force")
    assert again == plan
    assert planlib.fuse_pairs(plan, fuse="off") == plan   # a pass-through
    assert tuple(plan) == tuple(again)
    flat = planlib.compile_plan(cfg, 2, epilogues=gan.generator_epilogues(cfg))
    assert tuple(flat) == tuple(plan) and planlib.fuse_pairs(flat, fuse=True) == plan


def test_execute_layer_rejects_fused_pair_plan():
    cfg = gan.reduced_config(gan.DCGAN)
    plan = planlib.compile_plan(
        cfg, 2, epilogues=gan.generator_epilogues(cfg), fuse="force"
    )
    fp = plan.entries[0]
    x = torch.ones((2, fp.first.n_in, fp.first.n_in, fp.first.cin))
    k = torch.ones((4, 4, fp.first.cin, fp.first.cout))
    with pytest.raises(TypeError, match="execute_pair"):
        planlib.execute_layer(fp, x, k)


# ------------------------------------------------- end-to-end + gradients

@pytest.mark.parametrize("name", sorted(gan.GAN_ZOO))
def test_fused_generator_matches_reference_fused(name):
    """The port's fused generator against the reference's fused generator
    (its pair kernel interpreted, its other layers by its CPU rule) on the
    same weights, and against the port's per-layer generator."""
    jcfg = jgan.reduced_config(jgan.GAN_ZOO[name], 32)
    cfg = gan.reduced_config(gan.GAN_ZOO[name], 32)
    jparams = jgan.generator_init(jax.random.key(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             "cpu")
    z = np.random.default_rng(1).standard_normal((2, cfg.z_dim)).astype(np.float32)
    jplan_f = jgan.generator_plan(jcfg, 2, fuse="force")
    plan_f = gan.generator_plan(cfg, 2, fuse="force")
    assert sum(isinstance(e, planlib.FusedPairPlan) for e in plan_f.entries) == \
        sum(isinstance(e, jplan.FusedPairPlan) for e in jplan_f.entries) >= 1
    want = np.asarray(jgan.generator_apply(jparams, jcfg, jnp.asarray(z),
                                           plan=jplan_f))
    got = gan.generator_apply(params, cfg, z, plan=plan_f, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flat = gan.generator_apply(params, cfg, z, plan=gan.generator_plan(cfg, 2),
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0, atol=1e-6)


def test_pair_gradients_match_per_layer_and_reference():
    """The pair's backward recomputes the interface and chains the two
    layers' own backwards: its gradients equal the per-layer plan's, and
    ``jax.grad`` of the reference pair op (its pair kernel forward, its lax
    per-layer backward)."""
    lp1 = planlib.plan_layer(2, 4, 4, 8, 6, 2, epilogue=LEAKY)
    lp2 = planlib.plan_layer(2, 8, 4, 6, 4, 2, epilogue=TANH)
    fp = planlib.plan_pair(lp1, lp2, fuse="force")
    assert fp is not None
    arrays = _pair_data(6, 4, 4, 8, 6, 4)
    r = np.random.default_rng(7).standard_normal((2, 16, 16, 4)).astype(np.float32)

    def grads(run):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        (run(*leaves) * torch.from_numpy(r)).sum().backward()
        return [t.grad for t in leaves]

    gp = grads(lambda x, k1, k2, b1, b2: planlib.execute_pair(
        fp, x, k1, k2, bias1=b1, bias2=b2))
    gl = grads(lambda x, k1, k2, b1, b2: planlib.execute_layer(
        lp2, planlib.execute_layer(lp1, x, k1, bias=b1), k2, bias=b2))
    for a, b in zip(gp, gl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    j1 = dataclasses.replace(jplan.plan_layer(
        2, 4, 4, 8, 6, 2, method="unified", epilogue=_jax_epi(LEAKY)),
        bwd_method="lax")
    j2 = dataclasses.replace(jplan.plan_layer(
        2, 8, 4, 6, 4, 2, method="unified", epilogue=_jax_epi(TANH)),
        bwd_method="lax")
    jfp = jplan.FusedPairPlan(first=j1, second=j2)

    def loss(x, k1, k2, b1, b2):
        return jnp.sum(jops.transpose_conv2d_pair(jfp, x, k1, k2, b1, b2) * r)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    for a, b in zip(gp, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_fused_generator_gradients_match_per_layer():
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((2, cfg.z_dim)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(
        (2, 64, 64, cfg.layers[-1][2])).astype(np.float32))
    grads = {}
    for fuse in ("force", "off"):
        live = {k: {n: t.detach().clone().requires_grad_(True)
                    for n, t in v.items()} for k, v in params.items()}
        plan = gan.generator_plan(cfg, 2, fuse=fuse)
        (gan.generator_apply(live, cfg, z, plan=plan, device="cpu") * r).sum().backward()
        grads[fuse] = {f"{k}.{n}": t.grad for k, v in live.items()
                       for n, t in v.items()}
    for key, want in grads["off"].items():
        got = grads["force"][key]
        tol = 1e-5 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= tol, key


def test_generator_memory_savings_counts_interface_planes():
    cfg = gan.reduced_config(gan.DCGAN)
    plan = planlib.compile_plan(
        cfg, 1, epilogues=gan.generator_epilogues(cfg), fuse="force"
    )
    base = gan.generator_memory_savings(cfg)
    with_plan = gan.generator_memory_savings(cfg, plan=plan)
    expect_extra = 0
    for e in plan.entries:
        if isinstance(e, planlib.FusedPairPlan):
            m1 = 2 * e.first.n_in - e.first.n_k + 2 * e.first.padding
            expect_extra += 2 * m1 * m1 * e.first.cout * 4
    assert expect_extra > 0
    assert with_plan - base == expect_extra
    jcfg = jgan.reduced_config(jgan.DCGAN)
    jplan_f = jplan.compile_plan(jcfg, 1, epilogues=jgan.generator_epilogues(jcfg),
                                 fuse="force")
    assert with_plan == jgan.generator_memory_savings(jcfg, plan=jplan_f)


def test_reference_oracle_agrees_with_plain_pair():
    """The plain pair equals two conventional-oracle layers composed (the
    reference's own test oracle), so the crop and re-pad are the layers'."""
    x, k1, k2, b1, b2 = _pair_data(9, 5, 3, 3, 4, 2)
    y1 = _jax_epi(LEAKY).apply(jref.conventional_ref(jnp.asarray(x),
                                                     jnp.asarray(k1), 1),
                               jnp.asarray(b1))
    want = _jax_epi(TANH).apply(jref.conventional_ref(y1, jnp.asarray(k2), 1),
                                jnp.asarray(b2))
    t = torch.from_numpy
    got = pairlib.transpose_conv2d_pair_plain(t(x), t(k1), t(k2), 1,
                                              epilogue1=LEAKY, bias1=t(b1),
                                              epilogue2=TANH, bias2=t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
