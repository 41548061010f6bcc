"""Port of the layer-pair kernel and the plan's pair pass
(repro_torch.kernels.transpose_conv2d_pair, repro_torch.kernels.plan).
Ports of ``tests/test_pair_fusion.py`` with the Hopper budget in place of
the TPU's VMEM.

On the CPU: the plain version against the JAX package's own pair kernel
(which still interprets under the installed JAX); an emulation of the CUDA
kernel's cluster partition (each block's interface slice in its own shared
memory, the consumer reading every slice) that must produce each interface
element once, write each output once, and give the plain version's result;
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

def emulate_pair_kernel(x, k1, k2, padding, e1=None, b1=None, e2=None,
                        b2=None):
    """What csrc/transpose_conv2d_pair.cu computes, block by block: each
    cluster rank's interface slice in its own buffer (the zero halo around
    it), then the consumer's work tiles round-robin over the ranks, reading
    every rank's slice. Threads are vectorised. Returns the output, how many
    times each interface element and each output element was written, and
    the shared memory (bytes) the emulated buffers took in one block."""
    b_, n_in, _, c0 = x.shape
    n_k, c1, c2 = k1.shape[0], k1.shape[3], k2.shape[3]
    g = pairlib.pair_launch_geometry(n_in, n_k, padding, c0, c1, c2)
    R, CI, NT = g.r, pairlib.CIN_CHUNK, pairlib.THREADS
    out = torch.full((b_, g.m2, g.m2, c2), float("nan"), dtype=x.dtype)
    out_writes = torch.zeros((b_, g.m2, g.m2, c2), dtype=torch.int64)
    if_writes = torch.zeros((b_, c1, g.s2, g.s2), dtype=torch.int64)
    tid = torch.arange(NT)

    def weights(k, ci0, ci_end, co0, co_end, ct):
        ws = torch.zeros((4, R, R, CI, ct), dtype=x.dtype)
        cin = k.shape[2]
        for s, p, q in itertools.product(range(4), range(R), range(R)):
            kh, kw = 2 * p + (s >> 1), 2 * q + (s & 1)
            if kh < n_k and kw < n_k:
                n_ci = max(0, min(CI, ci_end - ci0, cin - ci0))
                n_co = max(0, min(ct, co_end - co0))
                ws[s, p, q, :n_ci, :n_co] = k[kh, kw, ci0 : ci0 + n_ci,
                                              co0 : co0 + n_co]
        return ws

    def mac(acc, xs, ws, rows, cols, cgi, roff, coff):
        for ci, p, q, par in itertools.product(range(CI), range(R), range(R),
                                               range(4)):
            ri = rows + roff[par >> 1] + p
            cj = cols + coff[par & 1] + q
            if ri.max() >= xs.shape[1] or cj.max() >= xs.shape[2]:
                raise IndexError("read past the staged window")
            wv = ws[g.wsels[par], p, q, ci][cgi[:, None] * 4 + torch.arange(4)]
            acc[par] += xs[ci, ri, cj][..., None] * wv[:, None, :]

    for bb in range(b_):
        ifaces = []
        # ---- producer, one rank at a time
        ct = 4 * g.ncg1
        groups = NT // g.ncg1
        pg, cgi = tid % groups, tid // groups   # lanes along positions
        for rank in range(g.cl):
            c1_lo, c1_hi = rank * g.mc, min(rank * g.mc + g.mc, c1)
            iface = torch.zeros((g.mc, g.s2, g.s2), dtype=x.dtype)
            for tile in range(g.n_sp1 * g.nct1):
                sp = tile % g.n_sp1
                t0, u0 = (sp // g.n_w1) * g.th1, (sp % g.n_w1) * g.tw1
                co0 = c1_lo + (tile // g.n_sp1) * ct
                pos = pg[:, None] + groups * torch.arange(g.ppt1)
                live = pos < g.th1 * g.tw1
                pos = torch.where(live, pos, torch.zeros_like(pos))
                tl, ul = pos // g.tw1, pos % g.tw1
                acc = torch.zeros((4, NT, g.ppt1, 4), dtype=x.dtype)
                for ci0 in range(0, c0, CI):
                    xs = torch.zeros((CI, g.xh1, g.xw1), dtype=x.dtype)
                    n_ci = min(CI, c0 - ci0)
                    for r, c in itertools.product(range(g.xh1), range(g.xw1)):
                        gr = g.x0r + t0 + r - g.pad_lo1
                        gc = g.x0c + u0 + c - g.pad_lo1
                        if 0 <= gr < n_in and 0 <= gc < n_in:
                            xs[:n_ci, r, c] = x[bb, gr, gc, ci0 : ci0 + n_ci]
                    ws = weights(k1, ci0, c0, co0, c1_hi, ct)
                    mac(acc, xs, ws, tl, ul, cgi, g.roff1, g.coff1)
                for par, th, j, k in itertools.product(
                        range(4), range(NT), range(g.ppt1), range(4)):
                    oh = 2 * (t0 + int(tl[th, j])) + (par >> 1)
                    ow = 2 * (u0 + int(ul[th, j])) + (par & 1)
                    c = co0 + int(cgi[th]) * 4 + k
                    if not live[th, j] or oh >= g.m1 or ow >= g.m1 or c >= c1_hi:
                        continue
                    y = acc[par, th, j, k]
                    if e1 is not None:
                        y = e1.apply(y, b1[c] if e1.bias else None)
                    r, cc = g.pad_lo2 + oh, g.pad_lo2 + ow
                    iface[c - c1_lo, r, cc] = y
                    if_writes[bb, c, r, cc] += 1
            ifaces.append(iface)
        # ---- consumer: work tiles round-robin over the ranks
        ct = 4 * g.ncg2
        groups = NT // g.ncg2
        pg, cgi = tid % groups, tid // groups   # lanes along positions
        for rank in range(g.cl):
            for work in range(rank, g.n_sp2 * g.n_co2, g.cl):
                sp = work % g.n_sp2
                t0, u0 = (sp // g.n_w2) * g.th2, (sp % g.n_w2) * g.tw2
                co0 = (work // g.n_sp2) * ct
                pos = pg[:, None] + groups * torch.arange(g.ppt2)
                live = pos < g.th2 * g.tw2
                pos = torch.where(live, pos, torch.zeros_like(pos))
                tl, ul = pos // g.tw2, pos % g.tw2
                acc = torch.zeros((4, NT, g.ppt2, 4), dtype=x.dtype)
                for src in range(g.cl):
                    m_lo, m_hi = src * g.mc, min(src * g.mc + g.mc, c1)
                    for cc0 in range(m_lo, m_hi, CI):
                        xs = torch.zeros((CI, g.xh2, g.xw2), dtype=x.dtype)
                        for ci, r, c in itertools.product(
                                range(CI), range(g.xh2), range(g.xw2)):
                            gr, gc = g.b0r + t0 + r, g.b0c + u0 + c
                            if cc0 + ci < m_hi and gr < g.s2 and gc < g.s2:
                                xs[ci, r, c] = ifaces[src][cc0 - m_lo + ci, gr, gc]
                        ws = weights(k2, cc0, m_hi, co0, c2, ct)
                        mac(acc, xs, ws, tl, ul, cgi, g.roff2, g.coff2)
                for par, th, j, k in itertools.product(
                        range(4), range(NT), range(g.ppt2), range(4)):
                    oh = 2 * (t0 + int(tl[th, j])) + (par >> 1)
                    ow = 2 * (u0 + int(ul[th, j])) + (par & 1)
                    c = co0 + int(cgi[th]) * 4 + k
                    if not live[th, j] or oh >= g.m2 or ow >= g.m2 or c >= c2:
                        continue
                    y = acc[par, th, j, k]
                    if e2 is not None:
                        y = e2.apply(y, b2[c] if e2.bias else None)
                    out[bb, oh, ow, c] = y
                    out_writes[bb, oh, ow, c] += 1
    stage = max(
        CI * g.xh1 * g.xw1 + 4 * R * R * CI * 4 * g.ncg1,
        CI * g.xh2 * g.xw2 + 4 * R * R * CI * 4 * g.ncg2,
    )
    smem = 4 * (g.mc * g.s2 * g.s2 + stage)
    return out, if_writes, out_writes, smem


EMULATED = [  # (n_in, n_k, P, C0, C1, C2, batch)
    (4, 4, 2, 64, 32, 16, 2),    # reduced DCGAN head pair (scale 16)
    (16, 4, 2, 16, 8, 2, 1),     # reduced DCGAN tail pair
    (4, 4, 2, 17, 37, 9, 1),     # C1 past one rank's chunk, C2 ragged
    (5, 3, 1, 3, 5, 2, 2),       # odd extent, n = 3, odd P
    (7, 5, 3, 2, 10, 5, 1),      # n = 5, odd P = 3; 5 ranks of 2 channels
    (32, 4, 2, 2, 2, 2, 1),      # reduced EB-GAN tail pair: tiled planes
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
    # the launch asks for what the emulated block holds (float4 padding of
    # the two regions aside)
    assert 0 <= g.smem_bytes - smem < 32


# ------------------------------------------ shared memory budget, legality

def test_pair_smem_bytes_deterministic_and_monotone():
    a = pairlib.pair_smem_bytes(4, 4, 256, 128, 64, 2)
    assert a == pairlib.pair_smem_bytes(4, 4, 256, 128, 64, 2)
    # a larger plane grows the interface slice every block holds
    assert pairlib.pair_smem_bytes(8, 4, 256, 128, 64, 2) > a
    # more interface channels grow each block's slice
    assert pairlib.pair_smem_bytes(4, 4, 256, 256, 64, 2) > a
    g = pairlib.pair_launch_geometry(4, 4, 2, 256, 128, 64)
    assert g.smem_bytes == a and g.iface_bytes < a
    assert g.cl * g.mc >= 128 and (g.cl - 1) * g.mc < 128 and g.cl <= 8


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


def test_fuse_auto_raises_until_the_autotuner():
    cfg = gan.reduced_config(gan.DCGAN)
    with pytest.raises(ValueError, match="autotuner"):
        planlib.compile_plan(cfg, 2, epilogues=gan.generator_epilogues(cfg),
                             fuse="auto")
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
