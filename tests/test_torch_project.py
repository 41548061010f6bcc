"""The GAN projection's kernels (repro_torch.kernels.project) on the CPU.

An emulation of the CUDA kernels' index math (``csrc/gan_project.cu``:
blocks, warps, each thread's 8 x 4 outputs, the ring's staged chunks and their
zero fill, the 16-byte and 4-byte paths, the tails where N is not a
multiple of the column tile and B not a multiple of the row tile) must
reproduce the plain versions, write every output once and sum each in one
chain in the kernel's order, for the forward, dW and dz. The autograd
function's CPU path is held to ``relu(z @ w)`` and its gradient (and
gradcheck in float64), and the generator's CPU path to the per-row bits it
always had. The card tests are in ``test_torch_cuda.py``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_project.py
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import project as proj
from repro_torch.models import gan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "gan_project.cu")
# (B, K, N): the tails of N = 70 at B = 1, 3 and 65; K across a staged
# chunk's edge; DCGAN's width cut to a few column blocks; a ragged N past a
# multiple of 4
SHAPES = [(1, 37, 70), (3, 37, 70), (65, 37, 70), (17, 33, 256), (33, 100, 132),
          (2, 5, 6)]
# each shape with 4-byte copies, and with 16-byte ones where the wrapper
# takes them (N a multiple of 4)
COPIES = [(shape, vec) for shape in SHAPES for vec in (False, True)
          if not (vec and shape[2] % 4)]


def _constants() -> dict:
    """The ``constexpr int`` constants of the CUDA source, in order."""
    text = open(CU).read()
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        out[name] = eval(expr, {}, dict(out))
    return out


C = _constants()


def _ints(rng, shape):
    """Small integers as float64: every sum below is exact, so an emulated
    kernel equals the plain version exactly whatever its order."""
    return rng.integers(-4, 5, size=shape).astype(np.float64)


def _threads(n_threads):
    t = np.arange(n_threads)
    return t % C["NCG"], t // C["NCG"]   # column group, warp


def _stage_rows(src, q0, rows, c0, nq, vec):
    """``stage_rows``: rows [q0, q0 + nq) x columns [c0, c0 + BC) of a (rows,
    N) operand, quad by quad, each thread's quads ``tid + i NT``; a quad is
    one 16-byte copy (``vec``: N a multiple of 4) or four 4-byte ones, and
    rows and columns past the operand are zeros."""
    n, bc, nt = src.shape[1], C["BC"], C["NT"]
    dst = np.full((nq, bc), np.nan)
    quads = nq * bc // 4
    assert quads % nt == 0
    for tid in range(nt):
        for i in range(quads // nt):
            q = tid + i * nt
            row, col = q // (bc // 4), c0 + (q % (bc // 4)) * 4
            avail = n - col if q0 + row < rows else 0
            if vec:
                assert col % 4 == 0 and (avail <= 0 or avail >= 4)
            for e in range(4):
                dst[row, col - c0 + e] = src[q0 + row, col + e] if e < avail else 0.0
    assert not np.isnan(dst).any()   # every staged element written
    return dst


def _stage_z(z, b0, k0, nb, nk, kt):
    """``stage_z``: z[b0 : b0 + nb, k0 : k0 + nk] as [nb][nk], or as
    [nk][nb] (``kt``), element by element, zeros past B and K."""
    b_, k_ = z.shape
    nt = C["NT"]
    assert nb * nk % nt == 0
    flat = np.full(nb * nk, np.nan)
    for tid in range(nt):
        for i in range(nb * nk // nt):
            e = tid + i * nt
            b, k = (e % nb, e // nb) if kt else (e // nk, e % nk)
            ok = b0 + b < b_ and k0 + k < k_
            flat[e] = z[b0 + b, k0 + k] if ok else 0.0
    return flat.reshape((nk, nb) if kt else (nb, nk))


def emulate_forward(z, w, vec):
    """``project_relu_kernel`` thread by thread, over the ring's chunks:
    ``(y, writes, chains)``, ``chains[b][j]`` the k's summed into output
    (b, j) in order."""
    b_, k_ = z.shape
    n = w.shape[1]
    tr, tc, br, bc, kc = C["TR"], C["TC"], C["BR"], C["BC"], C["KC"]
    y = np.zeros((b_, n))
    writes = np.zeros((b_, n), int)
    chains = [[[] for _ in range(n)] for _ in range(b_)]
    gx, gy = proj.forward_grid(b_, n)
    cg, warp = _threads(C["NT"])
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * br, bx * bc
            acc = np.zeros((C["NT"], tr, tc))
            for c in range(-(-k_ // kc)):
                ws = _stage_rows(w, c * kc, k_, c0, kc, vec)
                zs = _stage_z(z, r0, c * kc, br, kc, kt=True)
                for t in range(C["NT"]):
                    rt, j0 = r0 + warp[t] * tr, c0 + cg[t] * tc
                    if rt >= b_:   # a warp past the batch skips its FMAs
                        continue
                    for k in range(min(kc, k_ - c * kc)):
                        acc[t] += np.outer(zs[k, warp[t] * tr : warp[t] * tr + tr],
                                           ws[k, cg[t] * tc : cg[t] * tc + tc])
                        for r in range(tr):
                            for cc in range(tc):
                                if rt + r < b_ and j0 + cc < n:
                                    chains[rt + r][j0 + cc].append(c * kc + k)
            for t in range(C["NT"]):
                rt, j0 = r0 + warp[t] * tr, c0 + cg[t] * tc
                for r in range(tr):
                    for cc in range(tc):
                        if rt + r < b_ and j0 + cc < n:
                            y[rt + r, j0 + cc] = max(acc[t, r, cc], 0.0)
                            writes[rt + r, j0 + cc] += 1
    return y, writes, chains


def emulate_dw(z, y, g, vec):
    """``project_dw_kernel`` thread by thread, over the ring's chunks:
    ``(dw, writes, chains)``, ``chains[k][j]`` the samples summed into
    dW[k, j] in order."""
    b_, k_ = z.shape
    n = y.shape[1]
    tr, tc, br, bc, bch = C["TR"], C["TC"], C["BR"], C["BC"], C["BCH"]
    dw = np.zeros((k_, n))
    writes = np.zeros((k_, n), int)
    chains = [[[] for _ in range(n)] for _ in range(k_)]
    gx, gy = proj.dw_grid(k_, n)
    cg, warp = _threads(C["NT"])
    for by in range(gy):
        for bx in range(gx):
            k0, c0 = by * br, bx * bc
            acc = np.zeros((C["NT"], tr, tc))
            for c in range(-(-b_ // bch)):
                ys = _stage_rows(y, c * bch, b_, c0, bch, vec)
                gs = _stage_rows(g, c * bch, b_, c0, bch, vec)
                zs = _stage_z(z, c * bch, k0, bch, br, kt=False)
                gm = np.where(ys <= 0, 0.0, gs)   # relu's mask as g is read
                for t in range(C["NT"]):
                    kt, j0 = k0 + warp[t] * tr, c0 + cg[t] * tc
                    if kt >= k_:
                        continue
                    for b in range(min(bch, b_ - c * bch)):
                        acc[t] += np.outer(zs[b, warp[t] * tr : warp[t] * tr + tr],
                                           gm[b, cg[t] * tc : cg[t] * tc + tc])
                        for r in range(tr):
                            for cc in range(tc):
                                if kt + r < k_ and j0 + cc < n:
                                    chains[kt + r][j0 + cc].append(c * bch + b)
            for t in range(C["NT"]):
                kt, j0 = k0 + warp[t] * tr, c0 + cg[t] * tc
                for r in range(tr):
                    for cc in range(tc):
                        if kt + r < k_ and j0 + cc < n:
                            dw[kt + r, j0 + cc] = acc[t, r, cc]
                            writes[kt + r, j0 + cc] += 1
    return dw, writes, chains


def emulate_dz(w, y, g):
    """``project_dz_kernel`` thread by thread: ``(dz, writes, chains)``,
    ``chains[b][k]`` the columns summed into dz[b, k] in order."""
    k_, n = w.shape
    b_ = y.shape[0]
    t_, jc = C["DZ_T"], C["JC"]
    dz = np.zeros((b_, k_))
    writes = np.zeros((b_, k_), int)
    chains = [[[] for _ in range(k_)] for _ in range(b_)]
    gm = np.where(y <= 0, 0.0, g)
    gx, gy = proj.dz_grid(b_, k_)
    for by in range(gy):
        for bx in range(gx):
            b0, k0 = by * t_, bx * t_
            acc = np.zeros(C["DZ_NT"])
            for j0 in range(0, n, jc):
                gs = np.zeros((t_, jc))
                ws = np.zeros((t_, jc))
                for i in range(t_ * jc):
                    r, j = divmod(i, jc)
                    if b0 + r < b_ and j0 + j < n:
                        gs[r, j] = gm[b0 + r, j0 + j]
                    if k0 + r < k_ and j0 + j < n:
                        ws[r, j] = w[k0 + r, j0 + j]
                for t in range(C["DZ_NT"]):
                    kl, bl = t % t_, t // t_
                    for j in range(min(jc, n - j0)):
                        acc[t] += gs[bl, j] * ws[kl, j]
                        if b0 + bl < b_ and k0 + kl < k_:
                            chains[b0 + bl][k0 + kl].append(j0 + j)
            for t in range(C["DZ_NT"]):
                kl, bl = t % t_, t // t_
                if b0 + bl < b_ and k0 + kl < k_:
                    dz[b0 + bl, k0 + kl] = acc[t]
                    writes[b0 + bl, k0 + kl] += 1
    return dz, writes, chains


def test_python_constants_are_the_kernels():
    assert (proj.ROW_TILE, proj.COL_TILE) == (C["BR"], C["BC"])
    assert (proj.DW_ROW_TILE, proj.DZ_TILE) == (C["BR"], C["DZ_T"])
    # one warp across the columns: the live test on a warp's rows is uniform
    assert C["NCG"] == 32 and C["BC"] == C["TC"] * C["NCG"]
    # the ring fits the 48 KB of static shared memory a block may have
    fwd = C["STAGES"] * C["KC"] * (C["BC"] + C["BR"]) * 4
    dw = C["STAGES"] * C["BCH"] * (2 * C["BC"] + C["BR"]) * 4
    assert max(fwd, dw) <= 48 * 1024


@pytest.mark.parametrize("shape,vec", COPIES, ids=str)
def test_forward_emulation(shape, vec):
    """Every output written once, summed over k = 0..K-1 in ascending
    order (so its bits do not depend on the batch), equal to relu(z @ w)."""
    b, k, n = shape
    rng = np.random.default_rng(sum(shape))
    z, w = _ints(rng, (b, k)), _ints(rng, (k, n))
    y, writes, chains = emulate_forward(z, w, vec)
    assert (writes == 1).all()
    assert all(chain == list(range(k)) for row in chains for chain in row)
    want = proj.project_relu_plain(torch.from_numpy(z), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("shape,vec", COPIES, ids=str)
def test_dw_emulation(shape, vec):
    """dW written once per element, each summed over b = 0..B-1 in order,
    equal to z^T @ (g * [y > 0])."""
    b, k, n = shape
    rng = np.random.default_rng(sum(shape) + 1)
    z, y, g = _ints(rng, (b, k)), _ints(rng, (b, n)), _ints(rng, (b, n))
    dw, writes, chains = emulate_dw(z, y, g, vec)
    assert (writes == 1).all()
    assert all(chain == list(range(b)) for row in chains for chain in row)
    want = proj.project_dw_plain(*(torch.from_numpy(a) for a in (z, y, g))).numpy()
    np.testing.assert_array_equal(dw, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dz_emulation(shape):
    """dz written once per element, each summed over j = 0..N-1 in order
    (a row's bits independent of the batch), equal to (g * [y > 0]) @ w^T."""
    b, k, n = shape
    rng = np.random.default_rng(sum(shape) + 2)
    w, y, g = _ints(rng, (k, n)), _ints(rng, (b, n)), _ints(rng, (b, n))
    dz, writes, chains = emulate_dz(w, y, g)
    assert (writes == 1).all()
    assert all(chain == list(range(n)) for row in chains for chain in row)
    want = proj.project_dz_plain(*(torch.from_numpy(a) for a in (w, y, g))).numpy()
    np.testing.assert_array_equal(dz, want)


@pytest.mark.parametrize("n", [8192, 16384, 32768])
def test_only_the_grids_row_count_reads_the_batch(n):
    """At the zoo's widths (ArtGAN and GP-GAN, DCGAN, EB-GAN) the forward's
    column blocks, dW's grid and dz's W-row blocks are the same at every
    bucket and at the training batch."""
    fwd = {proj.forward_grid(b, n)[0] for b in (1, 2, 7, 8, 64, 128)}
    dz = {proj.dz_grid(b, 100)[0] for b in (1, 2, 7, 8, 64, 128)}
    assert fwd == {n // proj.COL_TILE} and dz == {7}
    assert [proj.forward_grid(b, n)[1] for b in (1, 32, 33, 128)] == [1, 1, 2, 4]
    assert proj.dw_grid(100, n) == (n // proj.COL_TILE, 4)


def _operands(seed, b, k, n, dtype=torch.float32, grad=True):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((b, k), generator=gen, dtype=dtype)
    w = 0.1 * torch.randn((k, n), generator=gen, dtype=dtype)
    return z.requires_grad_(grad), w.requires_grad_(grad)


@pytest.mark.parametrize("shape", [(1, 37, 70), (65, 37, 70), (8, 100, 256)], ids=str)
def test_function_cpu_matches_relu_matmul_and_its_gradient(shape):
    z, w = _operands(0, *shape)
    y = proj.ProjectReLU.apply(z, w)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    dz, dw = torch.autograd.grad(y, (z, w), g)
    z2, w2 = z.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y2 = torch.relu(z2 @ w2)
    dz2, dw2 = torch.autograd.grad(y2, (z2, w2), g)
    assert torch.equal(y, y2)
    torch.testing.assert_close(dw, dw2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dz, dz2, rtol=1e-5, atol=1e-6)


def test_function_gradcheck_float64():
    z, w = _operands(2, 3, 5, 7, dtype=torch.float64)
    assert torch.autograd.gradcheck(proj.ProjectReLU.apply, (z, w))


def test_function_skips_dz_without_a_latent_gradient():
    z, w = _operands(3, 4, 6, 8)
    z.requires_grad_(False)
    before = proj.project_relu_dz.launches
    proj.ProjectReLU.apply(z, w).sum().backward()
    assert z.grad is None and w.grad is not None
    assert proj.project_relu_dz.launches == before   # the CPU counts nothing either


def test_relu_and_its_gradient_follow_torch_on_nan():
    """relu keeps a NaN; its gradient passes where y is NaN and stops at
    y <= 0, as PyTorch's relu and threshold_backward do."""
    y = torch.tensor([[float("nan"), -1.0, 0.0, 2.0]])
    g = torch.tensor([[1.0, 1.0, 1.0, 1.0]])
    assert torch.equal(proj.relu_grad_mask(y, g), torch.tensor([[1.0, 0.0, 0.0, 1.0]]))
    assert torch.isnan(proj.project_relu_plain(torch.ones(1, 1),
                                               torch.tensor([[float("nan")]]))).all()


def test_wrappers_refuse_shapes_that_do_not_multiply():
    with pytest.raises(ValueError, match="do not multiply"):
        proj.project_relu_fwd(torch.zeros(2, 3), torch.zeros(4, 5))


def test_generator_cpu_path_keeps_the_per_row_bits():
    """On the CPU the generator projects one matmul call a row, as before
    the kernels: ``project`` is ``relu`` of one matmul a row bit for bit,
    and the kernels' launch counters do not move."""
    z, w = (t.detach() for t in _operands(4, 9, 100, 512))
    counts = [f.launches for f in (proj.project_relu_fwd, proj.project_relu_dw,
                                   proj.project_relu_dz)]
    rows = torch.cat([z[i : i + 1] @ w for i in range(z.shape[0])])
    assert torch.equal(gan.project(z, w), torch.relu(rows))
    assert counts == [f.launches for f in (proj.project_relu_fwd, proj.project_relu_dw,
                                           proj.project_relu_dz)]


def test_plain_matches_the_reference_projection():
    """The plain forward against the JAX package's ``relu(z @ w)``
    (``repro/models/gan.py::generator_apply``'s first two lines)."""
    z, w = (t.detach() for t in _operands(5, 4, 100, 256))
    want = np.asarray(jax.nn.relu(jnp.asarray(z.numpy()) @ jnp.asarray(w.numpy())))
    np.testing.assert_allclose(proj.project_relu_plain(z, w).numpy(), want,
                               rtol=1e-5, atol=1e-6)
