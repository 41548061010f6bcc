"""Segregated backward of the unified transpose conv: three CUDA kernels,
their wrappers and their plain PyTorch versions. Mirrors
``repro/kernels/transpose_conv2d_bwd.py`` (``epilogue_grad_pallas``,
``transpose_conv2d_dx_pallas``, ``transpose_conv2d_dw_pallas`` and the
composer ``transpose_conv2d_bwd_pallas``).

The cotangent ``g`` of a layer ``y = act(tconv(x, K) + b)`` splits into the
four output-parity planes the forward writes, ``g_{pr,pc}[t, u] = g[2t+pr,
2u+pc]``, and both gradients become dense stride-1 sums over them:

* epilogue-grad: ``gm = g * act'(y)`` from the saved output ``y``.
* dx: ``dx[b,i,j,ci] = sum_{pr,pc,p,q,co} gm[b, 2t+pr, 2u+pc, co] *
  S[wsel(pr,pc), p, q, ci, co]`` with ``t = i + offr(pr) - p``, ``u = j +
  offc(pc) - q`` and ``offr(pr) = pad_lo - row0(pr)``; a term whose ``t``
  or ``u`` lies outside the plane, or whose row ``2t+pr >= M``, is zero.
* dw: ``dK[kh,kw,ci,co] = sum_{b,t,u} Ipad[b, row0(pr)+t+p, col0(pc)+u+q,
  ci] * gm[b, 2t+pr, 2u+pc, co]``, where ``(pr, pc, p, q)`` is the one
  (phase, tap) that reads HWIO tap ``(kh, kw)`` (:func:`dw_tap_table`);
  ``db = sum gm``.

``S`` is the forward's ``(4, R, R, Cin, Cout)`` sub-kernel stack, read
straight from the HWIO kernel (``S[s,p,q] = K[2p + s//2, 2q + s%2]``), and
``Ipad`` the input seen through a ``floor(P/2)`` zero border. Everything
the kernels need to know of the geometry -- the phase offsets, the
odd-padding swap ``wsels``, the tap table, tiles, grid and the shape-only
split-K counts -- is computed here (:func:`bwd_geometry`), so the CPU tests
reach it.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; it never falls back from one to the other. Each
counts its kernel launches in ``.launches``; ``transpose_conv2d_dx`` and
``transpose_conv2d_dw`` count the split-K reduce pass apart, in
``.reduce_launches``. No kernel uses float atomics: a split reduction
writes its partial sums and a second pass adds them in split order.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import segregation as seg
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels.transpose_conv2d import H100_SMS, check_cuda_operands

DX_TILE = (32, 64)        # (rows = dx positions, cols = Cin) of the dx kernel
DW_TILES = ((32, 64), (128, 16))  # (rows = Cin, cols = Cout); the second for Cout <= 16
BK = 16                   # contraction step of both GEMM kernels
MIN_BLOCKS = 2 * H100_SMS  # split a reduction until the grid has this many blocks
MIN_DW_STEPS = 8          # ... but keep at least this many BK steps in each split
EPI_GRAD_THREADS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wsels(padding: int) -> tuple:
    """Output parity ``2*pr + pc`` -> stacked sub-kernel index (the
    odd-padding swap of paper §3.4); a permutation of 0..3."""
    return tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )


def phase_origins(n_in: int, n_k: int, padding: int):
    """``(row0s, col0s, pad_lo)``: the padded-input row (col) each output
    row (col) parity starts reading at, from the forward's phase plans."""
    plans, pad_lo, _ = seg.plan_phases(n_in, n_k, padding)
    return (plans[0].row0, plans[2].row0), (plans[0].col0, plans[1].col0), pad_lo


def dx_offsets(n_in: int, n_k: int, padding: int):
    """``(roffs, coffs)``: ``offr(pr) = pad_lo - row0(pr)`` by parity. dx
    row ``i`` reads plane row ``t = i + offr(pr) - p``; may be negative."""
    row0s, col0s, pad_lo = phase_origins(n_in, n_k, padding)
    return (tuple(pad_lo - r for r in row0s), tuple(pad_lo - c for c in col0s))


def dw_tap_table(n_k: int, padding: int) -> tuple:
    """``((kh, kw, parity, p, q), ...)`` over the HWIO taps: the one output
    parity ``2*pr + pc`` and stacked tap ``(p, q)`` that read kernel tap
    ``(kh, kw)``. Stacked taps past the kernel (odd ``n``) have no entry."""
    phase_of_sub = {s: ph for ph, s in enumerate(wsels(padding))}
    return tuple(
        (kh, kw, phase_of_sub[2 * (kh % 2) + kw % 2], kh // 2, kw // 2)
        for kh in range(n_k) for kw in range(n_k)
    )


@dataclasses.dataclass(frozen=True)
class BwdGeometry:
    """Launch geometry of the dx and dw kernels for one layer shape."""

    batch: int
    n_in: int
    n_k: int
    padding: int
    cin: int
    cout: int
    m: int             # output extent 2N - n + 2P
    hp: int            # phase-plane extent ceil(M / 2)
    r: int             # stacked sub-kernel extent ceil(n / 2)
    pad_lo: int
    row0s: tuple       # padded-input origin by output row parity (cols: col0s)
    col0s: tuple
    roffs: tuple       # dx plane-row offset by parity: pad_lo - row0
    coffs: tuple
    wsels: tuple       # output parity -> stacked sub-kernel
    phase_of_sub: tuple  # stacked sub-kernel -> output parity (inverse)
    # dx: rows (b, i, j) x cols Cin, contraction over (parity, p, q, co)
    dx_rows: int
    dx_grid: tuple     # (row blocks, Cin blocks, splits)
    dx_taps: int       # stacked taps 4 R R
    dx_taps_per_split: int
    # dw: one GEMM per HWIO tap, rows Cin x cols Cout, contraction over the
    # B Hp Hp positions of the tap's phase plane
    dw_tile: tuple     # (rows, cols)
    dw_positions: int
    dw_grid: tuple     # (Cin blocks * Cout blocks, n*n taps, splits)
    dw_positions_per_split: int

    @property
    def dx_splits(self) -> int:
        return self.dx_grid[2]

    @property
    def dw_splits(self) -> int:
        return self.dw_grid[2]


def _splits(blocks: int, steps: int, min_steps: int) -> int:
    """Shape-only split count: double while the grid is under
    :data:`MIN_BLOCKS` and each split keeps ``min_steps`` of ``steps``."""
    s = 1
    while blocks * s < MIN_BLOCKS and steps // (2 * s) >= min_steps:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def bwd_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                 cout: int) -> BwdGeometry:
    """The dx and dw kernels' launch geometry, a function of the layer's
    shape alone (so is every split count, and with it the order of every
    sum)."""
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = phase_origins(n_in, n_k, padding)
    roffs, coffs = dx_offsets(n_in, n_k, padding)
    ws = wsels(padding)
    phase_of_sub = tuple(ws.index(s) for s in range(4))

    dx_rows = batch * n_in * n_in
    dx_blocks = _cdiv(dx_rows, DX_TILE[0]) * _cdiv(cin, DX_TILE[1])
    dx_taps = 4 * r * r
    dx_splits = _splits(dx_blocks, dx_taps, 1)
    dx_tps = _cdiv(dx_taps, dx_splits)

    dw_tile = DW_TILES[1] if cout <= DW_TILES[1][1] else DW_TILES[0]
    dw_pos = batch * hp * hp
    dw_blocks = _cdiv(cin, dw_tile[0]) * _cdiv(cout, dw_tile[1])
    dw_splits = _splits(dw_blocks * n_k * n_k, _cdiv(dw_pos, BK), MIN_DW_STEPS)
    dw_pps = _cdiv(_cdiv(dw_pos, dw_splits), BK) * BK
    return BwdGeometry(
        batch=batch, n_in=n_in, n_k=n_k, padding=padding, cin=cin, cout=cout,
        m=m, hp=hp, r=r, pad_lo=pad_lo, row0s=row0s, col0s=col0s,
        roffs=roffs, coffs=coffs, wsels=ws, phase_of_sub=phase_of_sub,
        dx_rows=dx_rows,
        dx_grid=(_cdiv(dx_rows, DX_TILE[0]), _cdiv(cin, DX_TILE[1]), dx_splits),
        dx_taps=dx_taps, dx_taps_per_split=dx_tps,
        dw_tile=dw_tile, dw_positions=dw_pos,
        dw_grid=(dw_blocks, n_k * n_k, dw_splits), dw_positions_per_split=dw_pps,
    )


# ------------------------------------------------------------ plain versions

def epilogue_grad_plain(g, y, epilogue) -> torch.Tensor:
    """``g * act'(y)`` in plain PyTorch; ``g`` itself when the epilogue has
    no activation."""
    epi = epilib.canonical(epilogue)
    if epi is None or epi.act == "none":
        return g
    return epi.grad_from_y(g, y)


def _parity_plane(gm, pr: int, pc: int, hp: int):
    """``(B, Hp, Hp, C)`` plane ``gm[:, 2t+pr, 2u+pc]``; rows and cols past
    the output of an odd ``M`` are zeros."""
    b, m, _, c = gm.shape
    g2 = F.pad(gm, (0, 0, 0, 2 * hp - m, 0, 2 * hp - m))
    return g2.reshape(b, hp, 2, hp, 2, c)[:, :, pr, :, pc, :]


def transpose_conv2d_dx_plain(gm, kernel, n_in: int, padding: int = 0):
    """The dx kernel's function in plain PyTorch: for each (parity, tap) a
    shifted window of the parity plane times the transposed sub-kernel."""
    b, m, _, cout = gm.shape
    n_k, cin = kernel.shape[0], kernel.shape[2]
    if m != seg.output_size(n_in, n_k, padding):
        raise ValueError(
            f"cotangent extent {m} != output_size({n_in}, {n_k}, {padding})")
    hp, r = (m + 1) // 2, seg.ceil_half(n_k)
    roffs, coffs = dx_offsets(n_in, n_k, padding)
    ws = wsels(padding)
    lo = r  # t = i + off - p >= -1 - (R - 1)
    hi = max(0, n_in + max(roffs + coffs) - hp)
    dx = gm.new_zeros((b * n_in * n_in, cin))
    for pr in range(2):
        for pc in range(2):
            plane = F.pad(_parity_plane(gm, pr, pc, hp), (0, 0, lo, hi, lo, hi))
            s = ws[2 * pr + pc]
            for p in range(r):
                for q in range(r):
                    kh, kw = 2 * p + s // 2, 2 * q + s % 2
                    if kh >= n_k or kw >= n_k:
                        continue
                    r0, c0 = lo + roffs[pr] - p, lo + coffs[pc] - q
                    win = plane[:, r0 : r0 + n_in, c0 : c0 + n_in, :]
                    dx = dx + win.reshape(-1, cout) @ kernel[kh, kw].T
    return dx.reshape(b, n_in, n_in, cin)


def transpose_conv2d_dw_plain(x, gm, n_k: int, padding: int = 0, *,
                              with_db: bool = False):
    """The dw kernel's function in plain PyTorch: one ``(Cin, K) x (K,
    Cout)`` product per HWIO tap over its phase plane. ``with_db`` also
    returns ``db = sum gm``."""
    b, n_in, _, cin = x.shape
    m, cout = gm.shape[1], gm.shape[3]
    if m != seg.output_size(n_in, n_k, padding):
        raise ValueError(
            f"cotangent extent {m} != output_size({n_in}, {n_k}, {padding})")
    hp, r = (m + 1) // 2, seg.ceil_half(n_k)
    row0s, col0s, pad_lo = phase_origins(n_in, n_k, padding)
    hi = max(0, max(row0s + col0s) + hp + r - 1 - (n_in + pad_lo))
    xp = F.pad(x, (0, 0, pad_lo, hi, pad_lo, hi))
    planes = [_parity_plane(gm, ph // 2, ph % 2, hp).reshape(-1, cout)
              for ph in range(4)]
    dw = x.new_zeros((n_k, n_k, cin, cout))
    for kh, kw, ph, p, q in dw_tap_table(n_k, padding):
        r0, c0 = row0s[ph // 2] + p, col0s[ph % 2] + q
        win = xp[:, r0 : r0 + hp, c0 : c0 + hp, :].reshape(-1, cin)
        dw[kh, kw] = win.T @ planes[ph]
    if with_db:
        return dw, gm.sum((0, 1, 2))
    return dw


# ---------------------------------------------------------------- wrappers

@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transpose_conv2d_bwd")
    lib.tconv_epilogue_grad_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p])
    lib.tconv_dx_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 19 + [ctypes.c_void_p])
    lib.tconv_dw_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 23 + [ctypes.c_void_p])
    lib.tconv_sum_splits_f32.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] * 2
        + [ctypes.c_void_p])
    for fn in (lib.tconv_epilogue_grad_f32, lib.tconv_dx_f32, lib.tconv_dw_f32,
               lib.tconv_sum_splits_f32):
        fn.restype = ctypes.c_int
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _sum_splits(*pairs):
    """The split-K reduce pass: ``out[i] = sum_s part[s, i]`` in split
    order, for the one or two ``(part, out)`` pairs given, in one launch."""
    (pa, oa), (pb, ob) = (list(pairs) + [(None, None)])[:2]
    dev = (oa if oa is not None else ob).device
    args = []
    for part, out in ((pa, oa), (pb, ob)):
        n = out.numel() if out is not None else 0
        args += [_ptr(part), _ptr(out), n, part.numel() // n if n else 0]
    with torch.cuda.device(dev):
        err = _lib().tconv_sum_splits_f32(*args, torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "split-K reduce")


def epilogue_grad(g, y, epilogue) -> torch.Tensor:
    """``gm = g * act'(y)`` through the elementwise kernel. No launch (``g``
    is returned) for a missing, identity or bias-only epilogue. A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs
    :func:`epilogue_grad_plain`."""
    epi = epilib.canonical(epilogue)
    if epi is None or epi.act == "none":
        return g
    if g.shape != y.shape:
        raise ValueError(f"g {tuple(g.shape)} and y {tuple(y.shape)} differ")
    if g.device.type == "cpu" and y.device.type == "cpu":
        return epilogue_grad_plain(g, y, epi)
    check_cuda_operands(g, y)
    if g.device != y.device:
        raise ValueError(f"g on {g.device}, y on {y.device}")
    g, y = g.contiguous(), y.contiguous()
    out = torch.empty_like(g)
    n = g.numel()
    blocks = max(1, min(_cdiv(n, EPI_GRAD_THREADS), 8 * H100_SMS))
    with torch.cuda.device(g.device):
        err = _lib().tconv_epilogue_grad_f32(
            g.data_ptr(), y.data_ptr(), out.data_ptr(), n, epi.code,
            epi.slope, blocks, _stream(g))
    _check(err, "epilogue_grad")
    epilogue_grad.launches += 1
    return out


def transpose_conv2d_dx(gm, kernel, n_in: int, padding: int = 0) -> torch.Tensor:
    """dx ``(B, N, N, Cin)`` of the unified transpose conv from the masked
    cotangent ``gm (B, M, M, Cout)`` and the HWIO kernel. A CUDA tensor
    launches the kernel (and, for a split contraction, the reduce pass); a
    CPU tensor runs :func:`transpose_conv2d_dx_plain`."""
    if gm.ndim != 4 or kernel.ndim != 4 or kernel.shape[3] != gm.shape[3]:
        raise ValueError(
            f"expected gm (B, M, M, Cout) and an HWIO kernel, got "
            f"{tuple(gm.shape)} and {tuple(kernel.shape)}")
    if gm.device.type == "cpu" and kernel.device.type == "cpu":
        return transpose_conv2d_dx_plain(gm, kernel, n_in, padding)
    check_cuda_operands(gm, kernel)
    b, m, _, cout = gm.shape
    n_k, cin = kernel.shape[0], kernel.shape[2]
    if n_k < 2 or m != seg.output_size(n_in, n_k, padding):
        raise ValueError(f"bad geometry: M={m}, N={n_in}, n={n_k}, P={padding}")
    g = bwd_geometry(b, n_in, n_k, padding, cin, cout)
    gm, kernel = gm.contiguous(), kernel.contiguous()
    dx = torch.empty((b, n_in, n_in, cin), device=gm.device, dtype=torch.float32)
    part = dx if g.dx_splits == 1 else torch.empty(
        (g.dx_splits,) + tuple(dx.shape), device=gm.device, dtype=torch.float32)
    with torch.cuda.device(gm.device):
        err = _lib().tconv_dx_f32(
            gm.data_ptr(), kernel.data_ptr(), part.data_ptr(),
            b, n_in, cin, cout, n_k, g.m, g.r, *g.roffs, *g.coffs, *g.wsels,
            *g.dx_grid, g.dx_taps_per_split, _stream(gm))
    _check(err, "transpose_conv2d_dx")
    transpose_conv2d_dx.launches += 1
    if g.dx_splits > 1:
        _sum_splits((part, dx))
        transpose_conv2d_dx.reduce_launches += 1
    return dx


def transpose_conv2d_dw(x, gm, n_k: int, padding: int = 0, *,
                        with_db: bool = False):
    """dw ``(n, n, Cin, Cout)`` HWIO of the unified transpose conv from the
    input and the masked cotangent; ``with_db`` also returns ``db (Cout,) =
    sum gm``, reduced in the same kernel. A CUDA tensor launches the kernel
    (and the reduce pass, for a split contraction or db); a CPU tensor runs
    :func:`transpose_conv2d_dw_plain`."""
    if x.ndim != 4 or gm.ndim != 4 or x.shape[0] != gm.shape[0]:
        raise ValueError(
            f"expected x (B, N, N, Cin) and gm (B, M, M, Cout), got "
            f"{tuple(x.shape)} and {tuple(gm.shape)}")
    if x.device.type == "cpu" and gm.device.type == "cpu":
        return transpose_conv2d_dw_plain(x, gm, n_k, padding, with_db=with_db)
    check_cuda_operands(x, gm)
    b, n_in, _, cin = x.shape
    m, cout = gm.shape[1], gm.shape[3]
    if n_k < 2 or m != seg.output_size(n_in, n_k, padding):
        raise ValueError(f"bad geometry: M={m}, N={n_in}, n={n_k}, P={padding}")
    g = bwd_geometry(b, n_in, n_k, padding, cin, cout)
    x, gm = x.contiguous(), gm.contiguous()
    opts = dict(device=x.device, dtype=torch.float32)
    dw = torch.empty((n_k, n_k, cin, cout), **opts)
    part = dw if g.dw_splits == 1 else torch.empty((g.dw_splits,) + tuple(dw.shape),
                                                   **opts)
    db = torch.empty((cout,), **opts) if with_db else None
    db_part = torch.empty((g.dw_splits, 4, cout), **opts) if with_db else None
    with torch.cuda.device(x.device):
        err = _lib().tconv_dw_f32(
            x.data_ptr(), gm.data_ptr(), part.data_ptr(), _ptr(db_part),
            b, n_in, cin, cout, n_k, g.m, g.hp, g.pad_lo, *g.row0s, *g.col0s,
            *g.phase_of_sub, *g.dw_tile, *g.dw_grid, g.dw_positions_per_split,
            int(with_db), _stream(x))
    _check(err, "transpose_conv2d_dw")
    transpose_conv2d_dw.launches += 1
    pairs = ([(part, dw)] if g.dw_splits > 1 else []) + (
        [(db_part, db)] if with_db else [])
    if pairs:
        _sum_splits(*pairs)
        transpose_conv2d_dw.reduce_launches += 1
    return (dw, db) if with_db else dw


epilogue_grad.launches = 0
transpose_conv2d_dx.launches = 0
transpose_conv2d_dx.reduce_launches = 0
transpose_conv2d_dw.launches = 0
transpose_conv2d_dw.reduce_launches = 0


def transpose_conv2d_bwd(x, kernel, g, padding: int = 0, *, epilogue=None,
                         y=None, need_dx: bool = True):
    """``(dx, dw, db)`` of ``y = act(tconv(x, kernel) + b)`` for the
    cotangent ``g`` of ``y``: the epilogue-grad, dx and dw kernels in turn.
    ``y`` is the saved output, needed iff the epilogue has an activation;
    ``db`` is None unless the epilogue adds a bias, ``dx`` None unless
    ``need_dx``."""
    epi = epilib.canonical(epilogue)
    if epi is not None and epi.act != "none":
        if y is None:
            raise ValueError(f"epilogue {epi.tag()!r} backward needs the saved output y")
        g = epilogue_grad(g, y, epi)
    g = g.contiguous()
    dx = transpose_conv2d_dx(g, kernel, x.shape[1], padding) if need_dx else None
    with_db = epi is not None and epi.bias
    dw = transpose_conv2d_dw(x, g, kernel.shape[0], padding, with_db=with_db)
    if with_db:
        return dx, dw[0], dw[1]
    return dx, dw, None
