"""Segregated backward of the unified transpose conv: three CUDA kernels,
their wrappers and their plain PyTorch versions. Mirrors
``repro/kernels/transpose_conv2d_bwd.py`` (``epilogue_grad_pallas``,
``transpose_conv2d_dx_pallas``, ``transpose_conv2d_dw_pallas`` and the
composer ``transpose_conv2d_bwd_pallas``).

The cotangent ``g`` of a layer ``y = act(tconv(x, K) + b)`` splits into the
four output-parity planes the forward writes, ``g_{pr,pc}[t, u] = g[2t+pr,
2u+pc]``, and both gradients become dense stride-1 sums over them:

* epilogue-grad: ``gm = g * act'(y)`` from the saved output ``y``. On the
  card the composer folds it into dx and dw: each takes ``g``, ``y`` and
  the epilogue and applies ``act'`` as it stages ``g``, so ``gm`` is never
  written; the standalone kernel stays for callers that want ``gm``.
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
``.reduce_launches``, and each of their launches that applies ``act'`` as
it stages ``g`` in ``epilogue_grad.folded_launches``; a CUDA graph's
replay adds the launches it captured (:mod:`repro_torch.graphs`). No kernel uses float atomics: a split reduction
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
from repro_torch.kernels.transpose_conv2d import MAX_R, H100_SMS, check_cuda_operands

# dx block tiles (rows = dx positions, cols = Cin) by layout: "rich" for
# Cout > 4 (256 threads of 8 x 8, 16-channel Cout steps on a cp.async ring),
# "poor" for Cout <= POOR_MAX_COUT (32 groups of DX_POOR_NP positions x 32 Cin)
DX_TILES = {"rich": (128, 128), "poor": (256, 32)}
DX_LAYOUT_CODES = {"rich": 0, "poor": 1}
DX_STAGES = 4             # depth of the rich dx kernel's cp.async ring
DX_POOR_NP = 8            # consecutive dx positions a poor-layout thread
DX_MIN_SPLIT_STEPS = 4    # Cout steps a rich dx split keeps at least
# dw block tiles (rows = Cin, cols = Cout) by layout: "rich" for Cout > 64,
# "narrow" for 4 < Cout <= 64 (both 256 threads of 8 x 8), "poor" for
# Cout <= POOR_MAX_COUT (64 Cin x 4 Cout x the R column taps of one row tap)
DW_TILES = {"rich": (128, 128), "narrow": (256, 64), "poor": (64, 4)}
DW_LAYOUT_CODES = {"rich": 0, "narrow": 0, "poor": 1}
POOR_MAX_COUT = 4
BK = 16                   # contraction step of both GEMM kernels (DW_BK too)
DW_STAGES = 3             # depth of the dw kernel's cp.async ring
DW_SLICES = 16            # row slices of a poor dw block
DX_MIN_BLOCKS = H100_SMS   # split rich dx's contraction while its grid stays within
                           # this many blocks (one an SM at 202 registers: one wave)
DW_MIN_BLOCKS = H100_SMS   # split dw's until its grid has this many (one block an SM)
MIN_DW_STEPS = 8          # ... but keep at least this many BK steps (rich) or
                          # DW_SLICES rows (poor) in each split
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
    dx_layout: str     # "rich" or "poor" (DX_TILES)
    dx_rows: int
    dx_grid: tuple     # rich: (row blocks, Cin blocks, splits);
                       # poor: (position-group blocks, Cin blocks, 1)
    dx_cpt: int        # rich: 16-channel Cout steps a stacked tap
    dx_steps: int      # rich: 4 R R cpt contraction steps
    dx_smem_bytes: int
    # dw: one GEMM per HWIO tap, rows Cin x cols Cout, contraction over the
    # B Hp Hp positions of the tap's phase plane
    dw_layout: str     # "rich", "narrow" or "poor" (DW_TILES)
    dw_tile: tuple     # (rows, cols)
    dw_positions: int
    dw_grid: tuple     # rich: (Cin blocks * Cout blocks, n*n taps, splits);
                       # poor: (Cin blocks, 4 phases * R row taps, splits)
    dw_positions_per_split: int  # rich: a multiple of BK; poor: whole rows of Hp
    dw_smem_bytes: int

    @property
    def dx_splits(self) -> int:
        return self.dx_grid[2]

    @property
    def dx_variant(self) -> tuple:
        """The compiled dx instance this geometry launches: ``("rich",)``
        or ``("poor", R)``."""
        return ("poor", self.r) if self.dx_layout == "poor" else ("rich",)

    def dx_split_steps(self, split: int) -> range:
        """The contraction steps rich dx split ``split`` sums, as the kernel
        partitions them."""
        lo = split * self.dx_steps // self.dx_splits
        return range(lo, (split + 1) * self.dx_steps // self.dx_splits)

    @property
    def dw_variant(self) -> tuple:
        """The compiled dw instance this geometry launches: ``("rich",
        rows, cols)`` or ``("poor", R)``."""
        return ("poor", self.r) if self.dw_layout == "poor" else ("rich", *self.dw_tile)

    @property
    def dw_splits(self) -> int:
        return self.dw_grid[2]


def dx_variants() -> set:
    """Every compiled instance of the dx kernels."""
    return {("rich",)} | {("poor", r) for r in range(1, MAX_R + 1)}


def dx_split_count(blocks: int, steps: int) -> int:
    """The rich dx split count, from the layer's shape: as many as keep the
    grid within DX_MIN_BLOCKS (one wave) and DX_MIN_SPLIT_STEPS steps a
    split."""
    return max(1, min(DX_MIN_BLOCKS // blocks, steps // DX_MIN_SPLIT_STEPS))


def dw_variants() -> set:
    """Every compiled instance of the dw kernels."""
    return ({("rich", *DW_TILES[k]) for k in ("rich", "narrow")}
            | {("poor", r) for r in range(1, MAX_R + 1)})


def _splits(blocks: int, steps: int, min_steps: int, min_blocks: int) -> int:
    """Shape-only split count: double while the grid is under
    ``min_blocks`` and each split keeps ``min_steps`` of ``steps``."""
    s = 1
    while blocks * s < min_blocks and steps // (2 * s) >= min_steps:
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
    dx_layout = "poor" if cout <= POOR_MAX_COUT else "rich"
    dx_tile = DX_TILES[dx_layout]
    if dx_layout == "poor":
        groups = batch * n_in * _cdiv(n_in, DX_POOR_NP)
        dx_grid = (_cdiv(groups, dx_tile[0] // DX_POOR_NP), _cdiv(cin, dx_tile[1]), 1)
        dx_cpt = dx_steps = 0
        dx_smem = 4 * 4 * r * r * dx_tile[1] * 4
    else:
        dx_blocks = (_cdiv(dx_rows, dx_tile[0]), _cdiv(cin, dx_tile[1]))
        dx_cpt = _cdiv(cout, BK)
        dx_steps = 4 * r * r * dx_cpt
        dx_grid = dx_blocks + (dx_split_count(dx_blocks[0] * dx_blocks[1], dx_steps),)
        dx_smem = 4 * DX_STAGES * sum(dx_tile) * (BK + 4)

    dw_layout = ("poor" if cout <= POOR_MAX_COUT
                 else "narrow" if cout <= DW_TILES["narrow"][1] else "rich")
    dw_tile = DW_TILES[dw_layout]
    dw_pos = batch * hp * hp
    if dw_layout == "poor":
        dw_blocks = _cdiv(cin, dw_tile[0])
        dw_taps = 4 * r
        rows = batch * hp
        dw_splits = _splits(dw_blocks * dw_taps, rows, DW_SLICES, DW_MIN_BLOCKS)
        dw_pps = _cdiv(rows, dw_splits) * hp
        dw_smem = 4 * (DW_SLICES * r * 16 * 16 + DW_SLICES * 4)
    else:
        dw_blocks = _cdiv(cin, dw_tile[0]) * _cdiv(cout, dw_tile[1])
        dw_taps = n_k * n_k
        dw_splits = _splits(dw_blocks * dw_taps, _cdiv(dw_pos, BK), MIN_DW_STEPS,
                            DW_MIN_BLOCKS)
        dw_pps = _cdiv(_cdiv(dw_pos, dw_splits), BK) * BK
        dw_smem = 4 * DW_STAGES * BK * sum(dw_tile)
    return BwdGeometry(
        batch=batch, n_in=n_in, n_k=n_k, padding=padding, cin=cin, cout=cout,
        m=m, hp=hp, r=r, pad_lo=pad_lo, row0s=row0s, col0s=col0s,
        roffs=roffs, coffs=coffs, wsels=ws, phase_of_sub=phase_of_sub,
        dx_layout=dx_layout, dx_rows=dx_rows, dx_grid=dx_grid, dx_cpt=dx_cpt,
        dx_steps=dx_steps, dx_smem_bytes=dx_smem,
        dw_layout=dw_layout, dw_tile=dw_tile, dw_positions=dw_pos,
        dw_grid=(dw_blocks, dw_taps, dw_splits), dw_positions_per_split=dw_pps,
        dw_smem_bytes=dw_smem,
    )


# ------------------------------------------------------------ plain versions

def epilogue_grad_plain(g, y, epilogue) -> torch.Tensor:
    """``g * act'(y)`` in plain PyTorch; ``g`` itself when the epilogue has
    no activation."""
    epi = _activation(epilogue)
    if epi is None:
        return g
    _check_y(g, y, epi)
    return epi.grad_from_y(g, y)


def _activation(epilogue):
    """The canonical epilogue where it has an activation (whose ``act'``
    the backward applies to ``g``), else None."""
    epi = epilib.canonical(epilogue)
    return epi if epi is not None and epi.act != "none" else None


def _parity_plane(gm, pr: int, pc: int, hp: int):
    """``(B, Hp, Hp, C)`` plane ``gm[:, 2t+pr, 2u+pc]``; rows and cols past
    the output of an odd ``M`` are zeros."""
    b, m, _, c = gm.shape
    g2 = F.pad(gm, (0, 0, 0, 2 * hp - m, 0, 2 * hp - m))
    return g2.reshape(b, hp, 2, hp, 2, c)[:, :, pr, :, pc, :]


def transpose_conv2d_dx_plain(gm, kernel, n_in: int, padding: int = 0, *,
                              y=None, epilogue=None):
    """The dx kernel's function in plain PyTorch: for each (parity, tap) a
    shifted window of the parity plane times the transposed sub-kernel.
    With an activation ``epilogue``, ``gm`` is the cotangent ``g`` and
    :func:`epilogue_grad_plain` of it and ``y`` runs first."""
    gm = epilogue_grad_plain(gm, y, epilogue)
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
                              with_db: bool = False, y=None, epilogue=None):
    """The dw kernel's function in plain PyTorch: one ``(Cin, K) x (K,
    Cout)`` product per HWIO tap over its phase plane. ``with_db`` also
    returns ``db = sum gm``. With an activation ``epilogue``, ``gm`` is the
    cotangent ``g`` and :func:`epilogue_grad_plain` of it and ``y`` runs
    first."""
    gm = epilogue_grad_plain(gm, y, epilogue)
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 27 + [ctypes.c_float, ctypes.c_void_p])
    lib.tconv_dw_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 32 + [ctypes.c_float, ctypes.c_void_p])
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
    epi = _activation(epilogue)
    if epi is None:
        return g
    _check_y(g, y, epi)
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


def _check_y(g, y, epi) -> None:
    if y is None:
        raise ValueError(f"epilogue {epi.tag()!r} backward needs the saved output y")
    if g.shape != y.shape:
        raise ValueError(f"g {tuple(g.shape)} and y {tuple(y.shape)} differ")


def _aligned(*tensors) -> bool:
    """Every tensor given starts 16-byte aligned (None is skipped)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def dx_copy_widths(gm, kernel, y=None) -> tuple:
    """``(vg, vx)`` of a dx launch: 16-byte gm (or g and ``y``, where act'
    is folded) and weight copies where Cout is a multiple of 4 and every
    operand starts 16-byte aligned, else 4-byte ones; 16-byte dx stores
    where Cin is a multiple of 4 (dx is allocated aligned). A width never
    changes a sum."""
    cout, cin = gm.shape[3], kernel.shape[2]
    return cout % 4 == 0 and _aligned(gm, kernel, y), cin % 4 == 0


def _fold_args(g, y, epilogue) -> tuple:
    """``(epi, y)`` of a dx or dw launch: the activation it folds, and ``y``
    made contiguous on ``g``'s device; ``(None, None)`` where there is no
    activation (then ``y`` is not read)."""
    epi = _activation(epilogue)
    if epi is None:
        return None, None
    _check_y(g, y, epi)
    check_cuda_operands(y)
    if y.device != g.device:
        raise ValueError(f"g on {g.device}, y on {y.device}")
    return epi, y.contiguous()


def transpose_conv2d_dx(gm, kernel, n_in: int, padding: int = 0, *, y=None,
                        epilogue=None) -> torch.Tensor:
    """dx ``(B, N, N, Cin)`` of the unified transpose conv from the masked
    cotangent ``gm (B, M, M, Cout)`` and the HWIO kernel; with an activation
    ``epilogue``, from the cotangent ``g`` of ``y`` (passed as ``gm``) and
    the saved output ``y``, ``g * act'(y)`` applied as the kernel stages
    ``g``. A CUDA tensor launches the kernel (and, for a split contraction,
    the reduce pass); a CPU tensor runs :func:`transpose_conv2d_dx_plain`."""
    if gm.ndim != 4 or kernel.ndim != 4 or kernel.shape[3] != gm.shape[3]:
        raise ValueError(
            f"expected gm (B, M, M, Cout) and an HWIO kernel, got "
            f"{tuple(gm.shape)} and {tuple(kernel.shape)}")
    if gm.device.type == "cpu" and kernel.device.type == "cpu":
        return transpose_conv2d_dx_plain(gm, kernel, n_in, padding, y=y,
                                         epilogue=epilogue)
    check_cuda_operands(gm, kernel)
    epi, y = _fold_args(gm, y, epilogue)
    b, m, _, cout = gm.shape
    n_k, cin = kernel.shape[0], kernel.shape[2]
    if n_k < 2 or m != seg.output_size(n_in, n_k, padding):
        raise ValueError(f"bad geometry: M={m}, N={n_in}, n={n_k}, P={padding}")
    g = bwd_geometry(b, n_in, n_k, padding, cin, cout)
    if g.dx_layout == "poor" and g.r > MAX_R:
        raise ValueError(f"the poor dx kernel takes kernels up to {2 * MAX_R}x"
                         f"{2 * MAX_R}, got {n_k}x{n_k}")
    gm, kernel = gm.contiguous(), kernel.contiguous()
    dx = torch.empty((b, n_in, n_in, cin), device=gm.device, dtype=torch.float32)
    part = dx if g.dx_splits == 1 else torch.empty(
        (g.dx_splits,) + tuple(dx.shape), device=gm.device, dtype=torch.float32)
    vg, vx = dx_copy_widths(gm, kernel, y)
    with torch.cuda.device(gm.device):
        err = _lib().tconv_dx_f32(
            gm.data_ptr(), _ptr(y), kernel.data_ptr(), part.data_ptr(),
            b, n_in, cin, cout, n_k, g.m, g.r, *g.roffs, *g.coffs, *g.wsels,
            DX_LAYOUT_CODES[g.dx_layout], *DX_TILES[g.dx_layout], *g.dx_grid,
            g.dx_cpt, g.dx_steps, int(vg), int(vx), g.dx_smem_bytes,
            epi.code if epi else 0, epi.slope if epi else 0.0, _stream(gm))
    _check(err, "transpose_conv2d_dx")
    transpose_conv2d_dx.launches += 1
    if epi is not None:
        epilogue_grad.folded_launches += 1
    if g.dx_splits > 1:
        _sum_splits((part, dx))
        transpose_conv2d_dx.reduce_launches += 1
    return dx


def transpose_conv2d_dw(x, gm, n_k: int, padding: int = 0, *,
                        with_db: bool = False, y=None, epilogue=None):
    """dw ``(n, n, Cin, Cout)`` HWIO of the unified transpose conv from the
    input and the masked cotangent; ``with_db`` also returns ``db (Cout,) =
    sum gm``, reduced in the same kernel. With an activation ``epilogue``,
    ``gm`` is the cotangent ``g`` of ``y`` and ``g * act'(y)`` is applied
    as the kernel stages ``g``. A CUDA tensor launches the kernel (and the
    reduce pass, for a split contraction or db); a CPU tensor runs
    :func:`transpose_conv2d_dw_plain`."""
    if x.ndim != 4 or gm.ndim != 4 or x.shape[0] != gm.shape[0]:
        raise ValueError(
            f"expected x (B, N, N, Cin) and gm (B, M, M, Cout), got "
            f"{tuple(x.shape)} and {tuple(gm.shape)}")
    if x.device.type == "cpu" and gm.device.type == "cpu":
        return transpose_conv2d_dw_plain(x, gm, n_k, padding, with_db=with_db, y=y,
                                         epilogue=epilogue)
    check_cuda_operands(x, gm)
    epi, y = _fold_args(gm, y, epilogue)
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
    # 16-byte copies need aligned rows; the copy width never changes a sum
    vx = cin % 4 == 0 and x.data_ptr() % 16 == 0
    vw = cout % 4 == 0 and _aligned(gm, y)
    per_split = g.dw_positions_per_split // (g.hp if g.dw_layout == "poor" else 1)
    with torch.cuda.device(x.device):
        err = _lib().tconv_dw_f32(
            x.data_ptr(), gm.data_ptr(), _ptr(y), part.data_ptr(), _ptr(db_part),
            b, n_in, cin, cout, n_k, g.m, g.hp, g.pad_lo, *g.row0s, *g.col0s,
            *g.wsels, *g.phase_of_sub, DW_LAYOUT_CODES[g.dw_layout], *g.dw_tile,
            *g.dw_grid, per_split, int(with_db), int(vx), int(vw), g.dw_smem_bytes,
            epi.code if epi else 0, epi.slope if epi else 0.0, _stream(x))
    _check(err, "transpose_conv2d_dw")
    transpose_conv2d_dw.launches += 1
    if epi is not None:
        epilogue_grad.folded_launches += 1
    pairs = ([(part, dw)] if g.dw_splits > 1 else []) + (
        [(db_part, db)] if with_db else [])
    if pairs:
        _sum_splits(*pairs)
        transpose_conv2d_dw.reduce_launches += 1
    return (dw, db) if with_db else dw


epilogue_grad.launches = 0
epilogue_grad.folded_launches = 0   # dx and dw launches that apply act' as they stage g
transpose_conv2d_dx.launches = 0
transpose_conv2d_dx.reduce_launches = 0
transpose_conv2d_dw.launches = 0
transpose_conv2d_dw.reduce_launches = 0


def transpose_conv2d_bwd(x, kernel, g, padding: int = 0, *, epilogue=None,
                         y=None, need_dx: bool = True, need_dw: bool = True):
    """``(dx, dw, db)`` of ``y = act(tconv(x, kernel) + b)`` for the
    cotangent ``g`` of ``y``. ``y`` is the saved output, needed iff the
    epilogue has an activation; ``db`` is None unless the epilogue adds a
    bias and ``need_dw``, ``dx`` None unless ``need_dx``, ``dw`` None
    unless ``need_dw`` (dw and db are one kernel's). On the card the dx and
    dw kernels take ``g`` and ``y`` and apply ``act'`` as they stage ``g``
    (two kernels; ``gm`` is never written); on the CPU the plain
    epilogue-grad runs once, then plain dx and dw."""
    epi = epilib.canonical(epilogue)
    act = _activation(epi)
    if act is not None and g.device.type == "cpu":
        g, act = epilogue_grad_plain(g, y, act), None
    g = g.contiguous()
    dx = (transpose_conv2d_dx(g, kernel, x.shape[1], padding, y=y, epilogue=act)
          if need_dx else None)
    if not need_dw:
        return dx, None, None
    with_db = epi is not None and epi.bias
    dw = transpose_conv2d_dw(x, g, kernel.shape[0], padding, with_db=with_db, y=y,
                             epilogue=act)
    if with_db:
        return dx, dw[0], dw[1]
    return dx, dw, None
