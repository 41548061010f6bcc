"""Phase-fused and per-phase unified transpose convolution: CUDA kernels,
their wrappers and their plain PyTorch versions. Mirrors
``repro/kernels/transpose_conv2d.py`` (``transpose_conv2d_pallas`` and its
``_fused_kernel``; ``transpose_conv2d_pallas_phase`` and its
``_phase_kernel``).

The kernel (``csrc/transpose_conv2d_fused.cu``) runs one block per (spatial
tile of the ``(Hp, Hp)`` phase plane, Cout tile, batch item), loops over Cin
chunks inside the block, and computes all four output parities from one
staged input tile. Everything it needs to know about the geometry --
phase origins, the odd-padding sub-kernel swap, tiles, grid and shared
memory -- is computed here by :func:`fused_geometry`, so the CPU tests
reach it.

:func:`transpose_conv2d_fused` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_fused_plain` for a CPU tensor; it never falls
back from one to the other. ``transpose_conv2d_fused.launches`` counts
kernel launches.

The per-phase kernel (``csrc/transpose_conv2d_phase.cu``) computes the same
function with one output parity per block, each block staging its own input
window (:func:`phase_geometry`): the segregated form the paper's unified
kernel is measured against. :func:`transpose_conv2d_phase` and
:func:`transpose_conv2d_phase_plain` follow the same rules, with
``transpose_conv2d_phase.launches``.
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

H100_SMS = 132           # streaming multiprocessors of one H100 SXM
POSITIONS_PER_BLOCK = 64  # 32 position groups x 2 positions per thread
CIN_CHUNK = 16            # kCinChunk of the kernel
MAX_R = 4                 # the kernel is built for R = ceil(n/2) of 1..4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _phase_offsets(n_in: int, n_k: int, padding: int):
    """Per-output-parity padded-input origins ``(row0s, col0s, pad_lo)``:
    ``row0s[pr]`` is the first padded-input row phase ``pr`` reads."""
    plans, pad_lo, _ = seg.plan_phases(n_in, n_k, padding)
    return (plans[0].row0, plans[2].row0), (plans[0].col0, plans[1].col0), pad_lo


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """Launch geometry of the fused kernel for one layer shape."""

    batch: int
    m: int            # output extent 2N - n + 2P
    hp: int           # phase-plane extent ceil(M / 2)
    r: int            # stacked sub-kernel extent ceil(n / 2)
    pad_lo: int       # floor(P / 2): zero rows before the input
    base_r: int       # first padded row/col any phase reads
    base_c: int
    roffs: tuple      # per output row parity, relative to base_r
    coffs: tuple
    wsels: tuple      # output parity 2*pr+pc -> stacked sub-kernel index
    th: int           # phase-plane tile (rows x cols)
    tw: int
    n_h: int
    n_w: int
    xh: int           # staged input tile th + dr + R - 1 (likewise xw)
    xw: int
    ct: int           # Cout tile: 4, 8, 16 or 32
    n_co: int
    ci_chunk: int     # cin channels staged a step
    smem_bytes: int

    @property
    def grid(self) -> tuple:
        return (self.n_h * self.n_w, self.n_co, self.batch)

    @property
    def threads(self) -> int:
        return self.ct // 4 * 32


def _cout_tile(cout: int, blocks_per_cout_tile: int) -> int:
    """The smallest of 4/8/16/32 that covers Cout, halved (not below 8)
    while the grid has fewer than two blocks per SM."""
    ct = 4
    while ct < min(cout, 32):
        ct *= 2
    while ct > 8 and blocks_per_cout_tile * _cdiv(cout, ct) < 2 * H100_SMS:
        ct //= 2
    return ct


def _smem_bytes(ci: int, xh: int, xw: int, r: int, ct: int) -> int:
    xs = -(-ci * xh * xw // 4) * 4
    return 4 * (xs + 4 * r * r * ci * ct)


@functools.lru_cache(maxsize=None)
def fused_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                   cout: int) -> FusedGeometry:
    """The fused kernel's launch geometry.

    Tiles hold at most 64 phase-plane positions (``tw = min(Hp, 8)``). The
    Cout tile is the smallest of 4/8/16/32 that covers Cout, halved (not
    below 8) while the grid has fewer than two blocks per SM. At the
    largest ``R = 4`` and ``ct = 32`` the staged chunk takes 140 KB of
    shared memory, under the 227 KB a block may use.
    """
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = _phase_offsets(n_in, n_k, padding)
    base_r, base_c = min(row0s), min(col0s)
    roffs = tuple(v - base_r for v in row0s)
    coffs = tuple(v - base_c for v in col0s)
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    tw = min(hp, 8)
    th = min(hp, POSITIONS_PER_BLOCK // tw)
    n_h, n_w = _cdiv(hp, th), _cdiv(hp, tw)
    xh = th + max(roffs) + r - 1
    xw = tw + max(coffs) + r - 1
    ct = _cout_tile(cout, n_h * n_w * batch)
    return FusedGeometry(
        batch=batch, m=m, hp=hp, r=r, pad_lo=pad_lo, base_r=base_r, base_c=base_c,
        roffs=roffs, coffs=coffs, wsels=wsels, th=th, tw=tw, n_h=n_h, n_w=n_w,
        xh=xh, xw=xw, ct=ct, n_co=_cdiv(cout, ct), ci_chunk=CIN_CHUNK,
        smem_bytes=_smem_bytes(CIN_CHUNK, xh, xw, r, ct),
    )


def transpose_conv2d_fused_plain(x, kernel, padding: int = 0, *,
                                 epilogue=None, bias=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same phase origins,
    sub-kernel stack and swap, one matmul per (parity, tap) over the whole
    phase plane, then the epilogue."""
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = fused_geometry(b, n_in, n_k, padding, cin, cout)
    lo = g.pad_lo - g.base_r
    hi = max(0, g.hp + max(g.roffs + g.coffs) + g.r - 1 - (n_in + lo))
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    stacked = seg.stack_subkernels(kernel)
    planes = []
    for pr in range(2):
        for pc in range(2):
            w = stacked[g.wsels[2 * pr + pc]]
            acc = x.new_zeros((b * g.hp * g.hp, cout))
            for p in range(g.r):
                for q in range(g.r):
                    r0, c0 = g.roffs[pr] + p, g.coffs[pc] + q
                    win = xp[:, r0 : r0 + g.hp, c0 : c0 + g.hp, :]
                    acc = acc + win.reshape(-1, cin) @ w[p, q]
            planes.append(acc.reshape(b, g.hp, g.hp, cout))
    y = torch.stack(planes, dim=3).reshape(b, g.hp, g.hp, 2, 2, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * g.hp, 2 * g.hp, cout)
    y = y[:, : g.m, : g.m, :]
    return epi.apply(y, bias) if epi is not None else y


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transpose_conv2d_fused")
    fn = lib.tconv_fused_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 27
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check_operands(x, kernel, bias) -> None:
    """Shapes and devices a transpose-conv kernel wrapper accepts."""
    if x.ndim != 4 or kernel.ndim != 4:
        raise ValueError(
            f"expected NHWC x and HWIO kernel, got {tuple(x.shape)} and "
            f"{tuple(kernel.shape)}"
        )
    if x.shape[1] != x.shape[2] or kernel.shape[0] != kernel.shape[1]:
        raise ValueError("input and kernel must be square")
    if kernel.shape[2] != x.shape[3]:
        raise ValueError(
            f"kernel Cin {kernel.shape[2]} != input channels {x.shape[3]}"
        )
    if bias is not None and tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"bias must be ({kernel.shape[3]},)")
    devs = {t.device for t in (x, kernel, bias) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")


def check_cuda_operands(*tensors) -> None:
    """The CUDA kernels take float32 tensors on a CUDA device."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")


def transpose_conv2d_fused(x, kernel, padding: int = 0, *, epilogue=None,
                           bias=None) -> torch.Tensor:
    """``act(tconv(x, kernel) + bias)`` through the fused kernel.

    x: (B, N, N, Cin) NHWC; kernel: (n, n, Cin, Cout) HWIO; bias: (Cout,)
    iff ``epilogue.bias``. Returns (B, M, M, Cout) float32,
    ``M = 2N - n + 2P``. A CUDA tensor launches the kernel (or raises); a
    CPU tensor runs :func:`transpose_conv2d_fused_plain`.
    """
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    check_operands(x, kernel, bias)
    if x.device.type == "cpu":
        return transpose_conv2d_fused_plain(
            x, kernel, padding, epilogue=epi, bias=bias
        )
    check_cuda_operands(x, kernel, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = fused_geometry(b, n_in, n_k, padding, cin, cout)
    if g.r > MAX_R:
        raise ValueError(
            f"the fused CUDA kernel takes kernels up to {2 * MAX_R}x"
            f"{2 * MAX_R}, got {n_k}x{n_k}"
        )
    x = x.contiguous()
    kernel = kernel.contiguous()
    bias = bias.contiguous() if bias is not None else None
    out = torch.empty((b, g.m, g.m, cout), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, n_in, cin, cout, n_k, g.m, g.r, g.pad_lo, g.base_r, g.base_c,
            *g.roffs, *g.coffs, *g.wsels, g.th, g.tw, g.n_h, g.n_w, g.xh, g.xw,
            g.ct, g.n_co, epi.code if epi else 0,
            epi.slope if epi else 0.0, g.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_fused launch failed: CUDA error {err}")
    transpose_conv2d_fused.launches += 1
    return out


transpose_conv2d_fused.launches = 0


# ------------------------------------------------------------ per-phase form

@dataclasses.dataclass(frozen=True)
class PhaseGeometry:
    """Launch geometry of the per-phase kernel for one layer shape."""

    batch: int
    m: int            # output extent 2N - n + 2P
    hp: int           # phase-plane extent ceil(M / 2)
    r: int            # stacked sub-kernel extent ceil(n / 2)
    pad_lo: int       # floor(P / 2): zero rows before the input
    row0s: tuple      # padded-input origin of each output row parity
    col0s: tuple
    wsels: tuple      # output parity 2*pr+pc -> stacked sub-kernel index
    th: int           # phase-plane tile (rows x cols)
    tw: int
    n_h: int
    n_w: int
    xh: int           # staged input window th + R - 1 (likewise xw)
    xw: int
    ct: int           # Cout tile: 4, 8, 16 or 32
    n_co: int
    ci_chunk: int     # cin channels staged a step
    smem_bytes: int

    @property
    def grid(self) -> tuple:
        """``(spatial tiles, Cout tiles, 4 * batch)``: the last axis is
        ``batch * 4 + output parity``."""
        return (self.n_h * self.n_w, self.n_co, 4 * self.batch)

    @property
    def threads(self) -> int:
        return self.ct // 4 * 32


@functools.lru_cache(maxsize=None)
def phase_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                   cout: int) -> PhaseGeometry:
    """The per-phase kernel's launch geometry: the fused kernel's tiles
    (at most 64 phase-plane positions, ``tw = min(Hp, 8)``) and Cout-tile
    rule, counted over four times the blocks (one per output parity). A
    block stages one ``(th + R - 1, tw + R - 1)`` window per cin chunk and
    one sub-kernel: at ``R = 4`` and ``ct = 32`` that is 40 KB."""
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = _phase_offsets(n_in, n_k, padding)
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    tw = min(hp, 8)
    th = min(hp, POSITIONS_PER_BLOCK // tw)
    n_h, n_w = _cdiv(hp, th), _cdiv(hp, tw)
    xh, xw = th + r - 1, tw + r - 1
    ct = _cout_tile(cout, 4 * n_h * n_w * batch)
    xs = _cdiv(CIN_CHUNK * xh * xw, 4) * 4
    return PhaseGeometry(
        batch=batch, m=m, hp=hp, r=r, pad_lo=pad_lo, row0s=row0s,
        col0s=col0s, wsels=wsels, th=th, tw=tw, n_h=n_h, n_w=n_w, xh=xh,
        xw=xw, ct=ct, n_co=_cdiv(cout, ct), ci_chunk=CIN_CHUNK,
        smem_bytes=4 * (xs + r * r * CIN_CHUNK * ct),
    )


def transpose_conv2d_phase_plain(x, kernel, padding: int = 0, *,
                                 epilogue=None, bias=None) -> torch.Tensor:
    """The per-phase kernel's function in plain PyTorch: each output parity
    from its own window of the padded input and its own sub-kernel, one
    matmul per tap, written into its strided slice of the output; then the
    epilogue."""
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = phase_geometry(b, n_in, n_k, padding, cin, cout)
    hi = max(0, max(g.row0s + g.col0s) + g.hp + g.r - 1 - (n_in + g.pad_lo))
    xp = F.pad(x, (0, 0, g.pad_lo, hi, g.pad_lo, hi))
    y = phase_planes(xp, seg.stack_subkernels(kernel), g.hp, g.row0s, g.col0s,
                     g.wsels)[:, : g.m, : g.m, :]
    return epi.apply(y, bias) if epi is not None else y


def phase_planes(xp, stacked, hp: int, row0s, col0s, wsels) -> torch.Tensor:
    """All four phase planes of one layer over the zero-padded input ``xp``,
    each from its own window and sub-kernel (one matmul per tap),
    interleaved into a ``(B, 2 hp, 2 hp, Cout)`` map."""
    b, cin, cout = xp.shape[0], xp.shape[3], stacked.shape[-1]
    r = stacked.shape[1]
    y = xp.new_zeros((b, 2 * hp, 2 * hp, cout))
    for par in range(4):
        pr, pc = par >> 1, par & 1
        w = stacked[wsels[par]]
        acc = xp.new_zeros((b * hp * hp, cout))
        for p in range(r):
            for q in range(r):
                r0, c0 = row0s[pr] + p, col0s[pc] + q
                win = xp[:, r0 : r0 + hp, c0 : c0 + hp, :]
                acc = acc + win.reshape(-1, cin) @ w[p, q]
        y[:, pr::2, pc::2, :] = acc.reshape(b, hp, hp, cout)
    return y


@functools.lru_cache(maxsize=None)
def _phase_lib():
    lib = _build.load("transpose_conv2d_phase")
    fn = lib.tconv_phase_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 25
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def transpose_conv2d_phase(x, kernel, padding: int = 0, *, epilogue=None,
                           bias=None) -> torch.Tensor:
    """``act(tconv(x, kernel) + bias)`` through the per-phase kernel; the
    operands and result are those of :func:`transpose_conv2d_fused`. A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs
    :func:`transpose_conv2d_phase_plain`."""
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    check_operands(x, kernel, bias)
    if x.device.type == "cpu":
        return transpose_conv2d_phase_plain(
            x, kernel, padding, epilogue=epi, bias=bias
        )
    check_cuda_operands(x, kernel, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = phase_geometry(b, n_in, n_k, padding, cin, cout)
    if g.r > MAX_R:
        raise ValueError(
            f"the per-phase CUDA kernel takes kernels up to {2 * MAX_R}x"
            f"{2 * MAX_R}, got {n_k}x{n_k}"
        )
    x = x.contiguous()
    kernel = kernel.contiguous()
    bias = bias.contiguous() if bias is not None else None
    out = torch.empty((b, g.m, g.m, cout), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _phase_lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, n_in, cin, cout, n_k, g.m, g.r, g.pad_lo, *g.row0s, *g.col0s,
            *g.wsels, g.th, g.tw, g.n_h, g.n_w, g.xh, g.xw, g.ct, g.n_co,
            epi.code if epi else 0, epi.slope if epi else 0.0, g.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_phase launch failed: CUDA error {err}")
    transpose_conv2d_phase.launches += 1
    return out


transpose_conv2d_phase.launches = 0
