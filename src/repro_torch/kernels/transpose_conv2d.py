"""Phase-fused and per-phase unified transpose convolution: CUDA kernels,
their wrappers and their plain PyTorch versions. Mirrors
``repro/kernels/transpose_conv2d.py`` (``transpose_conv2d_pallas`` and its
``_fused_kernel``; ``transpose_conv2d_pallas_phase`` and its
``_phase_kernel``).

The fused kernel (``csrc/transpose_conv2d_fused.cu``) computes all four
output parities of a tile of the ``(Hp, Hp)`` phase plane from one staged
halo tile a Cin chunk. Each thread keeps a register micro-tile of 4
parities x ``FUSED_PW`` positions of a row x 4 channels; Cin chunks stream
through a ``FUSED_STAGES``-deep ``cp.async`` ring. One of two layouts
(:data:`FUSED_LAYOUTS`) is chosen by Cout: "rich" (256 threads over 64
channels x 64 positions) or "poor" (Cout <= 4: 128 threads over 512
positions). Where an image holds fewer than :data:`SPLIT_TARGET` blocks,
Cin is split across blocks and a second pass adds the splits in order.
Everything the kernel needs to know -- phase origins, the odd-padding
sub-kernel swap, layout, tiles, chunks, splits and shared memory -- is
computed here by :func:`fused_geometry` from the layer's shape, never from
the batch beyond the grid, so the CPU tests reach it and a batched call
gives each sample its unbatched bits.

:func:`transpose_conv2d_fused` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_fused_plain` for a CPU tensor; it never falls
back from one to the other. ``transpose_conv2d_fused.launches`` counts
kernel launches, ``.reduce_launches`` the split passes; a CUDA graph's
replay adds the launches it captured (:mod:`repro_torch.graphs`).

The per-phase kernel (``csrc/transpose_conv2d_phase.cu``) computes the same
function with one output parity per block, each block staging its own input
window and its one sub-kernel: the segregated form the paper's unified
kernel is measured against, built from the fused kernel's machinery (the
cp.async ring, a single-parity register micro-tile of 4 rows x
``FUSED_PW`` positions x 4 channels, layouts by Cout, shape-only Cin
splits) with only the unification taken out (:func:`phase_geometry`,
:data:`PHASE_LAYOUTS`). :func:`transpose_conv2d_phase` and
:func:`transpose_conv2d_phase_plain` follow the same rules, with
``transpose_conv2d_phase.launches`` and ``.reduce_launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch
import torch.nn.functional as F

from repro_torch.core import segregation as seg
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epilib

H100_SMS = 132           # streaming multiprocessors of one H100 SXM
SMEM_LIMIT = 232_448     # bytes of shared memory one block may use on Hopper
MAX_R = 4                # the kernels are built for R = ceil(n/2) of 1..4
# The fused kernel's constants (kStages, kPW and the layouts of its source).
FUSED_STAGES = 3         # depth of the cp.async ring
FUSED_PW = 4             # positions along a phase-plane row a thread
POOR_MAX_COUT = 4        # the "poor" layout serves Cout up to this
SPLIT_TARGET = 16        # blocks per image a Cin split aims for
MAX_SPLITS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """A thread layout of the fused kernel: ``ncg`` channel groups of 4 x
    ``npg`` position groups of ``FUSED_PW`` consecutive positions, over a
    tile ``tw`` positions wide."""

    name: str
    code: int      # the layout argument of tconv_fused_f32
    ncg: int
    npg: int
    tw: int

    @property
    def th(self) -> int:
        return self.npg * FUSED_PW // self.tw

    def ci_chunk(self, r: int) -> int:
        """Cin channels a ring stage holds: 4 where a rich layout's R >= 3
        weight chunk would crowd the ring out of shared memory, else 8."""
        return 4 if self.name == "rich" and r > 2 else 8


FUSED_LAYOUTS = {
    "rich": FusedLayout("rich", 0, ncg=16, npg=16, tw=8),     # 64 ch x 8x8
    "poor": FusedLayout("poor", 1, ncg=1, npg=128, tw=32),    # 4 ch x 16x32
}


def _phase_offsets(n_in: int, n_k: int, padding: int):
    """Per-output-parity padded-input origins ``(row0s, col0s, pad_lo)``:
    ``row0s[pr]`` is the first padded-input row phase ``pr`` reads."""
    plans, pad_lo, _ = seg.plan_phases(n_in, n_k, padding)
    return (plans[0].row0, plans[2].row0), (plans[0].col0, plans[1].col0), pad_lo


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """Launch geometry of the fused kernel for one layer shape. Only
    ``batch`` (the grid's last axis) depends on the batch."""

    batch: int
    m: int            # output extent 2N - n + 2P
    hp: int           # phase-plane extent ceil(M / 2)
    r: int            # stacked sub-kernel extent ceil(n / 2)
    d: int            # parity 1's rows start d rows after parity 0's (P even: 1)
    pad_lo: int       # floor(P / 2): zero rows before the input
    base_r: int       # first padded row/col any phase reads
    base_c: int
    roffs: tuple      # per output row parity, relative to base_r: (0, d)
    coffs: tuple
    wsels: tuple      # output parity 2*pr+pc -> stacked sub-kernel index
    layout: str       # "rich" or "poor" (FUSED_LAYOUTS)
    ncg: int          # channel groups of 4 a block
    npg: int          # position groups a block
    th: int           # phase-plane tile (rows x cols)
    tw: int
    n_h: int
    n_w: int
    xh: int           # staged rows th + d + R - 1
    xw: int           # staged cols tw + d + R - 1
    x_pitch: int      # their pitch in shared memory (xw made odd)
    patch_rows: int   # input rows a thread walks: R + d
    patch_cols: int   # register patch a row: FUSED_PW + R - 1 + d pixels
    ct: int           # Cout tile: 4 * ncg
    n_co: int
    ci_chunk: int     # Cin channels a ring stage holds
    n_chunks: int
    splits: int       # Cin splits across blocks (1: no second pass)
    stages: int
    vx: bool          # 16-byte input copies (Cin a multiple of 4)
    vw: bool          # 16-byte weight copies and stores (Cout a multiple of 4)
    smem_bytes: int

    @property
    def grid(self) -> tuple:
        """``(spatial tiles, splits * Cout tiles, batch)``."""
        return (self.n_h * self.n_w, self.splits * self.n_co, self.batch)

    @property
    def threads(self) -> int:
        return self.ncg * self.npg

    @property
    def variant(self) -> tuple:
        """The compiled instance this geometry launches."""
        return (self.layout, self.r, self.d)

    @property
    def summation_order(self) -> tuple:
        """The fields that fix the order of every output's sum: split,
        chunk, channel group, tap, channel, in that order."""
        return (self.layout, self.r, self.d, self.ci_chunk, self.n_chunks,
                self.splits)

    def split_chunks(self, split: int) -> range:
        """The Cin chunks split ``split`` sums, as the kernel partitions
        them."""
        lo = split * self.n_chunks // self.splits
        return range(lo, (split + 1) * self.n_chunks // self.splits)


def fused_variants() -> set:
    """Every compiled ``(layout, R, d)`` instance the geometry can choose.
    The copy widths ``(vx, vw)`` are chosen at run time inside each."""
    return set(itertools.product(FUSED_LAYOUTS, range(1, MAX_R + 1), (0, 1)))


def _cin_splits(blocks_per_image: int, n_chunks: int) -> int:
    """Powers of two, until an image holds SPLIT_TARGET blocks, each split
    keeps a chunk, or MAX_SPLITS."""
    s = 1
    while (blocks_per_image * s < SPLIT_TARGET
           and 2 * s <= min(n_chunks, MAX_SPLITS)):
        s *= 2
    return s


def _fused_smem_bytes(ci: int, xh: int, x_pitch: int, r: int, ct: int,
                      th: int, tw: int) -> int:
    """The larger of the ring, FUSED_STAGES x (input chunk
    [ci/4][xh][pitch][4] + weight chunk [ci][4][R][R][ct]) floats, and the
    output tile that reuses it after the loop, [2 th][2 tw][ct + 4] floats
    with a skew of 4 floats for each 8 columns."""
    ring = FUSED_STAGES * (ci * xh * x_pitch + ci * 4 * r * r * ct)
    out = 4 * th * tw * (ct + 4) + 4 * ((2 * tw - 1) >> 3)
    return 4 * max(ring, out)


@functools.lru_cache(maxsize=None)
def fused_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                   cout: int) -> FusedGeometry:
    """The fused kernel's launch geometry.

    The layout is "poor" for Cout <= POOR_MAX_COUT, else "rich". Cin is
    split across blocks (a power of two, at most MAX_SPLITS, each split
    keeping a chunk) until one image's tiles x Cout tiles x splits reach
    SPLIT_TARGET blocks. The shared-memory ring is largest for a rich R = 4
    (204,096 bytes, under the 232,448 a block may use).
    """
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = _phase_offsets(n_in, n_k, padding)
    base_r, base_c = min(row0s), min(col0s)
    roffs = tuple(v - base_r for v in row0s)
    coffs = tuple(v - base_c for v in col0s)
    if roffs != coffs or roffs not in ((0, 0), (0, 1)):
        raise ValueError(f"unexpected phase origins {row0s}, {col0s}")
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    lay = FUSED_LAYOUTS["poor" if cout <= POOR_MAX_COUT else "rich"]
    d = roffs[1]
    th, tw = lay.th, lay.tw
    n_h, n_w = _cdiv(hp, th), _cdiv(hp, tw)
    xh, xw = th + d + r - 1, tw + d + r - 1
    x_pitch = xw | 1
    ct = 4 * lay.ncg
    n_co = _cdiv(cout, ct)
    ci = lay.ci_chunk(r)
    n_chunks = _cdiv(cin, ci)
    return FusedGeometry(
        batch=batch, m=m, hp=hp, r=r, d=d, pad_lo=pad_lo, base_r=base_r,
        base_c=base_c, roffs=roffs, coffs=coffs, wsels=wsels, layout=lay.name,
        ncg=lay.ncg, npg=lay.npg, th=th, tw=tw, n_h=n_h, n_w=n_w, xh=xh, xw=xw,
        x_pitch=x_pitch, patch_rows=r + d, patch_cols=FUSED_PW + r - 1 + d,
        ct=ct, n_co=n_co, ci_chunk=ci, n_chunks=n_chunks,
        splits=_cin_splits(n_h * n_w * n_co, n_chunks), stages=FUSED_STAGES,
        vx=cin % 4 == 0, vw=cout % 4 == 0,
        smem_bytes=_fused_smem_bytes(ci, xh, x_pitch, r, ct, th, tw),
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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 26
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
    part = (torch.empty((g.splits, b, g.m, g.m, cout), device=x.device,
                        dtype=torch.float32) if g.splits > 1 else None)
    # 16-byte copies need aligned rows; the copy width never changes a sum
    vx = g.vx and x.data_ptr() % 16 == 0
    vw = g.vw and kernel.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, n_in, cin, cout, n_k, g.m, g.r, g.d,
            g.base_r - g.pad_lo, g.base_c - g.pad_lo, *g.wsels,
            FUSED_LAYOUTS[g.layout].code, int(vx), int(vw), g.th, g.tw, g.ci_chunk,
            g.n_h, g.n_w, g.n_co, g.splits, g.n_chunks,
            epi.code if epi else 0, epi.slope if epi else 0.0, g.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_fused launch failed: CUDA error {err}")
    transpose_conv2d_fused.launches += 1
    if g.splits > 1:
        transpose_conv2d_fused.reduce_launches += 1
    return out


transpose_conv2d_fused.launches = 0
transpose_conv2d_fused.reduce_launches = 0


# ------------------------------------------------------------ per-phase form

@dataclasses.dataclass(frozen=True)
class PhaseLayout:
    """A thread layout of the per-phase kernel: ``ncg`` channel groups of 4
    x ``threads / ncg`` warp rows, each taking a position group of
    ``FUSED_PW`` x ``PHASE_PH`` positions or, with ``ks`` slices, a share
    of every Cin chunk; ``pgw`` position groups along a tile row."""

    name: str
    code: int        # the layout argument of tconv_phase_f32
    ncg: int
    threads: int

    def pgw(self, ks: int) -> int:
        return (2 if ks == 1 else 1) if self.name == "rich" else 8

    def ci_chunk(self, r: int, ks: int) -> int:
        """Cin channels a ring stage holds: 16 for a rich ks = 4 (a quad
        each warp), else 8 for a rich R <= 2, else 4."""
        if self.name == "poor":
            return 4
        return 16 if ks == 4 else 8 if r <= 2 else 4


PHASE_LAYOUTS = {
    "rich": PhaseLayout("rich", 0, ncg=32, threads=128),   # 128 ch x 8x8 or 4x4
    "poor": PhaseLayout("poor", 1, ncg=1, threads=64),     # 4 ch x 32x32
}
PHASE_PH = 4               # the micro-tile's phase-plane rows (kPH)
PHASE_STAGES = 3           # depth of the per-phase kernel's cp.async ring
PHASE_SPLIT_TARGET = 32    # blocks per image a per-phase Cin split aims for
PHASE_KS_MAX_R = 2         # ks = 4 instances exist for R up to this


def _skew(c: int) -> int:
    """The staged column of pixel column ``c``: a 16-byte gap after every
    4 pixels, so side-by-side position groups read distinct bank groups."""
    return c + (c >> 2)


@dataclasses.dataclass(frozen=True)
class PhaseGeometry:
    """Launch geometry of the per-phase kernel for one layer shape. Only
    ``batch`` (the grid's last axis) depends on the batch."""

    batch: int
    m: int            # output extent 2N - n + 2P
    hp: int           # phase-plane extent ceil(M / 2)
    r: int            # stacked sub-kernel extent ceil(n / 2)
    pad_lo: int       # floor(P / 2): zero rows before the input
    row0s: tuple      # padded-input origin of each output row parity
    col0s: tuple
    wsels: tuple      # output parity 2*pr+pc -> stacked sub-kernel index
    layout: str       # "rich" or "poor" (PHASE_LAYOUTS)
    ks: int           # warp slices of each Cin chunk (4 on planes up to 4x4)
    ncg: int          # channel groups of 4 a block
    threads: int
    th: int           # phase-plane tile (rows x cols)
    tw: int
    n_h: int
    n_w: int
    xh: int           # staged window th + R - 1 (likewise xw)
    xw: int
    x_pitch: int      # staged columns of a window row, skewed
    ct: int           # Cout tile: 4 * ncg
    n_co: int
    ci_chunk: int     # Cin channels a ring stage holds
    n_chunks: int
    splits: int       # Cin splits across blocks (1: no second pass)
    stages: int
    vx: bool          # 16-byte input copies (Cin a multiple of 4)
    vw: bool          # 16-byte weight copies and stores (Cout a multiple of 4)
    smem_bytes: int

    @property
    def grid(self) -> tuple:
        """``(spatial tiles, splits * Cout tiles, 4 * batch)``: the last
        axis is ``batch * 4 + output parity``."""
        return (self.n_h * self.n_w, self.splits * self.n_co, 4 * self.batch)

    @property
    def variant(self) -> tuple:
        """The compiled instance this geometry launches."""
        return (self.layout, self.r, self.ks)

    @property
    def summation_order(self) -> tuple:
        """The fields that fix the order of every output's sum: split,
        chunk, warp slice, channel group, tap, channel, in that order."""
        return (self.layout, self.r, self.ks, self.ci_chunk, self.n_chunks,
                self.splits)

    def split_chunks(self, split: int) -> range:
        """The Cin chunks split ``split`` sums, as the kernel partitions
        them."""
        lo = split * self.n_chunks // self.splits
        return range(lo, (split + 1) * self.n_chunks // self.splits)

    def origins(self) -> tuple:
        """The input row and column of staged row/col 0 of tile (0, 0), per
        row parity and per column parity (the launcher's org_r, org_c)."""
        return (tuple(v - self.pad_lo for v in self.row0s),
                tuple(v - self.pad_lo for v in self.col0s))


def phase_variants() -> set:
    """Every compiled ``(layout, R, ks)`` instance the geometry can choose.
    (One parity's window starts at its own origin, so the fused kernel's
    parity offset d has no counterpart here.) The copy widths are chosen at
    run time inside each."""
    return ({("rich", r, 1) for r in range(1, MAX_R + 1)}
            | {("rich", r, 4) for r in range(1, PHASE_KS_MAX_R + 1)}
            | {("poor", r, 1) for r in range(1, MAX_R + 1)})


def _phase_smem_bytes(ci: int, xh: int, x_pitch: int, r: int, ct: int, ks: int,
                      th: int, tw: int) -> int:
    """The larger of the ring, PHASE_STAGES x (window chunk
    [ci/4][xh][pitch][4] + weight chunk [ci][R][R][ct]) floats, and the
    output tile that reuses it after the loop, [ks][th][skewed tw][ct]."""
    ring = PHASE_STAGES * (ci * xh * x_pitch + ci * r * r * ct)
    out = ks * th * (_skew(tw - 1) + 1) * ct
    return 4 * max(ring, out)


@functools.lru_cache(maxsize=None)
def phase_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                   cout: int) -> PhaseGeometry:
    """The per-phase kernel's launch geometry.

    The layout is "poor" for Cout <= POOR_MAX_COUT, else "rich"; a rich
    layout on a phase plane of at most 4 x 4 with R <= PHASE_KS_MAX_R gives
    each warp a quarter of every Cin chunk (ks = 4) in place of a position
    group. Cin is split across blocks (a power of two, at most MAX_SPLITS,
    each split keeping a chunk) until one image's four parities x tiles x
    Cout tiles x splits reach PHASE_SPLIT_TARGET blocks. The shared memory
    is largest for a rich R = 4 (105,168 bytes).
    """
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = _phase_offsets(n_in, n_k, padding)
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    lay = PHASE_LAYOUTS["poor" if cout <= POOR_MAX_COUT else "rich"]
    ks = 4 if lay.name == "rich" and hp <= PHASE_PH and r <= PHASE_KS_MAX_R else 1
    pgw = lay.pgw(ks)
    npg = lay.threads // lay.ncg // ks
    tw, th = FUSED_PW * pgw, PHASE_PH * (npg // pgw)
    n_h, n_w = _cdiv(hp, th), _cdiv(hp, tw)
    xh, xw = th + r - 1, tw + r - 1
    x_pitch = _skew(xw - 1) + 1
    ct = 4 * lay.ncg
    n_co = _cdiv(cout, ct)
    ci = lay.ci_chunk(r, ks)
    n_chunks = _cdiv(cin, ci)
    splits = 1
    while (4 * n_h * n_w * n_co * splits < PHASE_SPLIT_TARGET
           and 2 * splits <= min(n_chunks, MAX_SPLITS)):
        splits *= 2
    return PhaseGeometry(
        batch=batch, m=m, hp=hp, r=r, pad_lo=pad_lo, row0s=row0s,
        col0s=col0s, wsels=wsels, layout=lay.name, ks=ks, ncg=lay.ncg,
        threads=lay.threads, th=th, tw=tw, n_h=n_h, n_w=n_w, xh=xh, xw=xw,
        x_pitch=x_pitch, ct=ct, n_co=n_co, ci_chunk=ci, n_chunks=n_chunks,
        splits=splits, stages=PHASE_STAGES, vx=cin % 4 == 0, vw=cout % 4 == 0,
        smem_bytes=_phase_smem_bytes(ci, xh, x_pitch, r, ct, ks, th, tw),
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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 28
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
    part = (torch.empty((g.splits, b, g.m, g.m, cout), device=x.device,
                        dtype=torch.float32) if g.splits > 1 else None)
    # 16-byte copies need aligned rows; the copy width never changes a sum
    vx = g.vx and x.data_ptr() % 16 == 0
    vw = g.vw and kernel.data_ptr() % 16 == 0
    org_r, org_c = g.origins()
    with torch.cuda.device(x.device):
        err = _phase_lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, n_in, cin, cout, n_k, g.m, g.r, *org_r, *org_c, *g.wsels,
            PHASE_LAYOUTS[g.layout].code, g.ks, int(vx), int(vw), g.th, g.tw,
            g.ci_chunk, g.n_h, g.n_w, g.n_co, g.splits, g.n_chunks,
            epi.code if epi else 0, epi.slope if epi else 0.0, g.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_phase launch failed: CUDA error {err}")
    transpose_conv2d_phase.launches += 1
    if g.splits > 1:
        transpose_conv2d_phase.reduce_launches += 1
    return out


transpose_conv2d_phase.launches = 0
transpose_conv2d_phase.reduce_launches = 0
