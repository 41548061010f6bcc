"""Layer-pair transpose convolution: two stacked stride-2 layers from one
CUDA launch, the interface between them kept on chip. Mirrors
``repro/kernels/transpose_conv2d_pair.py`` (``transpose_conv2d_pair_pallas``
and its ``_pair_kernel``).

The TPU kernel holds the producer's whole output plane as a VMEM scratch
slab and sums over ``cin`` and ``mid`` in sequential grid steps. On Hopper a
block has at most 227 KB of shared memory and blocks run in no order, so
the kernel (``csrc/transpose_conv2d_pair.cu``) runs one thread-block
cluster of up to :data:`CLUSTER_MAX` blocks per batch item instead: each
block computes a slice of the interface channels over the whole plane into
its own shared memory, and after a cluster barrier the blocks share the
output's tiles, staging the interface windows they read through
distributed shared memory. Both phases run the unified kernel's register
micro-tile (``csrc/tconv_microkernel.cuh``) with the contraction split
across the block's warps where a phase's tile holds fewer than 256
micro-tiles. :func:`pair_launch_geometry` is that partition, a function of
the pair's shape alone; :func:`pair_smem_bytes` is the shared memory a
block of it asks for at launch, which the plan pass budgets against
:data:`PAIR_SMEM_BUDGET_BYTES`.

:func:`transpose_conv2d_pair` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_pair_plain` for a CPU tensor; it never falls
back from one to the other, and raises for a pair whose blocks would need
more shared memory than a block may have. ``transpose_conv2d_pair.launches``
counts kernel launches; a CUDA graph's replay adds the launches it captured
(:mod:`repro_torch.graphs`).
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
from repro_torch.kernels.transpose_conv2d import (
    MAX_R,
    _cdiv,
    _phase_offsets,
    check_cuda_operands,
    phase_planes,
)

# Shared memory one block may use on an H100 (227 KB of the SM's 256 KB).
PAIR_SMEM_BUDGET_BYTES = 232_448
THREADS = 256        # kThreads of the kernel
CLUSTER_MAX = 16     # blocks a cluster (above 8 a non-portable size)
PW = 4               # positions along a phase-plane row a micro-tile (kPW)
MICRO = 64           # accumulators a thread: 4 parities x PW x 4 channels
RING = 3             # cp.async ring depth where it fits beside the interface
MAX_KS = 16          # contraction splits a block at most
RED_FLOATS = THREADS * MICRO   # the split sums of a tile, at its end


def pair_geometry(n_in: int, n_k: int, padding: int) -> dict:
    """Static geometry of the pair, as the reference computes it.

    ``m1`` is the interface extent, ``m2`` the pair output extent; ``np1``
    the padded-input plane extent the producer reads; ``s2`` the padded
    interface extent the consumer's phase windows cover (low ``pad_lo2``
    zeros + the ``m1`` interface + high zeros for over-computed windows).
    """
    R = seg.ceil_half(n_k)
    m1 = seg.output_size(n_in, n_k, padding)
    m2 = seg.output_size(m1, n_k, padding)
    hp1, hp2 = (m1 + 1) // 2, (m2 + 1) // 2
    row0s1, col0s1, pad_lo1 = _phase_offsets(n_in, n_k, padding)
    row0s2, col0s2, pad_lo2 = _phase_offsets(m1, n_k, padding)
    need1 = max(row0s1 + col0s1) + hp1 + R - 1
    pad_hi1 = max(0, need1 - (n_in + pad_lo1))
    need2 = max(row0s2 + col0s2) + hp2 + R - 1
    pad_hi2 = max(0, need2 - (m1 + pad_lo2))
    return dict(
        R=R, m1=m1, m2=m2, hp1=hp1, hp2=hp2,
        row0s1=row0s1, col0s1=col0s1, pad_lo1=pad_lo1, pad_hi1=pad_hi1,
        np1=pad_lo1 + n_in + pad_hi1,
        row0s2=row0s2, col0s2=col0s2, pad_lo2=pad_lo2, pad_hi2=pad_hi2,
        s2=pad_lo2 + m1 + pad_hi2,
    )


# The kernel's PairArgs, in order: the int array the wrapper passes.
_GEOMETRY_FIELDS = (
    "batch", "n_in", "c0", "c1", "c2", "n_k", "m1", "m2", "cl", "qpr", "n_bands", "rpb",
    "wsels", "org1r", "org1c", "hp1", "th1", "tw1", "n_w1", "ncg1", "ks1", "nct1",
    "xh1", "xwr1", "xp1", "nst1",
    "s2", "pad_lo2", "b0r", "b0c", "hp2", "th2", "tw2", "n_w2", "n_sp2", "ncg2",
    "ks2", "n_co2", "xh2", "xwr2", "xp2", "nst2", "ring",
)


@dataclasses.dataclass(frozen=True)
class PhaseTile:
    """One phase's tile: ``ncg`` channel quads x ``th`` rows of ``tw``
    positions of the phase plane (``tw / PW`` micro-tiles a row), the
    contraction split ``ks = min(MAX_KS, THREADS / micro-tiles)`` ways
    across the block (a ring stage holds ``4 * ks`` input channels, one quad
    each split; threads past ``ks`` splits idle), and the staged input
    window of ``xh`` rows of ``xwr`` pixels at a pitch of ``xp``."""

    ncg: int
    th: int
    tw: int
    ks: int
    xh: int
    xwr: int
    xp: int
    stage_floats: int   # a ring stage: input window, then weights

    @property
    def ci(self) -> int:
        return 4 * self.ks


def _phase_tile(ncg: int, pgr: int, th: int, r: int, d: int) -> PhaseTile:
    ks = min(MAX_KS, THREADS // (ncg * pgr * th))
    tw = PW * pgr
    xh, xwr = th + r - 1 + d, tw + r - 1 + d
    xp = xwr | 1          # odd pitch: a warp's patch loads spread over banks
    # the window [quad][row][col][4], then the weights [ci][tap][4 ncg]
    return PhaseTile(ncg=ncg, th=th, tw=tw, ks=ks, xh=xh, xwr=xwr, xp=xp,
                     stage_floats=ks * xh * xp * 4 + 4 * ks * 4 * r * r * 4 * ncg)


def _tile_options(rows: int, cols: int, r: int, d: int):
    """Every tile a phase plane of ``rows`` x ``cols`` positions may take,
    in the order ties are broken (more channels, then wider, then taller
    first)."""
    out = []
    for ncg in (16, 8, 4, 2, 1):
        for pgr in (8, 4, 2, 1):
            for th in (64, 32, 16, 8, 4, 2, 1):
                if (ncg * pgr * th > THREADS or th > rows
                        or PW * pgr > _cdiv(cols, PW) * PW):
                    continue
                out.append(_phase_tile(ncg, pgr, th, r, d))
    return out


def _stage_cost(t: PhaseTile, r: int, remote: bool) -> float:
    """Issue slots a thread spends on one ring stage: the micro-tile's FMAs
    and shared loads, its share of the copies (a remote interface read
    costs about twice a cp.async) and the barrier."""
    fma = 256 * r * r
    loads = 16 * r * r + (r + 1) * (PW + r)
    x_pieces = t.ks * t.xh * t.xwr / THREADS
    w_pieces = t.ncg * t.ci * 4 * r * r / THREADS
    return fma + loads + (12 if remote else 6) * x_pieces + 6 * w_pieces + 40


def _choose(options, cost, iface: int):
    """The cheapest tile whose ring fits beside the interface slice: with
    RING stages if any does, else with 2; else the smallest (the pair is
    then over budget). Returns ``(tile, ring)``."""
    room = PAIR_SMEM_BUDGET_BYTES // 4 - iface
    for ring in (RING, 2):
        fit = [t for t in options if max(ring * t.stage_floats, RED_FLOATS) <= room]
        if fit:
            return min(fit, key=cost), ring
    return min(options, key=lambda t: t.stage_floats), 2


@dataclasses.dataclass(frozen=True)
class PairLaunch:
    """The pair kernel's partition of one pair shape (batch-free: a launch
    runs one cluster of ``cl`` blocks per batch item)."""

    n_in: int
    n_k: int
    c0: int
    c1: int
    c2: int
    r: int
    d: int            # parity 1's rows start d rows after parity 0's (P even: 1)
    m1: int
    m2: int
    wsels: tuple      # output parity -> stacked sub-kernel, both layers
    cl: int           # blocks in a batch item's cluster: groups x n_bands
    qpr: int          # interface channel quads a block owns (a group's)
    n_bands: int      # bands of padded interface rows (1: the whole plane)
    rpb: int          # padded interface rows a band
    # producer: each block over the phase rows that write its band, for its
    # own 4 * qpr channels, in (th1, tw1) x ncg1-quad tiles
    org1r: int        # input row / col of staged row / col 0 at tile (0, 0)
    org1c: int
    hp1: int
    n_w1: int
    nct1: int         # channel tiles of a block's 4 * qpr channels
    nst1: int         # ring stages: C0 over 4 * ks1 channels a stage
    # interface [qpr][s2][s2][4] with the consumer's zero halo, and consumer
    s2: int
    pad_lo2: int
    b0r: int          # first padded-interface row / col a phase window reads
    b0c: int
    hp2: int
    n_w2: int
    n_sp2: int
    n_co2: int        # C2 tiles; work tiles n_sp2 * n_co2 go round-robin
    nst2: int
    ring: int         # cp.async ring depth, both phases
    t1: PhaseTile
    t2: PhaseTile
    iface_bytes: int  # one block's interface slice, halo included
    smem_bytes: int   # what a block asks for at launch

    def __getattr__(self, name):
        # the tiles' fields under the kernel's names: th1, ks2, ...
        if name[-1:] in "12" and name[:-1] in PhaseTile.__dataclass_fields__:
            return getattr(self.t1 if name[-1] == "1" else self.t2, name[:-1])
        raise AttributeError(name)

    @property
    def mc(self) -> int:
        return 4 * self.qpr

    @property
    def variant(self) -> tuple:
        """The compiled instance ``(R, d)`` this geometry launches."""
        return (self.r, self.d)

    def geometry_ints(self, batch: int) -> list:
        """The kernel's ``PairArgs`` for a launch at ``batch`` (without the
        copy widths and activation codes, which the wrapper appends)."""
        out = []
        for name in _GEOMETRY_FIELDS:
            v = batch if name == "batch" else getattr(self, name)
            out.extend(v if isinstance(v, tuple) else (v,))
        return out


def pair_variants() -> set:
    """Every compiled ``(R, d)`` instance of the pair kernel."""
    return {(r, d) for r in range(1, MAX_R + 1) for d in (0, 1)}


@functools.lru_cache(maxsize=None)
def pair_launch_geometry(n_in: int, n_k: int, padding: int, c0: int, c1: int,
                         c2: int) -> PairLaunch:
    """The pair kernel's partition, from the pair's shape alone.

    The interface's ``ceil(C1 / 4)`` channel quads go ``qpr`` a group to
    at most :data:`CLUSTER_MAX` groups; where that leaves blocks of the
    cluster spare, each group's padded interface rows split into
    ``n_bands`` bands of ``rpb`` (even) rows, one block each, so a narrow
    interface still spreads its plane (EB-GAN's tail pairs at reduced
    width): ``cl = groups * n_bands``. Each phase takes the tile
    (:func:`_tile_options`) whose busiest block spends the fewest issue
    slots (:func:`_stage_cost` over its tiles and ring stages; the
    consumer's work tiles go round-robin over the cluster), among those
    whose ring fits beside the interface slice.
    """
    g = pair_geometry(n_in, n_k, padding)
    r = g["R"]
    x0r, x0c = min(g["row0s1"]), min(g["col0s1"])
    b0r, b0c = min(g["row0s2"]), min(g["col0s2"])
    roff1 = tuple(v - x0r for v in g["row0s1"])
    roff2 = tuple(v - b0r for v in g["row0s2"])
    for roff, coff in ((roff1, tuple(v - x0c for v in g["col0s1"])),
                       (roff2, tuple(v - b0c for v in g["col0s2"]))):
        if roff != coff or roff not in ((0, 0), (0, 1)) or roff != roff1:
            raise ValueError(f"unexpected phase origins {g}")
    d = roff1[1]
    quads = _cdiv(c1, 4)
    qpr = _cdiv(quads, min(CLUSTER_MAX, quads))
    groups = _cdiv(quads, qpr)
    s2 = g["s2"]
    rpb = 2 * _cdiv(_cdiv(s2, CLUSTER_MAX // groups), 2)
    n_bands = _cdiv(s2, rpb)
    iface = qpr * rpb * s2 * 4
    rows1 = min(g["hp1"], rpb // 2 + 1)   # the phase rows that write a band

    def tiles(t, hp):
        return _cdiv(hp, t.th) * _cdiv(hp, t.tw)

    def cost1(t):
        per_tile = _cdiv(c0, t.ci) * _stage_cost(t, r, False) + 2 * t.ks * MICRO + 300
        return _cdiv(rows1, t.th) * _cdiv(g["hp1"], t.tw) * _cdiv(qpr, t.ncg) * per_tile

    def cost2(t):
        per_tile = _cdiv(c1, t.ci) * _stage_cost(t, r, True) + 2 * t.ks * MICRO + 300
        return _cdiv(tiles(t, g["hp2"]) * _cdiv(c2, 4 * t.ncg), groups * n_bands) * per_tile

    t1, ring1 = _choose(_tile_options(rows1, g["hp1"], r, d), cost1, iface)
    t2, ring2 = _choose(_tile_options(g["hp2"], g["hp2"], r, d), cost2, iface)
    ring = min(ring1, ring2)
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    return PairLaunch(
        n_in=n_in, n_k=n_k, c0=c0, c1=c1, c2=c2, r=r, d=d, m1=g["m1"],
        m2=g["m2"], wsels=wsels, cl=groups * n_bands, qpr=qpr, n_bands=n_bands,
        rpb=rpb, org1r=x0r - g["pad_lo1"], org1c=x0c - g["pad_lo1"], hp1=g["hp1"],
        n_w1=_cdiv(g["hp1"], t1.tw), nct1=_cdiv(qpr, t1.ncg), nst1=_cdiv(c0, t1.ci),
        s2=s2, pad_lo2=g["pad_lo2"], b0r=b0r, b0c=b0c, hp2=g["hp2"],
        n_w2=_cdiv(g["hp2"], t2.tw), n_sp2=tiles(t2, g["hp2"]),
        n_co2=_cdiv(c2, 4 * t2.ncg), nst2=_cdiv(c1, t2.ci), ring=ring,
        t1=t1, t2=t2, iface_bytes=4 * iface,
        smem_bytes=4 * (iface + max(ring * t1.stage_floats,
                                    ring * t2.stage_floats, RED_FLOATS)),
    )


def pair_smem_bytes(n_in: int, n_k: int, cin: int, mid: int, cout: int,
                    padding: int) -> int:
    """Shared memory one block of the pair kernel asks for at launch: its
    interface slice (halo included) and the larger of the two phases'
    staging. The plan pass fuses a pair iff this fits
    :data:`PAIR_SMEM_BUDGET_BYTES`."""
    return pair_launch_geometry(n_in, n_k, padding, cin, mid, cout).smem_bytes


def _check_pair(x, k1, k2, padding, epi1, bias1, epi2, bias2) -> None:
    epilib.check_bias(epi1, bias1)
    epilib.check_bias(epi2, bias2)
    if x.ndim != 4 or k1.ndim != 4 or k2.ndim != 4:
        raise ValueError("expected NHWC x and HWIO kernels")
    if x.shape[1] != x.shape[2] or k1.shape[0] != k1.shape[1]:
        raise ValueError("input and kernels must be square")
    if tuple(k2.shape[:2]) != tuple(k1.shape[:2]):
        raise ValueError(f"kernel extents differ: {tuple(k1.shape)} vs "
                         f"{tuple(k2.shape)}")
    if k1.shape[2] != x.shape[3] or k2.shape[2] != k1.shape[3]:
        raise ValueError(f"channel chain broken: x{tuple(x.shape)} "
                         f"k1{tuple(k1.shape)} k2{tuple(k2.shape)}")
    for name, bias, c in (("bias1", bias1, k1.shape[3]),
                          ("bias2", bias2, k2.shape[3])):
        if bias is not None and tuple(bias.shape) != (c,):
            raise ValueError(f"{name} must be ({c},)")
    devs = {t.device for t in (x, k1, k2, bias1, bias2) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")


def transpose_conv2d_pair_plain(x, k1, k2, padding: int = 0, *,
                                epilogue1=None, bias1=None, epilogue2=None,
                                bias2=None) -> torch.Tensor:
    """The pair's function in plain PyTorch, as the reference kernel
    computes it: the producer's four phases interleaved, its epilogue, the
    crop to ``M1`` and the consumer's zero halo, then the consumer's four
    phases, the crop to ``M2`` and the output epilogue."""
    epi1, epi2 = epilib.canonical(epilogue1), epilib.canonical(epilogue2)
    _check_pair(x, k1, k2, padding, epi1, bias1, epi2, bias2)
    n_in, n_k = x.shape[1], k1.shape[0]
    g = pair_geometry(n_in, n_k, padding)
    wsels = pair_launch_geometry(n_in, n_k, padding, x.shape[3], k1.shape[3],
                                 k2.shape[3]).wsels
    lo1, hi1 = g["pad_lo1"], g["pad_hi1"]
    xp = F.pad(x, (0, 0, lo1, hi1, lo1, hi1))
    y1 = phase_planes(xp, seg.stack_subkernels(k1), g["hp1"], g["row0s1"],
                      g["col0s1"], wsels)
    if epi1 is not None:
        y1 = epi1.apply(y1, bias1)
    lo2, hi2 = g["pad_lo2"], g["pad_hi2"]
    xi = F.pad(y1[:, : g["m1"], : g["m1"], :], (0, 0, lo2, hi2, lo2, hi2))
    y2 = phase_planes(xi, seg.stack_subkernels(k2), g["hp2"], g["row0s2"],
                      g["col0s2"], wsels)[:, : g["m2"], : g["m2"], :]
    return epi2.apply(y2, bias2) if epi2 is not None else y2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transpose_conv2d_pair")
    fn = lib.tconv_pair_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    occ = lib.tconv_pair_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib


def max_active_clusters(n_in: int, n_k: int, padding: int, c0: int, c1: int,
                        c2: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the pair kernel's instance at
    this shape: how many batch items' clusters the card runs at once."""
    g = pair_launch_geometry(n_in, n_k, padding, c0, c1, c2)
    out = ctypes.c_int(0)
    err = _lib().tconv_pair_max_active_clusters(g.r, g.d, g.cl, g.smem_bytes,
                                                ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return out.value


def transpose_conv2d_pair(x, k1, k2, padding: int = 0, *, epilogue1=None,
                          bias1=None, epilogue2=None,
                          bias2=None) -> torch.Tensor:
    """``act2(tconv(act1(tconv(x, k1) + b1), k2) + b2)`` from one launch.

    x: (B, N, N, C0) NHWC; k1: (n, n, C0, C1), k2: (n, n, C1, C2) HWIO with
    the same ``padding``. ``epilogue1``/``bias1`` is the interface epilogue,
    applied on the fp32 accumulator between the layers; ``epilogue2``/
    ``bias2`` the output epilogue. Returns (B, M2, M2, C2) float32. A CUDA
    tensor launches the kernel (or raises, also for a pair over the shared
    memory budget); a CPU tensor runs :func:`transpose_conv2d_pair_plain`.
    """
    epi1, epi2 = epilib.canonical(epilogue1), epilib.canonical(epilogue2)
    _check_pair(x, k1, k2, padding, epi1, bias1, epi2, bias2)
    if x.device.type == "cpu":
        return transpose_conv2d_pair_plain(
            x, k1, k2, padding, epilogue1=epi1, bias1=bias1, epilogue2=epi2,
            bias2=bias2,
        )
    check_cuda_operands(x, k1, k2, bias1, bias2)
    b, n_in, _, c0 = x.shape
    n_k, c1, c2 = k1.shape[0], k1.shape[3], k2.shape[3]
    g = pair_launch_geometry(n_in, n_k, padding, c0, c1, c2)
    if g.r > MAX_R:
        raise ValueError(
            f"the pair CUDA kernel takes kernels up to {2 * MAX_R}x"
            f"{2 * MAX_R}, got {n_k}x{n_k}"
        )
    if g.smem_bytes > PAIR_SMEM_BUDGET_BYTES:
        raise ValueError(
            f"pair {n_in}x{n_in}x{c0}->{c1}->{c2} needs {g.smem_bytes} B of "
            f"shared memory a block, over the {PAIR_SMEM_BUDGET_BYTES} B a "
            "block may use: run its layers apart"
        )
    x, k1, k2 = x.contiguous(), k1.contiguous(), k2.contiguous()
    bias1 = bias1.contiguous() if bias1 is not None else None
    bias2 = bias2.contiguous() if bias2 is not None else None
    # 16-byte copies need aligned rows; the copy width never changes a sum
    vx = c0 % 4 == 0 and x.data_ptr() % 16 == 0
    vw1 = c1 % 4 == 0 and k1.data_ptr() % 16 == 0
    vw2 = c2 % 4 == 0 and k2.data_ptr() % 16 == 0
    ints = g.geometry_ints(b) + [int(vx), int(vw1), int(vw2),
                                 epi1.code if epi1 else 0,
                                 epi2.code if epi2 else 0]
    geo = (ctypes.c_int * len(ints))(*ints)
    out = torch.empty((b, g.m2, g.m2, c2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _lib().tconv_pair_f32(
            x.data_ptr(), k1.data_ptr(), k2.data_ptr(),
            bias1.data_ptr() if bias1 is not None else None,
            bias2.data_ptr() if bias2 is not None else None, out.data_ptr(),
            ctypes.cast(geo, ctypes.c_void_p), len(ints), g.r, g.d,
            epi1.slope if epi1 else 0.0, epi2.slope if epi2 else 0.0,
            g.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_pair launch failed: CUDA error {err}")
    transpose_conv2d_pair.launches += 1
    return out


transpose_conv2d_pair.launches = 0
