"""Layer-pair transpose convolution: two stacked stride-2 layers from one
CUDA launch, the interface between them kept on chip. Mirrors
``repro/kernels/transpose_conv2d_pair.py`` (``transpose_conv2d_pair_pallas``
and its ``_pair_kernel``).

The TPU kernel holds the producer's whole output plane as a VMEM scratch
slab and sums over ``cin`` and ``mid`` in sequential grid steps. On Hopper a
block has at most 227 KB of shared memory and blocks run in no order, so
the kernel (``csrc/transpose_conv2d_pair.cu``) runs one thread-block
cluster of up to 8 blocks per batch item instead: each block computes a
slice of the interface channels over the whole plane into its own shared
memory, and after a cluster barrier every block reads all slices through
distributed shared memory to compute its share of the output.
:func:`pair_launch_geometry` is that partition; :func:`pair_smem_bytes` is
the shared memory a block of it asks for at launch, which the plan pass
budgets against :data:`PAIR_SMEM_BUDGET_BYTES`.

:func:`transpose_conv2d_pair` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_pair_plain` for a CPU tensor; it never falls
back from one to the other, and raises for a pair whose blocks would need
more shared memory than a block may have. ``transpose_conv2d_pair.launches``
counts kernel launches.
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
CLUSTER_MAX = 8      # the portable thread-block cluster size
CIN_CHUNK = 16       # kCinChunk of the kernel


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
    "batch", "n_in", "c0", "c1", "c2", "n_k", "m1", "m2", "cl", "mc",
    "wsels", "pad_lo1", "x0r", "x0c", "roff1", "coff1", "hp1", "th1", "tw1",
    "n_w1", "n_sp1", "xh1", "xw1", "ncg1", "nct1", "s2", "pad_lo2", "b0r",
    "b0c", "roff2", "coff2", "hp2", "th2", "tw2", "n_w2", "n_sp2", "xh2", "xw2", "ncg2", "n_co2",
)


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
    m1: int
    m2: int
    wsels: tuple      # output parity -> stacked sub-kernel, both layers
    cl: int           # blocks in a batch item's cluster
    mc: int           # interface channels a block owns
    # producer: the (hp1, hp1) phase plane in (th1, tw1) tiles, every
    # block over all of them for its own channels
    pad_lo1: int
    x0r: int
    x0c: int
    roff1: tuple
    coff1: tuple
    hp1: int
    th1: int
    tw1: int
    n_w1: int
    n_sp1: int        # phase-plane tiles
    xh1: int          # staged input window of a tile
    xw1: int
    ncg1: int         # channel groups of four in a producer tile
    ppt1: int         # positions a thread (1 or 2)
    nct1: int         # channel tiles of a block's mc channels
    # interface [mc][s2][s2] with the consumer's zero halo, and consumer
    s2: int
    pad_lo2: int
    b0r: int
    b0c: int
    roff2: tuple
    coff2: tuple
    hp2: int
    th2: int
    tw2: int
    n_w2: int
    n_sp2: int        # phase-plane tiles
    xh2: int
    xw2: int
    ncg2: int
    ppt2: int
    n_co2: int        # C2 tiles; work tiles n_sp2 * n_co2 go round-robin
    iface_bytes: int  # one block's interface slice, halo included
    smem_bytes: int   # what a block asks for at launch

    def geometry_ints(self, batch: int) -> list:
        """The kernel's ``PairArgs`` for a launch at ``batch`` (without the
        two activation codes, which the wrapper appends)."""
        out = []
        for name in _GEOMETRY_FIELDS:
            v = batch if name == "batch" else getattr(self, name)
            out.extend(v if isinstance(v, tuple) else (v,))
        return out


def _floats4(n: int) -> int:
    return _cdiv(n, 4) * 4


def _stage_floats(xh: int, xw: int, r: int, ct: int) -> int:
    """A staged 16-channel window and the (4, R, R, 16, ct) weight chunk."""
    return _floats4(CIN_CHUNK * xh * xw) + 4 * r * r * CIN_CHUNK * ct


def _tiles(hp: int, roffs, coffs, r: int):
    """Each tile shape a 256-thread block may take over an ``(hp, hp)``
    phase plane, in the order ties are broken (wider channel tiles first,
    then two positions a thread): ``(ncg, ppt, tiling, floats)`` with the
    spatial tiling and the floats of staging it needs."""
    out = []
    for ncg in (16, 8, 4, 2, 1):
        for ppt in (2, 1):
            tp = ppt * THREADS // ncg
            tw = min(hp, tp)
            th = min(hp, tp // tw)
            n_w = _cdiv(hp, tw)
            xh, xw = th + max(roffs) + r - 1, tw + max(coffs) + r - 1
            out.append((ncg, ppt, dict(th=th, tw=tw, n_w=n_w,
                                       n_sp=_cdiv(hp, th) * n_w, xh=xh, xw=xw),
                        _stage_floats(xh, xw, r, 4 * ncg)))
    return out


@functools.lru_cache(maxsize=None)
def pair_launch_geometry(n_in: int, n_k: int, padding: int, c0: int, c1: int,
                         c2: int) -> PairLaunch:
    """The pair kernel's partition.

    The cluster has ``cl = ceil(C1 / mc)`` blocks with ``mc = ceil(C1 /
    min(8, C1))`` interface channels each. A thread computes four parities
    x ``ppt`` positions x four channels; a 256-thread tile therefore covers
    ``ppt * 256 / ncg`` phase-plane positions (``th`` rows of ``tw``) of
    ``4 * ncg`` channels, and stages the input window those rows read. Each
    phase takes the tile shape whose busiest block runs the fewest tiles,
    weighed by the work of a tile (shared-memory loads and FMAs: one float4
    and ``ppt`` scalar loads per ``4 * ppt`` FMAs gives ``1 + 2 ppt``), among
    the shapes whose staging fits beside the interface slice; if none fits
    it takes the smallest staging, and the pair is over budget.
    """
    g = pair_geometry(n_in, n_k, padding)
    r = g["R"]
    mc = _cdiv(c1, min(CLUSTER_MAX, c1))
    cl = _cdiv(c1, mc)
    s2 = g["s2"]
    iface = _floats4(mc * s2 * s2)
    room = PAIR_SMEM_BUDGET_BYTES // 4 - iface

    x0r, x0c = min(g["row0s1"]), min(g["col0s1"])
    roff1 = tuple(v - x0r for v in g["row0s1"])
    coff1 = tuple(v - x0c for v in g["col0s1"])
    producer = []
    for ncg, ppt, t, floats in _tiles(g["hp1"], roff1, coff1, r):
        nct = _cdiv(mc, 4 * ncg)
        cost = t["n_sp"] * nct * (1 + 2 * ppt)
        producer.append(((floats > room, cost, floats), dict(
            ncg1=ncg, ppt1=ppt, nct1=nct, **{k + "1": v for k, v in t.items()}
        ), floats))

    b0r, b0c = min(g["row0s2"]), min(g["col0s2"])
    roff2 = tuple(v - b0r for v in g["row0s2"])
    coff2 = tuple(v - b0c for v in g["col0s2"])
    consumer = []
    for ncg, ppt, t, floats in _tiles(g["hp2"], roff2, coff2, r):
        n_co = _cdiv(c2, 4 * ncg)
        cost = _cdiv(t["n_sp"] * n_co, cl) * (1 + 2 * ppt)
        consumer.append(((floats > room, cost, floats), dict(
            ncg2=ncg, ppt2=ppt, n_co2=n_co, **{k + "2": v for k, v in t.items()}
        ), floats))
    # min() keeps the first of equal keys: the _options() order breaks ties
    _, prod, prod_floats = min(producer, key=lambda o: o[0])
    _, cons, cons_floats = min(consumer, key=lambda o: o[0])
    wsels = tuple(
        2 * seg.phase_params(pr, padding) + seg.phase_params(pc, padding)
        for pr in range(2) for pc in range(2)
    )
    return PairLaunch(
        n_in=n_in, n_k=n_k, c0=c0, c1=c1, c2=c2, r=r, m1=g["m1"], m2=g["m2"],
        wsels=wsels, cl=cl, mc=mc, pad_lo1=g["pad_lo1"], x0r=x0r, x0c=x0c,
        roff1=roff1, coff1=coff1, hp1=g["hp1"], **prod,
        s2=s2, pad_lo2=g["pad_lo2"], b0r=b0r, b0c=b0c, roff2=roff2,
        coff2=coff2, hp2=g["hp2"], **cons, iface_bytes=4 * iface,
        smem_bytes=4 * (iface + max(prod_floats, cons_floats)),
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
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


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
    ints = g.geometry_ints(b) + [epi1.code if epi1 else 0,
                                 epi2.code if epi2 else 0]
    geo = (ctypes.c_int * len(ints))(*ints)
    out = torch.empty((b, g.m2, g.m2, c2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), k1.data_ptr(), k2.data_ptr(),
            bias1.data_ptr() if bias1 is not None else None,
            bias2.data_ptr() if bias2 is not None else None, out.data_ptr(),
            ctypes.cast(geo, ctypes.c_void_p), len(ints), g.r, g.ppt1,
            g.ppt2, epi1.slope if epi1 else 0.0, epi2.slope if epi2 else 0.0,
            g.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_pair launch failed: CUDA error {err}")
    transpose_conv2d_pair.launches += 1
    return out


transpose_conv2d_pair.launches = 0
