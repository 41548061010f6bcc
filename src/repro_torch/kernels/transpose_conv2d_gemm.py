"""Implicit-GEMM transpose convolution: CUDA kernel, its wrapper and its
plain PyTorch version. Mirrors ``repro/kernels/transpose_conv2d_gemm.py``
(``transpose_conv2d_pallas_gemm`` and its ``_gemm_kernel``).

The plain version computes the layer as one ``(rows, n*n*Cin) x
(n*n*Cin, Cout)`` GEMM whose gathered operand is built with the tap
predicate: tap ``(kh, kw)`` of output ``(oh, ow)`` reads input ``((oh + kh
- P) / 2, (ow + kw - P) / 2)`` iff both are even and in range. The kernel
(``csrc/transpose_conv2d_gemm.cu``) computes the same function in the
segregated form, one implicit GEMM per output parity: rows are that
parity's phase-plane positions ``(b, t, u)`` with the batch folded in, the
contraction runs over its ``R x R`` sub-kernel taps x Cin in 16-channel
steps, split across blocks by a count fixed by the layer's shape (never
the batch), and a second pass adds the splits in order.
:func:`gemm_geometry` computes everything the kernel needs to know.

:func:`transpose_conv2d_gemm` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_gemm_plain` for a CPU tensor; it never falls
back from one to the other. ``transpose_conv2d_gemm.launches`` counts
kernel launches, ``.reduce_launches`` the split passes; a CUDA graph's
replay adds the launches it captured (:mod:`repro_torch.graphs`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import segregation as seg
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels.transpose_conv2d import (
    H100_SMS,
    check_cuda_operands,
    check_operands,
)
from repro_torch.kernels.transpose_conv2d_bwd import phase_origins, wsels

# The kernel's constants (BM, BN, BK, KS, NT, STAGES and AP of its source).
BLOCK_ROWS = 32      # phase-plane positions of one parity a block, batch folded in
BLOCK_COUT = 128     # output channels a block
STEP_CIN = 16        # input channels a contraction step (one tap)
SLICES = 2           # warp slices of each step, added in slice order
THREADS = 128        # SLICES x 4 row groups x 16 channel groups, 8 x 8 a thread
STAGES = 3           # depth of the cp.async ring
ROW_PITCH = STEP_CIN + 4   # floats of a staged input row
# Split the contraction until the layer's grid at batch 1 holds this many
# blocks (two an SM), keeping at least MIN_SPLIT_STEPS steps a split.
MIN_BLOCKS = 2 * H100_SMS
MIN_SPLIT_STEPS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes() -> int:
    """The larger of the ring, STAGES x (input rows [BM][pitch] + weight
    rows [BK][BN]) floats, and the slices' tiles after the loop, [KS][BM][BN]."""
    ring = STAGES * (BLOCK_ROWS * ROW_PITCH + STEP_CIN * BLOCK_COUT)
    return 4 * max(ring, SLICES * BLOCK_ROWS * BLOCK_COUT)


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """Launch geometry of the implicit-GEMM kernel for one layer shape.
    Only ``batch`` (through ``rows`` and ``n_m``, the grid's first axis)
    depends on the batch."""

    batch: int
    m: int            # output extent 2N - n + 2P
    hp: int           # phase-plane extent ceil(M / 2)
    r: int            # stacked sub-kernel extent ceil(n / 2)
    pad_lo: int       # floor(P / 2): zero rows before the input
    row0s: tuple      # padded-input origin of each output row parity
    col0s: tuple
    wsels: tuple      # output parity 2*pr+pc -> stacked sub-kernel index
    rows: int         # GEMM rows of one parity: batch * hp * hp
    n_m: int          # row blocks
    n_co: int         # Cout blocks
    cpt: int          # contraction steps a tap: ceil(Cin / STEP_CIN)
    n_steps: int      # R * R * cpt
    splits: int       # contraction splits across blocks (1: no second pass)
    vx: bool          # 16-byte input copies (Cin a multiple of 4)
    vw: bool          # 16-byte weight copies and stores (Cout a multiple of 4)
    smem_bytes: int

    @property
    def grid(self) -> tuple:
        """``(row blocks, splits * Cout blocks, 4 output parities)``."""
        return (self.n_m, self.splits * self.n_co, 4)

    @property
    def summation_order(self) -> tuple:
        """The fields that fix the order of every output's sum: split,
        step (a tap's STEP_CIN channels), warp slice, channel."""
        return (SLICES, STEP_CIN, self.r, self.cpt, self.n_steps, self.splits)

    def split_steps(self, split: int) -> range:
        """The contraction steps split ``split`` sums, as the kernel
        partitions them."""
        lo = split * self.n_steps // self.splits
        return range(lo, (split + 1) * self.n_steps // self.splits)

    def origins(self) -> tuple:
        """The input row and column of plane position 0 at tap 0, per row
        parity and per column parity (the launcher's org_r, org_c)."""
        return (tuple(v - self.pad_lo for v in self.row0s),
                tuple(v - self.pad_lo for v in self.col0s))


def gemm_splits(hp: int, r: int, cin: int, cout: int) -> int:
    """The contraction's split count, from the layer's shape alone: enough
    that the grid at batch 1 reaches MIN_BLOCKS blocks, while each split
    keeps MIN_SPLIT_STEPS steps."""
    blocks_b1 = _cdiv(hp * hp, BLOCK_ROWS) * _cdiv(cout, BLOCK_COUT) * 4
    n_steps = r * r * _cdiv(cin, STEP_CIN)
    return max(1, min(_cdiv(MIN_BLOCKS, blocks_b1), n_steps // MIN_SPLIT_STEPS))


@functools.lru_cache(maxsize=None)
def gemm_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                  cout: int) -> GemmGeometry:
    """The implicit-GEMM kernel's launch geometry (DCGAN L0, 4x4x1024 ->
    512: 17 splits, so 272 blocks at batch 1)."""
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    r = seg.ceil_half(n_k)
    row0s, col0s, pad_lo = phase_origins(n_in, n_k, padding)
    rows = batch * hp * hp
    cpt = _cdiv(cin, STEP_CIN)
    return GemmGeometry(
        batch=batch, m=m, hp=hp, r=r, pad_lo=pad_lo, row0s=row0s, col0s=col0s,
        wsels=wsels(padding), rows=rows, n_m=_cdiv(rows, BLOCK_ROWS),
        n_co=_cdiv(cout, BLOCK_COUT), cpt=cpt, n_steps=r * r * cpt,
        splits=gemm_splits(hp, r, cin, cout), vx=cin % 4 == 0, vw=cout % 4 == 0,
        smem_bytes=_smem_bytes(),
    )


def tap_source(n_in: int, padding: int, o: torch.Tensor, k: int):
    """Input row (or col) that tap offset ``k`` of output row (or col) ``o``
    reads, and whether it reads one at all (the bed-of-nails parity test).
    Floor division is taken only on non-negative even numerators."""
    a = o + k - padding
    valid = (a >= 0) & (a % 2 == 0) & (a < 2 * n_in)
    return torch.where(valid, a, torch.zeros_like(a)) // 2, valid


def transpose_conv2d_gemm_plain(x, kernel, padding: int = 0, *,
                                epilogue=None, bias=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the dense gathered operand
    ``(B*M*M, n*n*Cin)`` built with the tap predicate, one matmul with the
    ``(n*n*Cin, Cout)`` kernel, then the epilogue."""
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    m = seg.output_size(n_in, n_k, padding)
    o = torch.arange(m, device=x.device)
    src, ok = zip(*(tap_source(n_in, padding, o, k) for k in range(n_k)))
    src = torch.stack(src, dim=1)                     # (M, n): input index
    ok = torch.stack(ok, dim=1)
    a = x[:, src[:, :, None, None], src[None, None, :, :], :]  # (B,M,n,M,n,Cin)
    mask = (ok[:, :, None, None] & ok[None, None, :, :])[None, ..., None]
    a = torch.where(mask, a, torch.zeros_like(a))
    a = a.permute(0, 1, 3, 2, 4, 5).reshape(b * m * m, n_k * n_k * cin)
    y = (a @ kernel.reshape(n_k * n_k * cin, cout)).reshape(b, m, m, cout)
    return epi.apply(y, bias) if epi is not None else y


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transpose_conv2d_gemm")
    fn = lib.tconv_gemm_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 26
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def transpose_conv2d_gemm(x, kernel, padding: int = 0, *, epilogue=None,
                          bias=None) -> torch.Tensor:
    """``act(tconv(x, kernel) + bias)`` through the implicit-GEMM kernel.

    Same arguments and result as
    :func:`repro_torch.kernels.transpose_conv2d.transpose_conv2d_fused`.
    A CUDA tensor launches the kernel (and, for a split contraction, the
    reduce pass) or raises; a CPU tensor runs
    :func:`transpose_conv2d_gemm_plain`.
    """
    epi = epilib.canonical(epilogue)
    epilib.check_bias(epi, bias)
    check_operands(x, kernel, bias)
    if x.device.type == "cpu":
        return transpose_conv2d_gemm_plain(
            x, kernel, padding, epilogue=epi, bias=bias
        )
    check_cuda_operands(x, kernel, bias)
    b, n_in, _, cin = x.shape
    n_k, cout = kernel.shape[0], kernel.shape[3]
    g = gemm_geometry(b, n_in, n_k, padding, cin, cout)
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
        err = _lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, n_in, cin, cout, n_k, g.m, g.r, *org_r, *org_c, *g.wsels,
            BLOCK_ROWS, BLOCK_COUT, STEP_CIN, g.n_m, g.n_co, g.splits, g.cpt,
            g.n_steps, int(vx), int(vw), epi.code if epi else 0,
            epi.slope if epi else 0.0, g.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_gemm launch failed: CUDA error {err}")
    transpose_conv2d_gemm.launches += 1
    if g.splits > 1:
        transpose_conv2d_gemm.reduce_launches += 1
    return out


transpose_conv2d_gemm.launches = 0
transpose_conv2d_gemm.reduce_launches = 0
