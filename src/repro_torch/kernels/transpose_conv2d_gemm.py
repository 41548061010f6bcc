"""Implicit-GEMM transpose convolution: CUDA kernel, its wrapper and its
plain PyTorch version. Mirrors ``repro/kernels/transpose_conv2d_gemm.py``
(``transpose_conv2d_pallas_gemm`` and its ``_gemm_kernel``).

The layer is one ``(rows, n*n*Cin) x (n*n*Cin, Cout)`` GEMM whose gathered
operand is never built: tap ``(kh, kw)`` of output ``(oh, ow)`` reads input
``((oh + kh - P) / 2, (ow + kw - P) / 2)`` iff both are even and in range.
The kernel (``csrc/transpose_conv2d_gemm.cu``) orders its rows phase-major
(output parity, batch, t, u) and skips a tap that none of a block's rows
reads; :func:`gemm_geometry` gives its grid.

:func:`transpose_conv2d_gemm` launches the kernel for a CUDA tensor and
runs :func:`transpose_conv2d_gemm_plain` for a CPU tensor; it never falls
back from one to the other. ``transpose_conv2d_gemm.launches`` counts
kernel launches.
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
    check_cuda_operands,
    check_operands,
)

BLOCK_ROWS = 32   # BM of the kernel
BLOCK_COUT = 64   # BN of the kernel
THREADS = 128


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """Launch geometry of the implicit-GEMM kernel for one layer shape."""

    batch: int
    n_in: int
    n_k: int
    padding: int
    m: int       # output extent
    hp: int      # phase-plane extent ceil(M / 2)
    rows: int    # GEMM rows, phase-major: 4 * batch * hp * hp (>= batch*M*M)
    n_m: int     # row blocks
    n_co: int    # Cout blocks

    @property
    def grid(self) -> tuple:
        return (self.n_m, self.n_co)


def gemm_geometry(batch: int, n_in: int, n_k: int, padding: int, cin: int,
                  cout: int) -> GemmGeometry:
    m = seg.output_size(n_in, n_k, padding)
    hp = (m + 1) // 2
    rows = 4 * batch * hp * hp
    return GemmGeometry(
        batch=batch, n_in=n_in, n_k=n_k, padding=padding, m=m, hp=hp,
        rows=rows, n_m=-(-rows // BLOCK_ROWS), n_co=-(-cout // BLOCK_COUT),
    )


def row_decode(g: GemmGeometry, r: torch.Tensor):
    """The kernel's phase-major row order: GEMM row ``r`` -> ``(b, oh, ow,
    valid)``; rows past the output (odd M, last block) are not valid."""
    plane = g.hp * g.hp
    ph, rem = r // (g.batch * plane), r % (g.batch * plane)
    tu = rem % plane
    oh = 2 * (tu // g.hp) + ph // 2
    ow = 2 * (tu % g.hp) + ph % 2
    return rem // plane, oh, ow, (ph < 4) & (oh < g.m) & (ow < g.m)


def tap_source(g: GemmGeometry, o: torch.Tensor, k: int):
    """Input row (or col) that tap offset ``k`` of output row (or col) ``o``
    reads, and whether it reads one at all (the bed-of-nails parity test).
    Floor division is taken only on non-negative even numerators."""
    a = o + k - g.padding
    valid = (a >= 0) & (a % 2 == 0) & (a < 2 * g.n_in)
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
    g = gemm_geometry(b, n_in, n_k, padding, cin, cout)
    o = torch.arange(g.m, device=x.device)
    src, ok = zip(*(tap_source(g, o, k) for k in range(n_k)))
    src = torch.stack(src, dim=1)                     # (M, n): input index
    ok = torch.stack(ok, dim=1)
    a = x[:, src[:, :, None, None], src[None, None, :, :], :]  # (B,M,n,M,n,Cin)
    mask = (ok[:, :, None, None] & ok[None, None, :, :])[None, ..., None]
    a = torch.where(mask, a, torch.zeros_like(a))
    a = a.permute(0, 1, 3, 2, 4, 5).reshape(b * g.m * g.m, n_k * n_k * cin)
    y = (a @ kernel.reshape(n_k * n_k * cin, cout)).reshape(b, g.m, g.m, cout)
    return epi.apply(y, bias) if epi is not None else y


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transpose_conv2d_gemm")
    fn = lib.tconv_gemm_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def transpose_conv2d_gemm(x, kernel, padding: int = 0, *, epilogue=None,
                          bias=None) -> torch.Tensor:
    """``act(tconv(x, kernel) + bias)`` through the implicit-GEMM kernel.

    Same arguments and result as
    :func:`repro_torch.kernels.transpose_conv2d.transpose_conv2d_fused`.
    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
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
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, n_in, cin, cout, n_k, padding, g.m, g.hp, g.n_m, g.n_co,
            epi.code if epi else 0, epi.slope if epi else 0.0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"transpose_conv2d_gemm launch failed: CUDA error {err}")
    transpose_conv2d_gemm.launches += 1
    return out


transpose_conv2d_gemm.launches = 0
