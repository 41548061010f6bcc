"""Kernel segregation algebra (paper §3.1-3.2). Mirrors ``repro/core/segregation.py``.

A stride-2 transpose convolution over an ``N x N`` input is the interleave of
four small dense convolutions ("phases") applied to the never-upsampled
input. The four sub-kernels are every other row/column of the ``n x n``
kernel ``K`` starting at parity ``(r, s)``::

    k00 = K[0::2, 0::2]   k01 = K[0::2, 1::2]
    k10 = K[1::2, 0::2]   k11 = K[1::2, 1::2]

Output element ``out[x, y]`` (``M = 2N - n + 2P``) is produced by sub-kernel
``k_{r,s}`` with ``r = (x + P) % 2``, ``s = (y + P) % 2`` -- including the
odd-padding sub-kernel swap (paper §3.4).

Shape algebra in plain Python plus three tensor ops on torch tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SubKernels(NamedTuple):
    """The four segregated sub-kernels, in the source kernel's layout:
    ``(R, C)`` for 2-D kernels, ``(R, C, Cin, Cout)`` (HWIO) for 4-D ones."""

    k00: torch.Tensor
    k01: torch.Tensor
    k10: torch.Tensor
    k11: torch.Tensor

    def by_parity(self, r: int, s: int) -> torch.Tensor:
        return (self.k00, self.k01, self.k10, self.k11)[2 * r + s]


def segregate_kernel(kernel: torch.Tensor) -> SubKernels:
    """Split an ``n x n`` (leading two dims) kernel into four sub-kernels."""
    if kernel.ndim < 2:
        raise ValueError(f"kernel must have >=2 dims, got {tuple(kernel.shape)}")
    return SubKernels(
        k00=kernel[0::2, 0::2],
        k01=kernel[0::2, 1::2],
        k10=kernel[1::2, 0::2],
        k11=kernel[1::2, 1::2],
    )


def merge_subkernels(subs: SubKernels, n: int) -> torch.Tensor:
    """Inverse of :func:`segregate_kernel`."""
    trailing = tuple(subs.k00.shape[2:])
    out = subs.k00.new_zeros((n, n) + trailing)
    out[0::2, 0::2] = subs.k00
    out[0::2, 1::2] = subs.k01
    out[1::2, 0::2] = subs.k10
    out[1::2, 1::2] = subs.k11
    return out


def stack_subkernels(kernel: torch.Tensor) -> torch.Tensor:
    """Zero-pad the four sub-kernels on the high side to ``R = ceil(n/2)``
    and stack them: ``(4, R, R, ...)``. For even ``n`` no zeros are added."""
    n = kernel.shape[0]
    R = ceil_half(n)
    padded = []
    for k in segregate_kernel(kernel):
        z = kernel.new_zeros((R, R) + tuple(kernel.shape[2:]))
        z[: k.shape[0], : k.shape[1]] = k
        padded.append(z)
    return torch.stack(padded)


def ceil_half(n: int) -> int:
    return (n + 1) // 2


def floor_half(n: int) -> int:
    return n // 2


def subkernel_shape(n: int, r: int, s: int) -> tuple[int, int]:
    """Spatial shape of sub-kernel ``k_{r,s}`` for an ``n x n`` kernel."""
    rows = ceil_half(n) if r == 0 else floor_half(n)
    cols = ceil_half(n) if s == 0 else floor_half(n)
    return rows, cols


def output_size(n_in: int, n_kernel: int, padding: int = 0) -> int:
    """Output extent of the paper's transpose convolution: ``2N - n + 2P``."""
    m = 2 * n_in - n_kernel + 2 * padding
    if m <= 0:
        raise ValueError(
            f"non-positive output size {m} for N={n_in}, n={n_kernel}, P={padding}"
        )
    return m


def phase_extent(m_out: int, parity: int) -> int:
    """Number of output rows (or cols) owned by parity ``parity`` in [0, 2)."""
    return (m_out - parity + 1) // 2


def phase_params(x_parity: int, padding: int) -> int:
    """Sub-kernel parity used for output parity ``x_parity``:
    ``(x + P) mod 2`` (odd padding swaps the roles, paper §3.4)."""
    return (x_parity + padding) % 2


class PhasePlan(NamedTuple):
    """Static slicing plan for one phase::

      out[pr::2, pc::2][t, u] =
          sum_{p,q} Ipad[row0 + t + p, col0 + u + q] * k[kr, kc][p, q]

    where ``Ipad`` is the input zero-padded by ``pad_lo``/``pad_hi``.
    """

    pr: int
    pc: int
    kr: int
    kc: int
    rows: int
    cols: int
    row0: int
    col0: int


def plan_phases(
    n_in: int, n_kernel: int, padding: int = 0
) -> tuple[list[PhasePlan], int, int]:
    """The four phase plans plus the (lo, hi) zero padding of the input.

    Phase ``(pr, pc)`` reads input row ``i = p + t + ceil((pr - P) / 2)``;
    the negative constant offset for ``P > 0`` is absorbed into ``pad_lo``.
    """
    m = output_size(n_in, n_kernel, padding)
    pad_lo = -math.ceil((0 - padding) / 2)  # = floor(P/2)
    plans = []
    max_hi = 0
    for pr in (0, 1):
        for pc in (0, 1):
            kr = phase_params(pr, padding)
            kc = phase_params(pc, padding)
            R, C = subkernel_shape(n_kernel, kr, kc)
            rows = phase_extent(m, pr)
            cols = phase_extent(m, pc)
            row0 = math.ceil((pr - padding) / 2) + pad_lo
            col0 = math.ceil((pc - padding) / 2) + pad_lo
            hi_r = row0 + (rows - 1) + (R - 1)
            hi_c = col0 + (cols - 1) + (C - 1)
            max_hi = max(max_hi, hi_r, hi_c)
            plans.append(PhasePlan(pr, pc, kr, kc, rows, cols, row0, col0))
    pad_hi = max(0, max_hi - (n_in + pad_lo - 1))
    return plans, pad_lo, pad_hi


def flop_count(
    n_in: int, n_kernel: int, cin: int, cout: int, padding: int = 0,
    *, method: str = "segregated",
) -> int:
    """Multiply count per image: ``conventional`` does ``n*n*cin`` MACs per
    output element over the upsampled map, ``segregated`` ``|k_{r,s}|*cin``."""
    m = output_size(n_in, n_kernel, padding)
    if method == "conventional":
        return m * m * n_kernel * n_kernel * cin * cout
    total = 0
    for pr in (0, 1):
        for pc in (0, 1):
            kr = phase_params(pr, padding)
            kc = phase_params(pc, padding)
            R, C = subkernel_shape(n_kernel, kr, kc)
            total += phase_extent(m, pr) * phase_extent(m, pc) * R * C * cin * cout
    return total


def memory_savings_bytes(
    n_in: int, cin: int, dtype_bytes: int = 4, padding: int = 0,
    n_kernel: int = 0, *, mode: str = "diff",
) -> int:
    """Bytes saved by never materializing the upsampled map.

    ``mode="diff"``: the ``(2N-1+2P)^2`` buffer minus the padded input
    (paper Tables 2-3). ``mode="buffer"``: the whole buffer (paper Table 4).
    """
    up = 2 * n_in - 1 + 2 * padding
    if mode == "buffer":
        return up * up * cin * dtype_bytes
    seg = n_in + 2 * (padding // 2)
    return (up * up - seg * seg) * cin * dtype_bytes
