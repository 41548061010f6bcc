"""Slow oracles for the transpose convolution. Mirrors ``repro/kernels/ref.py``.

* :func:`conventional_ref` -- paper Algorithm 1: bed-of-nails upsample,
  zero pad, literal sliding-window correlation.
* :func:`unified_segregated_ref` -- paper Algorithm 2: per-output-parity
  sub-kernel selection on the never-upsampled input.

NHWC inputs ``(B, N, N, Cin)`` and HWIO kernels ``(n, n, Cin, Cout)``
(2-D single-channel arrays are promoted). No convolution routine is used.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import segregation as seg


def _promote(x: torch.Tensor, kernel: torch.Tensor):
    squeeze = False
    if x.ndim == 2:
        x = x[None, :, :, None]
        squeeze = True
    if kernel.ndim == 2:
        kernel = kernel[:, :, None, None]
    if x.ndim != 4 or kernel.ndim != 4:
        raise ValueError(
            f"bad ranks: x{tuple(x.shape)} kernel{tuple(kernel.shape)}"
        )
    return x, kernel, squeeze


def bed_of_nails(x: torch.Tensor) -> torch.Tensor:
    """(B, N, N, C) -> (B, 2N-1, 2N-1, C) with x at even coordinates."""
    b, n, _, c = x.shape
    up = x.new_zeros((b, 2 * n - 1, 2 * n - 1, c))
    up[:, 0::2, 0::2, :] = x
    return up


def conventional_ref(x, kernel, padding: int = 0) -> torch.Tensor:
    """Paper Algorithm 1: upsample, pad, sliding-window correlate."""
    x, kernel, squeeze = _promote(x, kernel)
    n_kernel = kernel.shape[0]
    up = bed_of_nails(x)
    if padding:
        up = F.pad(up, (0, 0, padding, padding, padding, padding))
    m = seg.output_size(x.shape[1], n_kernel, padding)
    out = x.new_zeros((x.shape[0], m, m, kernel.shape[3]))
    for u in range(n_kernel):
        for v in range(n_kernel):
            window = up[:, u : u + m, v : v + m, :]
            out = out + torch.einsum("bhwi,io->bhwo", window, kernel[u, v])
    return out[0, :, :, 0] if squeeze else out


def unified_segregated_ref(x, kernel, padding: int = 0) -> torch.Tensor:
    """Paper Algorithm 2: runtime sub-kernel selection, exact phase extents."""
    x, kernel, squeeze = _promote(x, kernel)
    n_kernel = kernel.shape[0]
    subs = seg.segregate_kernel(kernel)
    plans, pad_lo, pad_hi = seg.plan_phases(x.shape[1], n_kernel, padding)
    xp = F.pad(x, (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
    m = seg.output_size(x.shape[1], n_kernel, padding)
    out = x.new_zeros((x.shape[0], m, m, kernel.shape[3]))
    for plan in plans:
        k = subs.by_parity(plan.kr, plan.kc)
        acc = x.new_zeros((x.shape[0], plan.rows, plan.cols, kernel.shape[3]))
        for p in range(k.shape[0]):
            for q in range(k.shape[1]):
                window = xp[
                    :,
                    plan.row0 + p : plan.row0 + p + plan.rows,
                    plan.col0 + q : plan.col0 + q + plan.cols,
                    :,
                ]
                acc = acc + torch.einsum("bhwi,io->bhwo", window, k[p, q])
        out[:, plan.pr :: 2, plan.pc :: 2, :] = acc
    return out[0, :, :, 0] if squeeze else out
