"""Transpose convolution baselines. Mirrors the non-kernel methods of
``repro/core/transpose_conv.py``.

All methods compute the paper's operator (Algorithm 1 semantics: stride-2
bed-of-nails transpose convolution, correlation convention, symmetric
padding ``P``) on NHWC inputs ``(B, N, N, Cin)`` and HWIO kernels
``(n, n, Cin, Cout)``:

  conventional     upsample explicitly, then one dense convolution.
  xla              PyTorch's own ``conv_transpose2d`` (the reference's
                   ``lax`` transpose conv with ``lhs_dilation=2``).
  unified          the paper: four phase convolutions at exact per-phase
                   extents on the never-upsampled input.
  unified_reshape  the four phases at the rounded-up ``(Hp, Hp)`` extent,
                   interleaved by a reshape.

These are baselines a plan may pin; they call PyTorch's convolutions and are
not kernels of this package. A float32 convolution on the card goes through
cuDNN, which uses TF32 unless ``torch.backends.cudnn.allow_tf32`` is False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import segregation as seg


def _conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID correlation of NHWC ``x`` with HWIO ``k``, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _pad_hw(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return F.pad(x, (0, 0, lo, hi, lo, hi))


def upsample_bed_of_nails(x: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """(B,N,N,C) -> (B, 2N-1+2P, 2N-1+2P, C): zeros interleaved + border pad."""
    b, n, _, c = x.shape
    up = x.new_zeros((b, 2 * n - 1, 2 * n - 1, c))
    up[:, ::2, ::2, :] = x
    return _pad_hw(up, padding, padding) if padding else up


def transpose_conv_conventional(x, kernel, padding: int = 0):
    """Paper Algorithm 1: explicit upsampled buffer + one dense convolution."""
    return _conv(upsample_bed_of_nails(x, padding), kernel)


def transpose_conv_xla(x, kernel, padding: int = 0):
    """``F.conv_transpose2d`` with the flipped kernel: its padding
    ``n - 1 - P`` is this operator's ``P``. ``P > n - 1`` only adds border
    rows that see no input, so those are padded on explicitly."""
    n = kernel.shape[0]
    w = torch.flip(kernel, (0, 1)).permute(2, 3, 0, 1)  # (Cin, Cout, n, n)
    pt = n - 1 - padding
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2,
                           padding=max(pt, 0))
    y = y.permute(0, 2, 3, 1)
    return _pad_hw(y, -pt, -pt) if pt < 0 else y


def transpose_conv_unified(x, kernel, padding: int = 0):
    """This paper: the four phase convolutions at exact extents,
    scattered into the interleaved output."""
    n_k = kernel.shape[0]
    n_in = x.shape[1]
    subs = seg.segregate_kernel(kernel)
    plans, pad_lo, pad_hi = seg.plan_phases(n_in, n_k, padding)
    m = seg.output_size(n_in, n_k, padding)
    xp = _pad_hw(x, pad_lo, pad_hi)
    out = x.new_zeros((x.shape[0], m, m, kernel.shape[3]))
    for plan in plans:
        if plan.rows == 0 or plan.cols == 0:  # M = 1 leaves phases empty
            continue
        k = subs.by_parity(plan.kr, plan.kc)
        xin = xp[
            :,
            plan.row0 : plan.row0 + plan.rows + k.shape[0] - 1,
            plan.col0 : plan.col0 + plan.cols + k.shape[1] - 1,
            :,
        ]
        out[:, plan.pr :: 2, plan.pc :: 2, :] = _conv(xin, k)
    return out


def transpose_conv_unified_reshape(x, kernel, padding: int = 0):
    """Unified variant with uniform phase extents: the four ``(Hp, Hp)``
    phase outputs are stacked and interleaved by a reshape, and the
    over-computed row/col of an odd ``M`` is sliced away."""
    n_k = kernel.shape[0]
    b, n_in, _, _ = x.shape
    cout = kernel.shape[3]
    m = seg.output_size(n_in, n_k, padding)
    R = seg.ceil_half(n_k)
    Hp = (m + 1) // 2
    plans, pad_lo, _ = seg.plan_phases(n_in, n_k, padding)
    need = max(max(p.row0, p.col0) for p in plans) + Hp + R - 1
    xp = _pad_hw(x, pad_lo, max(0, need - (n_in + pad_lo)))
    stacked = seg.stack_subkernels(kernel)
    ys = []
    for plan in plans:
        xin = xp[:, plan.row0 : plan.row0 + Hp + R - 1,
                 plan.col0 : plan.col0 + Hp + R - 1, :]
        ys.append(_conv(xin, stacked[2 * plan.kr + plan.kc]))
    y = torch.stack(ys, dim=3).reshape(b, Hp, Hp, 2, 2, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * Hp, 2 * Hp, cout)
    return y[:, :m, :m, :]


METHODS = {
    "conventional": transpose_conv_conventional,
    "xla": transpose_conv_xla,
    "unified": transpose_conv_unified,
    "unified_reshape": transpose_conv_unified_reshape,
}
