"""Segregated dilated convolution, the paper's §5 future-work direction.
Mirrors ``repro/core/dilated_conv.py``.

A dilation-2 convolution (VALID) reads

    out[x, y] = sum_{u,v} I[x + 2u, y + 2v] * K[u, v]

so every output element of parity ``(r, s) = (x % 2, y % 2)`` touches only
the input phase ``I[r::2, s::2]``: the dilated convolution is four *dense*
convolutions of the input's parity phases with the unmodified kernel,
interleaved back. NHWC inputs, HWIO kernels. Both methods call PyTorch's
convolution (cuDNN on the card); neither is a kernel of this package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, k: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """VALID correlation of NHWC ``x`` with HWIO ``k``, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def dilated_conv_conventional(x, kernel):
    """Baseline: one convolution with ``dilation=2`` (the kernel
    bed-of-nails). An input too small for the dilated kernel gives the empty
    ``(B, 0, 0, Cout)`` output, as the reference's ``lax`` convolution does."""
    if x.shape[1] - 2 * (kernel.shape[0] - 1) <= 0:
        return x.new_zeros((x.shape[0], 0, 0, kernel.shape[3]),
                           dtype=torch.promote_types(x.dtype, kernel.dtype))
    return _conv(x, kernel, dilation=2)


def dilated_conv_segregated(x, kernel):
    """Input-phase segregated dilated conv (dilation 2, VALID)."""
    n = kernel.shape[0]
    b, N, _, _ = x.shape
    m = N - 2 * (n - 1)  # VALID output extent with dilation 2
    if m <= 0:
        raise ValueError(f"input {N} too small for kernel {n} with dilation 2")
    out = x.new_zeros((b, m, m, kernel.shape[3]))
    for r in (0, 1):
        for s in (0, 1):
            rows = (m - r + 1) // 2
            cols = (m - s + 1) // 2
            if rows <= 0 or cols <= 0:
                continue
            ph = x[:, r::2, s::2, :][:, : rows + n - 1, : cols + n - 1, :]
            out[:, r::2, s::2, :] = _conv(ph, kernel)[:, :rows, :cols, :]
    return out


METHODS = {
    "conventional": dilated_conv_conventional,
    "segregated": dilated_conv_segregated,
}


def dilated_conv2d(x, kernel, *, method: str = "segregated") -> torch.Tensor:
    """Dilation-2 VALID convolution of NHWC ``x`` with HWIO ``kernel`` by
    ``method`` (a name in :data:`METHODS`)."""
    fn = METHODS.get(method)
    if fn is None:
        raise ValueError(f"unknown method {method!r}; one of {sorted(METHODS)}")
    return fn(x, kernel)
