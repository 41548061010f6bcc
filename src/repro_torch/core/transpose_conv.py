"""Transpose convolution: the paper's operator zoo and its public entry
:func:`transpose_conv2d`. Mirrors ``repro/core/transpose_conv.py``.

All methods compute the paper's operator (Algorithm 1 semantics: stride-2
bed-of-nails transpose convolution, correlation convention, symmetric
padding ``P``) on NHWC inputs ``(B, N, N, Cin)`` and HWIO kernels
``(n, n, Cin, Cout)``:

  conventional     upsample explicitly, then one dense convolution.
  xla              PyTorch's own ``conv_transpose2d`` (the reference's
                   ``lax`` transpose conv with ``lhs_dilation=2``).
  grouped          the authors' HICSS'23 prior work: the four phase
                   convolutions at the rounded-up even extent, then cropped.
  unified          the paper: four phase convolutions at exact per-phase
                   extents on the never-upsampled input.
  unified_reshape  the four phases at the rounded-up ``(Hp, Hp)`` extent,
                   interleaved by a reshape.
  unified_fused    the four shifted views stacked channel-wise, one grouped
                   convolution (``groups=4``), the reshape interleave.
  unified_matmul   the four phases im2col'd, one batched matmul.
  auto             a single-layer plan (:mod:`repro_torch.kernels.plan`)
                   from the autotune cache, or by the cold rule on a miss:
                   the hand-written CUDA kernels.

The entry also takes the reference's Pallas spellings, which run the port's
hand-written kernels through a plan (:data:`KERNEL_METHODS`).

The methods but ``auto`` are baselines a plan may pin: the reference
computes them with ``lax`` outside any Pallas kernel, so here they call
PyTorch's convolutions and ``torch.bmm`` (cuDNN and cuBLAS on the card) and
are not kernels of this package. A float32 convolution on the card uses TF32
unless ``torch.backends.cudnn.allow_tf32`` is False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import segregation as seg
from repro_torch.kernels import epilogue as epilib


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


def _empty(x, kernel):
    """The ``(B, 0, 0, Cout)`` output of a non-positive output extent, which
    the reference's ``lax`` convolutions return where PyTorch's raise."""
    return x.new_zeros((x.shape[0], 0, 0, kernel.shape[3]),
                       dtype=torch.promote_types(x.dtype, kernel.dtype))


def transpose_conv_conventional(x, kernel, padding: int = 0):
    """Paper Algorithm 1: explicit upsampled buffer + one dense convolution.
    A non-positive output extent gives the empty ``(B, 0, 0, Cout)`` output."""
    if 2 * x.shape[1] - kernel.shape[0] + 2 * padding <= 0:
        return _empty(x, kernel)
    return _conv(upsample_bed_of_nails(x, padding), kernel)


def transpose_conv_xla(x, kernel, padding: int = 0):
    """``F.conv_transpose2d`` with the flipped kernel: its padding
    ``n - 1 - P`` is this operator's ``P``. ``P > n - 1`` only adds border
    rows that see no input, so those are padded on explicitly. A non-positive
    output extent gives the empty ``(B, 0, 0, Cout)`` output."""
    n = kernel.shape[0]
    if 2 * x.shape[1] - n + 2 * padding <= 0:
        return _empty(x, kernel)
    w = torch.flip(kernel, (0, 1)).permute(2, 3, 0, 1)  # (Cin, Cout, n, n)
    pt = n - 1 - padding
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2,
                           padding=max(pt, 0))
    y = y.permute(0, 2, 3, 1)
    return _pad_hw(y, -pt, -pt) if pt < 0 else y


def _phase_convs(x, kernel, padding: int, *, exact: bool):
    """The four segregated phase convolutions, scattered into the
    interleaved output: at exact per-phase extents (``exact=True``, the
    unified variant) or at the rounded-up even extent, cropped (the grouped
    variant)."""
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
        rows, cols = plan.rows, plan.cols
        if not exact:  # grouped: compute the rounded-up extent, crop later
            rows = seg.phase_extent(m + 1, 0) if plan.pr else rows
            cols = seg.phase_extent(m + 1, 0) if plan.pc else cols
            rows = min(rows, xp.shape[1] - plan.row0 - k.shape[0] + 1)
            cols = min(cols, xp.shape[2] - plan.col0 - k.shape[1] + 1)
        xin = xp[
            :,
            plan.row0 : plan.row0 + rows + k.shape[0] - 1,
            plan.col0 : plan.col0 + cols + k.shape[1] - 1,
            :,
        ]
        out[:, plan.pr :: 2, plan.pc :: 2, :] = (
            _conv(xin, k)[:, : plan.rows, : plan.cols, :])
    return out


def transpose_conv_unified(x, kernel, padding: int = 0):
    """This paper: the four phase convolutions at exact extents,
    scattered into the interleaved output."""
    return _phase_convs(x, kernel, padding, exact=True)


def transpose_conv_grouped(x, kernel, padding: int = 0):
    """Prior work (HICSS'23): grouped segregation with extra-element
    overshoot."""
    return _phase_convs(x, kernel, padding, exact=False)


def _uniform_views(x, kernel, padding: int):
    """The four phase views of the padded input at the uniform ``(Hp, Hp)``
    extent, each beside its ``(R, R)`` sub-kernel (zero-padded), in output
    parity order ``(0,0), (0,1), (1,0), (1,1)``; and ``M``, ``Hp``, ``R``."""
    n_k = kernel.shape[0]
    n_in = x.shape[1]
    m = seg.output_size(n_in, n_k, padding)
    R = seg.ceil_half(n_k)
    Hp = (m + 1) // 2
    plans, pad_lo, _ = seg.plan_phases(n_in, n_k, padding)
    need = max(max(p.row0, p.col0) for p in plans) + Hp + R - 1
    xp = _pad_hw(x, pad_lo, max(0, need - (n_in + pad_lo)))
    stacked = seg.stack_subkernels(kernel)
    views = [(xp[:, plan.row0 : plan.row0 + Hp + R - 1,
                 plan.col0 : plan.col0 + Hp + R - 1, :],
              stacked[2 * plan.kr + plan.kc]) for plan in plans]
    return views, m, Hp, R


def _interleave(y: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, Hp, Hp, 4 * Cout)`` phase planes in parity order -> the
    ``(B, M, M, Cout)`` output, by the contiguous ``(B, Hp, 2, Hp, 2, C)``
    reshape."""
    b, hp = y.shape[0], y.shape[1]
    y = y.reshape(b, hp, hp, 2, 2, -1).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * hp, 2 * hp, -1)[:, :m, :m, :]


def transpose_conv_unified_reshape(x, kernel, padding: int = 0):
    """Unified variant with uniform phase extents: the four ``(Hp, Hp)``
    phase outputs are stacked and interleaved by a reshape, and the
    over-computed row/col of an odd ``M`` is sliced away."""
    views, m, _, _ = _uniform_views(x, kernel, padding)
    return _interleave(torch.cat([_conv(v, k) for v, k in views], dim=3), m)


def transpose_conv_unified_fused(x, kernel, padding: int = 0):
    """All four phase convolutions as ONE grouped convolution: the four
    shifted views stacked channel-wise, the four (common-shape-padded)
    sub-kernels as its groups (``groups=4``), the reshape interleave. For
    odd kernels the zero-padded taps add ``ceil(n/2)^2 * 4 / n^2 - 1``
    extra MACs in exchange for the single call."""
    views, m, _, _ = _uniform_views(x, kernel, padding)
    x4 = torch.cat([v for v, _ in views], dim=3)   # (B, Hp+R-1, ., 4 Cin)
    w4 = torch.cat([k.permute(3, 2, 0, 1) for _, k in views])  # (4 Cout, Cin, R, R)
    y = F.conv2d(x4.permute(0, 3, 1, 2), w4, groups=4)
    return _interleave(y.permute(0, 2, 3, 1), m)


def transpose_conv_unified_matmul(x, kernel, padding: int = 0):
    """The four phase convolutions as ONE batched matmul: each phase view
    im2col'd (``R * R`` taps on the last axis), the phases stacked on the
    batch axis, ``(4, B Hp Hp, R R Cin) @ (4, R R Cin, Cout)``, then the
    reshape interleave (paper §5's matrix-multiplication formulation)."""
    views, m, Hp, R = _uniform_views(x, kernel, padding)
    b, cin, cout = x.shape[0], x.shape[3], kernel.shape[3]
    cols = torch.stack([
        torch.cat([v[:, p : p + Hp, q : q + Hp, :]
                   for p in range(R) for q in range(R)], dim=-1)
        .reshape(b * Hp * Hp, R * R * cin)
        for v, _ in views])
    kmats = torch.stack([k.reshape(R * R * cin, cout) for _, k in views])
    y = torch.bmm(cols, kmats).reshape(4, b, Hp, Hp, cout)
    return _interleave(y.permute(1, 2, 3, 0, 4), m)


def transpose_conv_auto(x, kernel, padding: int = 0, *, train: bool = False,
                        bias=None, act: str = "none"):
    """A single-layer plan for this layer's signature and epilogue, resolved
    once per autotune-cache generation
    (:func:`~repro_torch.kernels.plan.plan_layer_cached`) and executed: the
    tuned winner (in training mode, ``train=True``, the full-step race's
    winner at this batch; else the serving winner, one for every batch), or
    on a miss the CUDA cold rule, the implicit-GEMM kernel on a phase plane
    of fewer than 8 rows and the fused kernel otherwise."""
    return transpose_conv2d(x, kernel, padding, method="auto", train=train,
                            bias=bias, act=act)


METHODS = {
    "conventional": transpose_conv_conventional,
    "xla": transpose_conv_xla,
    "grouped": transpose_conv_grouped,
    "unified": transpose_conv_unified,
    "unified_reshape": transpose_conv_unified_reshape,
    "unified_fused": transpose_conv_unified_fused,
    "unified_matmul": transpose_conv_unified_matmul,
    "auto": transpose_conv_auto,
}
# The reference's Pallas spellings and the plan method of the hand-written
# CUDA kernel each one runs.
KERNEL_METHODS = {
    "pallas": "fused",
    "pallas_fused": "fused",
    "pallas_phase": "phase",
    "pallas_gemm": "gemm",
}


def transpose_conv2d(x, kernel, padding: int = 0, *, method: str = "unified",
                     train: bool = False, plan=None, bias=None,
                     act: str = "none") -> torch.Tensor:
    """Stride-2 transpose convolution, paper semantics, with the layer's
    elementwise tail ``act(y + bias)`` (:mod:`repro_torch.kernels.epilogue`).

    ``method`` is any name in :data:`METHODS` or :data:`KERNEL_METHODS`.
    ``auto`` and the kernel spellings resolve a memoized single-layer
    :class:`~repro_torch.kernels.plan.LayerPlan` and run it: the kernels
    apply the epilogue on their accumulator and differentiate through the
    backward the plan resolved. ``train=True`` makes ``auto`` follow the
    autotuner's full-step winner (:func:`transpose_conv_auto`). On a CUDA
    tensor a kernel spelling
    launches its kernel or raises; on a CPU tensor it runs the kernel's
    plain version. The baselines compose the same epilogue as post-ops.
    A given ``plan=`` skips the resolution and must have been compiled for
    this padding and epilogue.
    """
    from repro_torch.kernels import plan as planlib  # plan imports this module

    epi = epilib.make(bias, act)
    if plan is None and (method == "auto" or method in KERNEL_METHODS):
        plan = planlib.plan_layer_cached(
            x.shape[0], x.shape[1], kernel.shape[0], kernel.shape[2],
            kernel.shape[3], padding, x.dtype,
            method=KERNEL_METHODS.get(method, method), train=train,
            epilogue=epi,
        )
    if plan is not None:
        if plan.padding != padding:
            raise ValueError(
                f"plan was compiled for padding={plan.padding}, got {padding}"
            )
        if epilib.canonical(plan.epilogue) != epi:
            raise ValueError(
                f"plan was compiled for epilogue="
                f"{plan.epilogue.tag() if plan.epilogue else None}, got "
                f"{epi.tag() if epi else None} (recompile the plan with "
                "the layer's bias/activation)"
            )
        return planlib.execute_layer(plan, x, kernel, bias=bias)
    fn = METHODS.get(method)
    if fn is None:
        raise ValueError(
            f"unknown method {method!r}; one of {sorted(METHODS)} or "
            f"{sorted(KERNEL_METHODS)}"
        )
    y = fn(x, kernel, padding)
    return epi.apply(y, bias) if epi is not None else y
