"""Differentiable transpose-conv kernels. Mirrors ``repro/kernels/ops.py``
(the custom VJPs of ``transpose_conv2d_pallas`` and
``transpose_conv2d_pallas_gemm``).

:class:`TconvFusedFn` and :class:`TconvGemmFn` are ``torch.autograd.Function``
s around the two forward kernels. Each saves what ``_epi_residuals`` saves:
the inputs, the output ``y`` only when the epilogue has an activation (every
activation's derivative is a function of ``y``), and the bias only when the
epilogue adds one. The backward dispatches by the layer's plan
(``LayerPlan.bwd_method``), as ``_dispatch_bwd`` does:

  segregated  the three backward kernels of
              :mod:`repro_torch.kernels.transpose_conv2d_bwd` (the
              reference's ``"pallas"``): epilogue-grad, dx, dw with db.
  autograd    ``gm = g * act'(y)``, then torch autograd through
              :func:`repro_torch.core.transpose_conv.transpose_conv_unified`
              and ``db = sum gm`` (the reference's ``"lax"``). A yardstick
              only: on the card its convolutions are cuDNN's.

dx is computed only when the input needs a gradient. The phase and pair
Functions wait for their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import transpose_conv as tc
from repro_torch.kernels.transpose_conv2d import transpose_conv2d_fused
from repro_torch.kernels.transpose_conv2d_bwd import transpose_conv2d_bwd
from repro_torch.kernels.transpose_conv2d_gemm import transpose_conv2d_gemm

BWD_METHODS = ("segregated", "autograd")


def _save(ctx, lp, x, kernel, y, bias) -> None:
    epi = lp.epilogue
    ctx.lp = lp
    ctx.save_for_backward(
        x, kernel,
        y if epi is not None and epi.act != "none" else None,
        bias if epi is not None and epi.bias else None,
    )


def _autograd_bwd(x, kernel, y, g, padding, epi, need_dx):
    gm = g if epi is None else epi.grad_from_y(g, y)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(need_dx)
        kk = kernel.detach().requires_grad_(True)
        out = tc.transpose_conv_unified(xx, kk, padding)
        grads = torch.autograd.grad(out, (xx, kk) if need_dx else (kk,), gm)
    db = gm.sum((0, 1, 2)) if epi is not None and epi.bias else None
    return grads[0] if need_dx else None, grads[-1], db


def _backward(ctx, g):
    x, kernel, y, bias = ctx.saved_tensors
    lp = ctx.lp
    need_dx = ctx.needs_input_grad[0]
    if lp.bwd_method == "segregated":
        dx, dw, db = transpose_conv2d_bwd(x, kernel, g, lp.padding,
                                          epilogue=lp.epilogue, y=y,
                                          need_dx=need_dx)
    elif lp.bwd_method == "autograd":
        dx, dw, db = _autograd_bwd(x, kernel, y, g, lp.padding, lp.epilogue,
                                   need_dx)
    else:
        raise ValueError(f"unknown bwd_method {lp.bwd_method!r}; one of {BWD_METHODS}")
    if db is not None:
        db = db.to(bias.dtype)
    return dx, dw.to(kernel.dtype), db, None


class TconvFusedFn(torch.autograd.Function):
    """``act(tconv(x, kernel) + bias)`` through the fused kernel, for the
    resolved :class:`~repro_torch.kernels.plan.LayerPlan` ``lp``."""

    @staticmethod
    def forward(ctx, x, kernel, bias, lp):
        y = transpose_conv2d_fused(x, kernel, lp.padding, epilogue=lp.epilogue,
                                   bias=bias)
        _save(ctx, lp, x, kernel, y, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)


class TconvGemmFn(torch.autograd.Function):
    """The same layer through the implicit-GEMM kernel; the same backward:
    the forward race is decoupled from the backward one."""

    @staticmethod
    def forward(ctx, x, kernel, bias, lp):
        y = transpose_conv2d_gemm(x, kernel, lp.padding, epilogue=lp.epilogue,
                                  bias=bias)
        _save(ctx, lp, x, kernel, y, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)
