"""Differentiable transpose-conv kernels. Mirrors ``repro/kernels/ops.py``
(the custom VJPs of ``transpose_conv2d_pallas``,
``transpose_conv2d_pallas_phase``, ``transpose_conv2d_pallas_gemm`` and
``transpose_conv2d_pair``).

:class:`TconvFusedFn`, :class:`TconvPhaseFn` and :class:`TconvGemmFn` are
``torch.autograd.Function`` s around the three single-layer forward
kernels. Each saves what ``_epi_residuals`` saves: the inputs, the output
``y`` only when the epilogue has an activation (every activation's
derivative is a function of ``y``), and the bias only when the epilogue
adds one. The backward dispatches by the layer's plan
(``LayerPlan.bwd_method``), as ``_dispatch_bwd`` does:

  segregated  the backward kernels of
              :mod:`repro_torch.kernels.transpose_conv2d_bwd` (the
              reference's ``"pallas"``): dx, and dw with db, each applying
              ``act'(y)`` as it stages ``g`` (on the CPU: the plain
              epilogue-grad, dx and dw).
  autograd    ``gm = g * act'(y)``, then torch autograd through
              :func:`repro_torch.core.transpose_conv.transpose_conv_unified`
              and ``db = sum gm`` (the reference's ``"lax"``). On the card
              its convolutions are cuDNN's.

A plan's ``bwd="auto"`` resolves in
:func:`repro_torch.kernels.plan.resolve_bwd`.

dx is computed only when the input needs a gradient, dw and db only when
the kernel or the bias does (a discriminator's layers in the generator's
phase need dx alone).

:class:`TconvPairFn` runs two layers through the pair kernel and saves only
the pair's inputs; its backward recomputes the interface through the
producer's own layer plan and chains both layers' backwards, as
``_pair_bwd`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core import transpose_conv as tc
from repro_torch.kernels.transpose_conv2d import (
    transpose_conv2d_fused,
    transpose_conv2d_phase,
)
from repro_torch.kernels.transpose_conv2d_bwd import transpose_conv2d_bwd
from repro_torch.kernels.transpose_conv2d_gemm import transpose_conv2d_gemm
from repro_torch.kernels.transpose_conv2d_pair import transpose_conv2d_pair

BWD_METHODS = ("segregated", "autograd")


def _save(ctx, lp, x, kernel, y, bias) -> None:
    epi = lp.epilogue
    ctx.lp = lp
    ctx.save_for_backward(
        x, kernel,
        y if epi is not None and epi.act != "none" else None,
        bias if epi is not None and epi.bias else None,
    )


def _autograd_bwd(x, kernel, y, g, padding, epi, need_dx, need_dw=True):
    gm = g if epi is None else epi.grad_from_y(g, y)
    wanted = [t for t, need in ((x, need_dx), (kernel, need_dw)) if need]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in wanted]
        xx = leaves[0] if need_dx else x.detach()
        kk = leaves[-1] if need_dw else kernel.detach()
        out = tc.transpose_conv_unified(xx, kk, padding)
        grads = torch.autograd.grad(out, leaves, gm)
    db = gm.sum((0, 1, 2)) if need_dw and epi is not None and epi.bias else None
    return (grads[0] if need_dx else None), (grads[-1] if need_dw else None), db


def _backward(ctx, g):
    x, kernel, y, bias = ctx.saved_tensors
    lp = ctx.lp
    need_dx = ctx.needs_input_grad[0]
    # dw and db come out of one kernel: computed where either is needed
    need_dw = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
    if lp.bwd_method == "segregated":
        dx, dw, db = transpose_conv2d_bwd(x, kernel, g, lp.padding,
                                          epilogue=lp.epilogue, y=y,
                                          need_dx=need_dx, need_dw=need_dw)
    elif lp.bwd_method == "autograd":
        dx, dw, db = _autograd_bwd(x, kernel, y, g, lp.padding, lp.epilogue,
                                   need_dx, need_dw)
    else:
        raise ValueError(f"unknown bwd_method {lp.bwd_method!r}; one of {BWD_METHODS}")
    if db is not None:
        db = db.to(bias.dtype)
    if dw is not None:
        dw = dw.to(kernel.dtype)
    return dx, dw, db, None


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


class TconvPhaseFn(torch.autograd.Function):
    """The same layer through the per-phase kernel; the same backward."""

    @staticmethod
    def forward(ctx, x, kernel, bias, lp):
        y = transpose_conv2d_phase(x, kernel, lp.padding, epilogue=lp.epilogue,
                                   bias=bias)
        _save(ctx, lp, x, kernel, y, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)


class TconvPairFn(torch.autograd.Function):
    """Two adjacent layers through the pair kernel, for the resolved
    :class:`~repro_torch.kernels.plan.FusedPairPlan` ``fp``. Saves the pair's
    inputs only: the interface was never a tensor. The backward recomputes
    it through :func:`~repro_torch.kernels.plan.execute_layer` of
    ``fp.first`` and differentiates both layers' own plans, so a pair's
    gradients are those of the two layers run apart."""

    @staticmethod
    def forward(ctx, x, k1, k2, b1, b2, fp):
        y = transpose_conv2d_pair(
            x, k1, k2, fp.padding, epilogue1=fp.first.epilogue, bias1=b1,
            epilogue2=fp.second.epilogue, bias2=b2,
        )
        ctx.fp = fp
        ctx.save_for_backward(x, k1, k2, b1, b2)
        return y

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.plan import execute_layer

        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        x, k1, k2, b1, b2 = leaves
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            y1 = execute_layer(ctx.fp.first, x, k1, bias=b1)
            y2 = execute_layer(ctx.fp.second, y1, k2, bias=b2)
            grads = iter(torch.autograd.grad(y2, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in leaves) + (None,)
