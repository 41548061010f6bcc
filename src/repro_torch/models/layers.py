"""Transpose-conv layers of the GAN generators. Mirrors ``tconv_init`` and
``tconv_apply`` of ``repro/models/layers.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import plan as planlib


def tconv_init(generator: torch.Generator, n: int, cin: int, cout: int, *,
               device) -> dict:
    """``n x n`` HWIO transpose-conv kernel (fan-in scaled normal, drawn
    from ``generator``) and a zero bias, on ``device``."""
    w = torch.randn((n, n, cin, cout), generator=generator,
                    device=generator.device) * (n * n * cin) ** -0.5
    return {
        "w": w.to(device),
        "b": torch.zeros((cout,), device=device),
    }


def tconv_apply(p: dict, x: torch.Tensor, padding: int, *,
                method: str = "auto", plan=None,
                act: str = "none"):
    """Stride-2 transpose convolution + bias + activation as one unit,
    differentiable in ``x``, ``p["w"]`` and ``p["b"]``.

    ``plan=`` (a :class:`~repro_torch.kernels.plan.LayerPlan` compiled
    with this layer's epilogue) runs exactly what the plan resolved;
    without one, a memoized single-layer plan is resolved for ``method``.
    """
    w, b = p["w"], p["b"]
    epi = epilib.make(b, act)
    if plan is None:
        plan = planlib.plan_layer_cached(
            x.shape[0], x.shape[1], w.shape[0], w.shape[2], w.shape[3],
            padding, x.dtype, method=method, epilogue=epi,
        )
    if plan.padding != padding:
        raise ValueError(
            f"plan was compiled for padding={plan.padding}, got {padding}"
        )
    if plan.epilogue != epi:
        raise ValueError(
            f"plan was compiled for epilogue="
            f"{plan.epilogue.tag() if plan.epilogue else None}, got {epi.tag()}"
        )
    return planlib.execute_layer(plan, x, w, bias=b)
