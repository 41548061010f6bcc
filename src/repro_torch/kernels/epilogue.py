"""Fused bias + activation epilogues. Mirrors ``repro/kernels/epilogue.py``.

A GAN layer is ``act(tconv(x, W) + b)``. An :class:`Epilogue` is the
immutable, hashable record of that elementwise tail: whether a
per-output-channel bias is added and which activation follows (``none`` /
``relu`` / ``tanh`` / ``leaky_relu``). It rides inside
:class:`repro_torch.kernels.plan.LayerPlan`, and the CUDA kernels apply it
on the fp32 accumulator before their single store (:attr:`Epilogue.code`).

Every activation's derivative is expressible from the saved output ``y``
(:meth:`Epilogue.grad_from_y`); ``relu``/``leaky_relu`` are written as
``where(y > 0, ...)`` in both directions, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

ACTIVATIONS = ("none", "relu", "tanh", "leaky_relu")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Elementwise tail of one transpose-conv layer: ``act(y + bias)``."""

    bias: bool = False
    act: str = "none"
    slope: float = 0.2  # leaky_relu negative slope (the generator zoo uses 0.2)

    def __post_init__(self):
        if self.act not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.act!r}; one of {ACTIVATIONS}"
            )
        if self.act == "leaky_relu" and not self.slope > 0:
            raise ValueError(
                f"leaky_relu slope must be > 0 (got {self.slope}): the "
                "backward recovers the pre-activation sign from y's sign"
            )

    @property
    def is_identity(self) -> bool:
        return not self.bias and self.act == "none"

    @property
    def code(self) -> int:
        """The activation's index in :data:`ACTIVATIONS`, as the CUDA
        kernels take it (0 none, 1 relu, 2 tanh, 3 leaky_relu)."""
        return ACTIVATIONS.index(self.act)

    def tag(self) -> str:
        """``none`` | ``b`` | ``relu`` | ``b+relu`` | ``b+leaky0.2`` | ..."""
        if self.is_identity:
            return "none"
        a = self.act
        if a == "leaky_relu":
            a = f"leaky{self.slope:g}"
        if a == "none":
            return "b"
        return f"b+{a}" if self.bias else a

    def apply_act(self, y: torch.Tensor) -> torch.Tensor:
        """The activation alone."""
        if self.act == "relu":
            return torch.where(y > 0, y, torch.zeros_like(y))
        if self.act == "leaky_relu":
            return torch.where(y > 0, y, self.slope * y)
        if self.act == "tanh":
            return torch.tanh(y)
        return y

    def apply(self, y: torch.Tensor, bias=None) -> torch.Tensor:
        """``act(y + bias)``, the composed post-op form the kernels are
        held against."""
        if self.bias:
            if bias is None:
                raise ValueError(f"epilogue {self.tag()!r} requires a bias")
            y = y + bias.to(y.dtype)
        return self.apply_act(y)

    def grad_from_y(self, g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``g * act'(y)`` from the saved post-activation output ``y``."""
        if self.act == "relu":
            return torch.where(y > 0, g, torch.zeros_like(g))
        if self.act == "leaky_relu":
            return torch.where(y > 0, g, self.slope * g)
        if self.act == "tanh":
            return g * (1.0 - y * y)
        return g


def canonical(epilogue: Epilogue | None) -> Epilogue | None:
    """Identity epilogues become None (the no-epilogue path everywhere)."""
    if epilogue is None or epilogue.is_identity:
        return None
    return epilogue


@functools.lru_cache(maxsize=None)
def _make_cached(has_bias: bool, act: str, slope: float) -> Epilogue | None:
    return canonical(Epilogue(bias=has_bias, act=act, slope=slope))


def make(bias, act: str = "none", slope: float = 0.2) -> Epilogue | None:
    """Epilogue from a (possibly None) bias tensor and an activation name,
    memoized on (bias presence, act, slope)."""
    return _make_cached(bias is not None, act, slope)


def check_bias(epi: Epilogue | None, bias) -> None:
    """Raise unless ``bias`` is given exactly when ``epi`` adds one."""
    if (epi is not None and epi.bias) != (bias is not None):
        raise ValueError(
            f"epilogue {epi.tag() if epi else None!r} and "
            f"bias={'set' if bias is not None else None} disagree"
        )
