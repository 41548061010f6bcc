"""Compile-once execution plans for the transpose-conv layers. Mirrors
``repro/kernels/plan.py`` (``LayerPlan``, ``TconvPlan``, ``plan_layer``,
``plan_layer_cached``, ``compile_plan``, ``compile_plan_buckets``,
``execute_layer``).

* :class:`LayerPlan` -- an immutable, hashable record of one layer: its
  signature (batch, N, n, Cin, Cout, P, dtype, epilogue) and the resolved
  forward method.
* :class:`TconvPlan` -- the ordered stack of a whole generator.
* :func:`execute_layer` -- runs one resolved layer ``act(tconv + b)``.

Methods a plan resolves to:

  fused            the phase-fused CUDA kernel (the reference's
                   ``pallas_fused``), bias and activation applied in-kernel.
  gemm             the implicit-GEMM CUDA kernel (the reference's
                   ``pallas_gemm``), likewise.
  conventional, xla, unified, unified_reshape
                   the PyTorch baselines of
                   :mod:`repro_torch.core.transpose_conv` (the reference's
                   lax methods), with the epilogue composed as post-ops.

``method="auto"`` resolves by the cold rule (there is no autotune cache
yet): the implicit-GEMM kernel for a phase plane of fewer than 8 rows (the
channel-deep 4x4 head layers), the fused kernel otherwise. The reference's
cold rule splits at the same line between its dense and segregated forms.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import segregation as seg
from repro_torch.core import transpose_conv as tc
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.transpose_conv2d import transpose_conv2d_fused
from repro_torch.kernels.transpose_conv2d_gemm import transpose_conv2d_gemm

METHODS = ("fused", "gemm") + tuple(tc.METHODS)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Resolved dispatch for ONE transpose-conv layer (immutable, hashable)."""

    batch: int
    n_in: int
    n_k: int
    cin: int
    cout: int
    padding: int
    dtype: str = "float32"
    epilogue: Epilogue | None = None
    method: str = "unified_reshape"
    # "cold" (the rule above) or "pinned" (an explicit method); not part of
    # eq/hash, so the same decision compares equal whatever its provenance
    source: str = dataclasses.field(default="cold", compare=False)

    def describe(self) -> str:
        epi = f" epi={self.epilogue.tag()}" if self.epilogue is not None else ""
        return (
            f"{self.n_in}x{self.n_in}x{self.cin}->{self.cout} "
            f"k{self.n_k} p{self.padding} b{self.batch} {self.dtype}: "
            f"fwd={self.method}{epi} ({self.source})"
        )


@dataclasses.dataclass(frozen=True)
class TconvPlan:
    """An ordered stack of :class:`LayerPlan`s for a whole generator."""

    name: str
    layers: tuple

    def __len__(self) -> int:
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    def __getitem__(self, i) -> LayerPlan:
        return self.layers[i]

    def describe(self) -> str:
        lines = [f"TconvPlan({self.name}, {len(self)} layers)"]
        lines += [f"  [{i}] {lp.describe()}" for i, lp in enumerate(self.layers)]
        return "\n".join(lines)


def cold_method(n_in: int, n_k: int, padding: int) -> str:
    """The CUDA cold rule: ``gemm`` iff the phase plane ``ceil(M/2) < 8``."""
    m = seg.output_size(n_in, n_k, padding)
    return "fused" if (m + 1) // 2 >= 8 else "gemm"


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def plan_layer(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype="float32", *, method: str = "auto",
    epilogue: Epilogue | None = None,
) -> LayerPlan:
    """Resolve one layer: ``auto`` by :func:`cold_method`, any name in
    :data:`METHODS` pinned."""
    if method == "auto":
        resolved, source = cold_method(n_in, n_k, padding), "cold"
    elif method in METHODS:
        resolved, source = method, "pinned"
    else:
        raise ValueError(f"unknown method {method!r}; one of {METHODS} or 'auto'")
    return LayerPlan(
        batch=b, n_in=n_in, n_k=n_k, cin=cin, cout=cout, padding=padding,
        dtype=_dtype_name(dtype), epilogue=epilib.canonical(epilogue),
        method=resolved, source=source,
    )


@functools.lru_cache(maxsize=None)
def _plan_layer_cached(b, n_in, n_k, cin, cout, padding, dtype, method,
                       epilogue) -> LayerPlan:
    return plan_layer(b, n_in, n_k, cin, cout, padding, dtype, method=method,
                      epilogue=epilogue)


def plan_layer_cached(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype="float32", *, method: str = "auto",
    epilogue: Epilogue | None = None,
) -> LayerPlan:
    """Memoized :func:`plan_layer`: a layer signature resolves once."""
    return _plan_layer_cached(b, n_in, n_k, cin, cout, padding,
                              _dtype_name(dtype), method,
                              epilib.canonical(epilogue))


def _layer_epilogues(cfg, epilogues) -> tuple:
    if epilogues is None:
        return (None,) * len(cfg.layers)
    if len(epilogues) != len(cfg.layers):
        raise ValueError(
            f"epilogues has {len(epilogues)} entries for "
            f"{len(cfg.layers)} layers"
        )
    return tuple(epilogues)


def compile_plan(cfg, batch: int, dtype="float32", *, method: str = "auto",
                 epilogues=None) -> TconvPlan:
    """A whole-generator :class:`TconvPlan`. ``cfg`` has ``layers`` as
    ``(input_hw, cin, cout)`` triples plus ``kernel``/``padding``/``name``;
    ``epilogues`` is an optional per-layer tuple of :class:`Epilogue`."""
    epis = _layer_epilogues(cfg, epilogues)
    layers = tuple(
        plan_layer(batch, hw, cfg.kernel, cin, cout, cfg.padding, dtype,
                   method=method, epilogue=epi)
        for (hw, cin, cout), epi in zip(cfg.layers, epis)
    )
    return TconvPlan(name=getattr(cfg, "name", "tconv"), layers=layers)


def compile_plan_buckets(cfg, batches, dtype="float32", *,
                         method: str = "auto", epilogues=None) -> dict:
    """``{batch: TconvPlan}`` over a set of batch buckets, each layer
    resolved through :func:`plan_layer_cached`."""
    epis = _layer_epilogues(cfg, epilogues)
    name = getattr(cfg, "name", "tconv")
    plans = {}
    for batch in sorted({int(b) for b in batches}):
        if batch < 1:
            raise ValueError(f"batch buckets must be positive, got {batch}")
        plans[batch] = TconvPlan(name=name, layers=tuple(
            plan_layer_cached(batch, hw, cfg.kernel, cin, cout, cfg.padding,
                              dtype, method=method, epilogue=epi)
            for (hw, cin, cout), epi in zip(cfg.layers, epis)
        ))
    return plans


def execute_layer(lp: LayerPlan, x, kernel, *, bias=None) -> torch.Tensor:
    """Run one resolved layer, the whole ``act(tconv + b)`` unit. The batch
    may differ from the plan's (a plan is resolved per bucket, and the
    methods are batch-generic); the rest of the signature must match."""
    if (x.shape[1], kernel.shape[0], kernel.shape[2], kernel.shape[3]) != (
        lp.n_in, lp.n_k, lp.cin, lp.cout
    ) or _dtype_name(x.dtype) != lp.dtype:
        raise ValueError(
            f"LayerPlan mismatch: plan is for {lp.describe()!r}, got input "
            f"{tuple(x.shape)}/{x.dtype} kernel {tuple(kernel.shape)}"
        )
    epi = lp.epilogue
    if (epi is not None and epi.bias) != (bias is not None):
        raise ValueError(
            f"LayerPlan epilogue mismatch: plan is for {lp.describe()!r}, "
            f"got bias={'set' if bias is not None else None}"
        )
    if lp.method == "fused":
        return transpose_conv2d_fused(x, kernel, lp.padding, epilogue=epi,
                                      bias=bias)
    if lp.method == "gemm":
        return transpose_conv2d_gemm(x, kernel, lp.padding, epilogue=epi,
                                     bias=bias)
    fn = tc.METHODS.get(lp.method)
    if fn is None:
        raise ValueError(f"LayerPlan resolved to unknown method {lp.method!r}")
    y = fn(x, kernel, lp.padding)
    return epi.apply(y, bias) if epi is not None else y
