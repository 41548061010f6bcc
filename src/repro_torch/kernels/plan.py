"""Compile-once execution plans for the transpose-conv layers. Mirrors
``repro/kernels/plan.py`` (``LayerPlan``, ``FusedPairPlan``, ``TconvPlan``,
``plan_layer``, ``plan_layer_cached``, ``pair_legal``, ``plan_pair``,
``fuse_pairs``, ``compile_plan``, ``compile_plan_buckets``,
``execute_layer``, ``execute_pair``).

* :class:`LayerPlan` -- an immutable, hashable record of one layer: its
  signature (batch, N, n, Cin, Cout, P, dtype, epilogue), the resolved
  forward method and the resolved backward method.
* :class:`FusedPairPlan` -- two adjacent layer plans run as one launch of
  the pair kernel.
* :class:`TconvPlan` -- the ordered stack of a whole generator; its
  ``entries`` may hold pairs, its logical views flatten them.
* :func:`execute_layer` / :func:`execute_pair` -- run one resolved layer
  ``act(tconv + b)`` / one resolved pair.

Methods a plan resolves to:

  fused            the phase-fused CUDA kernel (the reference's
                   ``pallas_fused``), bias and activation applied in-kernel.
  gemm             the implicit-GEMM CUDA kernel (the reference's
                   ``pallas_gemm``), likewise.
  phase            the per-phase CUDA kernel (the reference's
                   ``pallas_phase``), likewise; pinned only, never chosen
                   by the cold rule.
  conventional, xla, grouped, unified, unified_reshape, unified_fused,
  unified_matmul
                   the PyTorch baselines of
                   :mod:`repro_torch.core.transpose_conv` (the reference's
                   lax methods), with the epilogue composed as post-ops.

``method="auto"`` follows the autotune cache (:mod:`repro_torch.kernels.
autotune`): in training mode (``train=True``) the ``step`` winner at the
plan's batch, else the serving winner of the layer's signature, one method
for every batch (the bucket rule). On a miss it resolves by the cold rule:
the implicit-GEMM kernel for a phase plane of fewer than 8 rows (the
channel-deep 4x4 head layers), the fused kernel otherwise. The reference's
cold rule splits at the same line between its dense and segregated forms.

The kernel methods run through the ``torch.autograd.Function`` s of
:mod:`repro_torch.kernels.ops`, whose backward is ``bwd_method``:
``segregated`` (the three backward kernels; the reference's ``pallas``) or
``autograd`` (autograd of the ``unified`` form; the reference's ``lax``),
``bwd="auto"`` follows the cache's ``bwd`` entry at the plan's batch
(:func:`resolve_bwd`), ``segregated`` on a miss.
(The reference's cold backward is its lax VJP off the TPU only because its
Pallas kernels interpret at Python speed there; here a CPU tensor runs the
kernels' plain versions, so one cold default serves both devices.) The
baselines differentiate through PyTorch's own autograd.

The pair pass (:func:`fuse_pairs`, run by :func:`compile_plan` and
:func:`compile_plan_buckets`) replaces adjacent layers with a
:class:`FusedPairPlan` where :func:`pair_legal` allows it: a stride-2 chain
with bias epilogues on both layers, fp32, and the pair kernel's per-block
shared memory
(:func:`~repro_torch.kernels.transpose_conv2d_pair.pair_smem_bytes`) within
the Hopper budget. ``fuse`` is ``"auto"`` (the default: a pair fuses iff
the serving choice of the autotuner's pair races, one for every batch by
the bucket rule of :mod:`~repro_torch.kernels.autotune`, is the pair
kernel), ``"force"``/``True`` (every legal pair) or ``"off"``/
``False`` (none). On a miss ``"auto"`` stays back to back on every device:
a departure from the reference, whose cold ``"auto"`` fuses on its
accelerator, because on the H100 the pair kernel loses to its two layers
back to back at every bucket measured (PERF.md section 6). Train-mode plans
stay unfused, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import segregation as seg
from repro_torch.core import transpose_conv as tc
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels import transpose_conv2d_pair as pairlib
from repro_torch.kernels.ops import (
    BWD_METHODS,
    TconvFusedFn,
    TconvGemmFn,
    TconvPairFn,
    TconvPhaseFn,
)

# every method but "auto", which a plan resolves and never holds
METHODS = ("fused", "gemm", "phase") + tuple(m for m in tc.METHODS if m != "auto")
_KERNEL_FNS = {"fused": TconvFusedFn, "gemm": TconvGemmFn, "phase": TconvPhaseFn}


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
    bwd_method: str = "segregated"
    # "cold" (the rule above), "tuned" (an autotune cache hit) or "pinned"
    # (an explicit method); not part of eq/hash, so the same decision
    # compares equal whatever its provenance
    source: str = dataclasses.field(default="cold", compare=False)

    def describe(self) -> str:
        epi = f" epi={self.epilogue.tag()}" if self.epilogue is not None else ""
        return (
            f"{self.n_in}x{self.n_in}x{self.cin}->{self.cout} "
            f"k{self.n_k} p{self.padding} b{self.batch} {self.dtype}: "
            f"fwd={self.method} bwd={self.bwd_method}{epi} ({self.source})"
        )


@dataclasses.dataclass(frozen=True)
class FusedPairPlan:
    """Two adjacent :class:`LayerPlan`s run as one launch of the pair kernel
    (:func:`~repro_torch.kernels.transpose_conv2d_pair.transpose_conv2d_pair`).

    The layer plans are kept as they are: a pair's backward recomputes the
    interface through ``first`` and runs both layers' own backwards, and
    either layer can still be executed alone. The kernel's partition is a
    function of the shape, so a pair carries no tiles.
    """

    first: LayerPlan
    second: LayerPlan
    source: str = dataclasses.field(default="forced", compare=False)

    method = "pair"   # what every FusedPairPlan executes as (not a field)

    @property
    def batch(self) -> int:
        return self.first.batch

    @property
    def padding(self) -> int:
        return self.first.padding

    @property
    def epilogue(self) -> Epilogue | None:
        """The pair's output epilogue; the interface epilogue is
        ``first.epilogue``, applied on the fp32 accumulator on chip."""
        return self.second.epilogue

    def describe(self) -> str:
        a, b = self.first, self.second
        return (
            f"{a.n_in}x{a.n_in}x{a.cin}->{a.cout}->{b.cout} k{a.n_k} "
            f"p{self.padding} b{self.batch} {a.dtype}: fwd=pair "
            f"iface={a.epilogue.tag()}@smem epi={b.epilogue.tag()} "
            f"bwd={a.bwd_method}/{b.bwd_method} ({self.source})"
        )


@dataclasses.dataclass(frozen=True)
class TconvPlan:
    """An ordered stack of plan entries for a whole generator.

    ``layers`` holds the entries in execution order: :class:`LayerPlan`s,
    with adjacent pairs possibly replaced by a :class:`FusedPairPlan`
    (:func:`fuse_pairs`). ``len``, iteration and indexing flatten pairs back
    to per-layer :class:`LayerPlan`s, so a plan always matches its config's
    layer count; executors walk :attr:`entries`.
    """

    name: str
    layers: tuple

    @property
    def entries(self) -> tuple:
        """Plan entries in execution order (pairs not flattened)."""
        return self.layers

    @functools.cached_property
    def _logical(self) -> tuple:
        out = []
        for e in self.layers:
            out.extend((e.first, e.second) if isinstance(e, FusedPairPlan)
                       else (e,))
        return tuple(out)

    def __len__(self) -> int:
        return len(self._logical)

    def __iter__(self):
        return iter(self._logical)

    def __getitem__(self, i) -> LayerPlan:
        return self._logical[i]

    def describe(self) -> str:
        n_pairs = sum(isinstance(e, FusedPairPlan) for e in self.layers)
        head = f"TconvPlan({self.name}, {len(self)} layers"
        lines = [head + (f", {n_pairs} fused pairs)" if n_pairs else ")")]
        i = 0
        for e in self.layers:
            if isinstance(e, FusedPairPlan):
                lines.append(f"  [{i}-{i + 1}] {e.describe()}")
                i += 2
            else:
                lines.append(f"  [{i}] {e.describe()}")
                i += 1
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
    dtype="float32", *, method: str = "auto", train: bool = False,
    epilogue: Epilogue | None = None, bwd: str = "auto",
) -> LayerPlan:
    """Resolve one layer: ``auto`` from the autotune cache (``step`` at
    batch ``b`` in training mode, else the serving ``fwd`` winner, which
    reads no batch; source ``tuned``), by :func:`cold_method` on a miss;
    any name in :data:`METHODS` pinned. The backward is ``auto``
    (:func:`resolve_bwd`) or any name in
    :data:`BWD_METHODS`."""
    from repro_torch.kernels import autotune

    dtype = _dtype_name(dtype)
    epilogue = epilib.canonical(epilogue)
    if method == "auto":
        sig = (b, n_in, n_k, cin, cout, padding, dtype)
        rec = autotune.best_entry(*sig, epilogue=epilogue) if train else None
        entry = ((rec or {}).get("step")
                 or autotune.best_method(*sig, epilogue=epilogue))
        if entry is not None and entry.get("method") in METHODS:
            resolved, source = entry["method"], "tuned"
        else:
            resolved, source = cold_method(n_in, n_k, padding), "cold"
    elif method in METHODS:
        resolved, source = method, "pinned"
    else:
        raise ValueError(f"unknown method {method!r}; one of {METHODS} or 'auto'")
    if bwd == "auto":
        bwd = resolve_bwd(b, n_in, n_k, cin, cout, padding, dtype,
                          epilogue=epilogue)
    elif bwd not in BWD_METHODS:
        raise ValueError(f"unknown bwd {bwd!r}; one of {BWD_METHODS} or 'auto'")
    return LayerPlan(
        batch=b, n_in=n_in, n_k=n_k, cin=cin, cout=cout, padding=padding,
        dtype=dtype, epilogue=epilogue, method=resolved, bwd_method=bwd,
        source=source,
    )


def resolve_bwd(b: int, n_in: int, n_k: int, cin: int, cout: int,
                padding: int, dtype: str = "float32", *, epilogue=None) -> str:
    """The backward of one layer signature, as the reference's
    ``_resolve_bwd`` resolves it: the autotune cache's ``bwd`` winner at
    batch ``b`` (a training consult may read the batch), else
    ``segregated``."""
    from repro_torch.kernels import autotune

    entry = autotune.best_bwd(b, n_in, n_k, cin, cout, padding, dtype,
                              epilogue=epilogue)
    if entry is not None and entry.get("method") in BWD_METHODS:
        return entry["method"]
    return "segregated"


@functools.lru_cache(maxsize=None)
def _plan_layer_cached(b, n_in, n_k, cin, cout, padding, dtype, method, train,
                       epilogue, generation) -> LayerPlan:
    del generation   # part of the memo key only: a retune resolves again
    return plan_layer(b, n_in, n_k, cin, cout, padding, dtype, method=method,
                      train=train, epilogue=epilogue)


def plan_layer_cached(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype="float32", *, method: str = "auto", train: bool = False,
    epilogue: Epilogue | None = None,
) -> LayerPlan:
    """Memoized :func:`plan_layer`, keyed by the signature and the autotune
    cache's generation: a layer resolves once per cache state, and a retune
    resolves it again."""
    from repro_torch.kernels import autotune

    return _plan_layer_cached(b, n_in, n_k, cin, cout, padding,
                              _dtype_name(dtype), method, train,
                              epilib.canonical(epilogue), autotune.generation())


def _layer_epilogues(cfg, epilogues) -> tuple:
    if epilogues is None:
        return (None,) * len(cfg.layers)
    if len(epilogues) != len(cfg.layers):
        raise ValueError(
            f"epilogues has {len(epilogues)} entries for "
            f"{len(cfg.layers)} layers"
        )
    return tuple(epilogues)


# --------------------------------------------------------------- pair fusion

def check_fuse(fuse) -> str:
    """``fuse`` as ``"auto"``, ``"force"`` (also ``True``) or ``"off"``
    (also ``False``); anything else raises."""
    if fuse is True or fuse == "force":
        return "force"
    if fuse is False or fuse == "off":
        return "off"
    if fuse == "auto":
        return "auto"
    raise ValueError(
        f"fuse must be 'auto', 'off', 'force', False or True, got {fuse!r}")


def pair_legal(lp1: LayerPlan, lp2: LayerPlan) -> tuple[bool, str]:
    """Whether two adjacent layer plans may run as one pair launch, and if
    not, which check failed: the stride-2 tconv -> tconv chain (the
    consumer's input extent is the producer's output extent, channels
    chain, same kernel and padding), a bias epilogue on the interface and
    on the output, fp32 on both layers (the port's kernels take fp32 only),
    a kernel extent the pair kernel was built for, and the shared memory a
    block of the pair kernel asks for
    (:func:`~repro_torch.kernels.transpose_conv2d_pair.pair_smem_bytes`)
    within :data:`~repro_torch.kernels.transpose_conv2d_pair.PAIR_SMEM_BUDGET_BYTES`.
    """
    if lp1.batch != lp2.batch:
        return False, f"batch mismatch ({lp1.batch} vs {lp2.batch})"
    if lp1.n_k != lp2.n_k or lp1.padding != lp2.padding:
        return False, "kernel/padding mismatch"
    m1 = seg.output_size(lp1.n_in, lp1.n_k, lp1.padding)
    if lp2.n_in != m1:
        return False, f"not adjacent (consumer n_in {lp2.n_in} != M1 {m1})"
    if lp1.cout != lp2.cin:
        return False, f"channel chain broken ({lp1.cout} -> {lp2.cin})"
    epi1, epi2 = lp1.epilogue, lp2.epilogue
    if epi1 is None or not epi1.bias:
        return False, "no bias epilogue on the interface"
    if epi2 is None or not epi2.bias:
        return False, "no bias epilogue on the output"
    if lp2.dtype != "float32":
        return False, (
            f"consumer dtype {lp2.dtype} != float32 (the interface is the "
            "fp32 accumulator)"
        )
    if lp1.dtype != "float32":
        return False, (
            f"producer dtype {lp1.dtype} != float32 (the port's kernels take "
            "fp32 only)"
        )
    if seg.ceil_half(lp1.n_k) > pairlib.MAX_R:
        return False, f"kernel {lp1.n_k}x{lp1.n_k} larger than the pair kernel's"
    need = pairlib.pair_smem_bytes(lp1.n_in, lp1.n_k, lp1.cin, lp1.cout,
                                   lp2.cout, lp1.padding)
    if need > pairlib.PAIR_SMEM_BUDGET_BYTES:
        return False, (
            f"shared memory estimate {need} B > budget "
            f"{pairlib.PAIR_SMEM_BUDGET_BYTES} B"
        )
    return True, "ok"


def plan_pair(lp1: LayerPlan, lp2: LayerPlan, *,
              fuse="auto") -> FusedPairPlan | None:
    """The :class:`FusedPairPlan` of two adjacent layers, or ``None`` (they
    stay apart): ``fuse="force"`` fuses every legal pair, ``"off"`` none,
    ``"auto"`` those whose pair race the pair kernel won
    (:func:`~repro_torch.kernels.autotune.best_pair`, which reads no
    batch), none on a miss. An illegal pair never fuses."""
    fuse = check_fuse(fuse)
    if fuse == "off" or not pair_legal(lp1, lp2)[0]:
        return None
    if fuse == "force":
        return FusedPairPlan(first=lp1, second=lp2)
    from repro_torch.kernels import autotune

    rec = autotune.best_pair(
        lp1.batch, lp1.n_in, lp1.n_k, lp1.cin, lp1.cout, lp2.cout, lp1.padding,
        lp1.dtype, epilogue1=lp1.epilogue, epilogue2=lp2.epilogue,
    )
    if rec is not None and rec["method"] == "pair":
        return FusedPairPlan(first=lp1, second=lp2, source="tuned")
    return None


def fuse_pairs(plan: TconvPlan, *, train: bool = False,
               fuse="auto") -> TconvPlan:
    """The plan-level pair pass: walk the logical layers left to right and
    fuse each pair :func:`plan_pair` allows (a fused layer is consumed and
    the walk goes on after it). ``fuse="off"`` and train-mode plans are
    returned as they are; otherwise any pairs are flattened first, so the
    pass is idempotent."""
    if train or check_fuse(fuse) == "off":
        return plan
    logical = tuple(plan)
    entries = []
    i = 0
    while i < len(logical):
        fp = None
        if i + 1 < len(logical):
            fp = plan_pair(logical[i], logical[i + 1], fuse=fuse)
        entries.append(fp if fp is not None else logical[i])
        i += 2 if fp is not None else 1
    return TconvPlan(name=plan.name, layers=tuple(entries))


def plan_follows_fuse(plan: TconvPlan, fuse) -> bool:
    """Whether ``plan``'s pairs are what the pair pass makes under ``fuse``:
    no pair for ``"off"``; for ``"force"``, no two adjacent per-layer
    entries that :func:`pair_legal` allows (the pass would have fused
    them); for ``"auto"``, exactly the pairs the pass fuses now."""
    entries = plan.entries
    fuse = check_fuse(fuse)
    if fuse == "off":
        return not any(isinstance(e, FusedPairPlan) for e in entries)
    if fuse == "auto":
        flat = TconvPlan(name=plan.name, layers=tuple(plan))
        return fuse_pairs(flat, fuse="auto").entries == entries
    return not any(
        isinstance(a, LayerPlan) and isinstance(b, LayerPlan)
        and pair_legal(a, b)[0]
        for a, b in zip(entries, entries[1:])
    )


def compile_plan(cfg, batch: int, dtype="float32", *, train: bool = False,
                 method: str = "auto", epilogues=None, bwd: str = "auto",
                 fuse="auto") -> TconvPlan:
    """A whole-generator :class:`TconvPlan`. ``cfg`` has ``layers`` as
    ``(input_hw, cin, cout)`` triples plus ``kernel``/``padding``/``name``;
    ``epilogues`` is an optional per-layer tuple of :class:`Epilogue`;
    ``train`` resolves ``auto`` from the training entries; ``fuse`` runs
    the pair pass (:func:`fuse_pairs`). Compile after tuning: a plan is
    immutable, and a retune takes effect at the next compile."""
    epis = _layer_epilogues(cfg, epilogues)
    layers = tuple(
        plan_layer(batch, hw, cfg.kernel, cin, cout, cfg.padding, dtype,
                   method=method, train=train, epilogue=epi, bwd=bwd)
        for (hw, cin, cout), epi in zip(cfg.layers, epis)
    )
    return fuse_pairs(TconvPlan(name=getattr(cfg, "name", "tconv"),
                                layers=layers), train=train, fuse=fuse)


def compile_plan_buckets(cfg, batches, dtype="float32", *, train: bool = False,
                         method: str = "auto", epilogues=None,
                         fuse="auto") -> dict:
    """``{batch: TconvPlan}`` over a set of batch buckets, each layer
    resolved through :func:`plan_layer_cached`, then the pair pass."""
    epis = _layer_epilogues(cfg, epilogues)
    name = getattr(cfg, "name", "tconv")
    plans = {}
    for batch in sorted({int(b) for b in batches}):
        if batch < 1:
            raise ValueError(f"batch buckets must be positive, got {batch}")
        plans[batch] = fuse_pairs(TconvPlan(name=name, layers=tuple(
            plan_layer_cached(batch, hw, cfg.kernel, cin, cout, cfg.padding,
                              dtype, method=method, train=train, epilogue=epi)
            for (hw, cin, cout), epi in zip(cfg.layers, epis)
        )), train=train, fuse=fuse)
    return plans


def execute_layer(lp: LayerPlan, x, kernel, *, bias=None) -> torch.Tensor:
    """Run one resolved layer, the whole ``act(tconv + b)`` unit. The batch
    may differ from the plan's (a plan is resolved per bucket, and the
    methods are batch-generic); the rest of the signature must match."""
    if isinstance(lp, FusedPairPlan):
        raise TypeError(
            "a FusedPairPlan spans two layers (two kernels, two biases): run "
            "it with execute_pair, or its .first/.second LayerPlans alone"
        )
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
    if lp.method in _KERNEL_FNS:
        return _KERNEL_FNS[lp.method].apply(x, kernel, bias, lp)
    fn = tc.METHODS.get(lp.method)
    if fn is None:
        raise ValueError(f"LayerPlan resolved to unknown method {lp.method!r}")
    y = fn(x, kernel, lp.padding)
    return epi.apply(y, bias) if epi is not None else y


def execute_pair(fp: FusedPairPlan, x, k1, k2, *, bias1=None,
                 bias2=None) -> torch.Tensor:
    """Run one resolved layer pair as one pair-kernel launch. ``k1``/
    ``bias1`` belong to the producer (the interface epilogue), ``k2``/
    ``bias2`` to the consumer. Differentiable through
    :class:`~repro_torch.kernels.ops.TconvPairFn`."""
    lp1, lp2 = fp.first, fp.second
    if (x.shape[1], k1.shape[0], k1.shape[2], k1.shape[3]) != (
        lp1.n_in, lp1.n_k, lp1.cin, lp1.cout
    ) or _dtype_name(x.dtype) != lp1.dtype:
        raise ValueError(
            f"FusedPairPlan mismatch: pair is {fp.describe()!r}, got input "
            f"{tuple(x.shape)}/{x.dtype} k1 {tuple(k1.shape)}"
        )
    if (k2.shape[0], k2.shape[2], k2.shape[3]) != (lp2.n_k, lp2.cin, lp2.cout):
        raise ValueError(
            f"FusedPairPlan mismatch: pair is {fp.describe()!r}, got k2 "
            f"{tuple(k2.shape)}"
        )
    for name, epi, bias in (("interface", lp1.epilogue, bias1),
                            ("output", lp2.epilogue, bias2)):
        if (epi is not None and epi.bias) != (bias is not None):
            raise ValueError(
                f"FusedPairPlan {name} epilogue mismatch: pair is "
                f"{fp.describe()!r}, got "
                f"bias={'set' if bias is not None else None}"
            )
    return TconvPairFn.apply(x, k1, k2, bias1, bias2, fp)
