"""Plan registry: compiled plans as a JSON file. Mirrors
``repro/kernels/plan_registry.py``.

A registry maps string keys (the serving engine uses ``"{model}:{batch}"``)
to serialized :class:`~repro_torch.kernels.plan.TconvPlan` s, so a warm start
(``GanEngine.warmup(registry_path=...)``) adopts the plans a previous
process resolved instead of compiling them again.

The format is the reference's ``version: 1``: every
:class:`~repro_torch.kernels.plan.LayerPlan` field as it is, epilogues as
``{bias, act, slope}``, fused pairs as ``kind: "pair"`` entries holding both
layer plans. Loaded layer plans are marked ``source="registry"`` unless the
file recorded a provenance. A method or backward the port does not have
(a reference registry's ``pallas_fused``, say) raises on load: a registry is
a pinned artifact, and a plan the port cannot run must not be adopted.
Writes are atomic (a temporary file, then a rename).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path

from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.ops import BWD_METHODS
from repro_torch.kernels.plan import METHODS, FusedPairPlan, LayerPlan, TconvPlan

REGISTRY_VERSION = 1

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerPlan))


def _epi_to_json(epi: Epilogue | None) -> dict | None:
    if epi is None:
        return None
    return {"bias": epi.bias, "act": epi.act, "slope": epi.slope}


def _epi_from_json(d: dict | None) -> Epilogue | None:
    if d is None:
        return None
    return Epilogue(bias=d["bias"], act=d["act"], slope=d.get("slope", 0.2))


def _layer_to_json(lp: LayerPlan) -> dict:
    d = {f: getattr(lp, f) for f in _LAYER_FIELDS}
    d["epilogue"] = _epi_to_json(lp.epilogue)
    return d


def _layer_from_json(d: dict) -> LayerPlan:
    if d.get("method") not in METHODS:
        raise ValueError(
            f"plan-registry layer method {d.get('method')!r} is not one of "
            f"the port's {METHODS}"
        )
    if d.get("bwd_method", "segregated") not in BWD_METHODS:
        raise ValueError(
            f"plan-registry layer backward {d.get('bwd_method')!r} is not one "
            f"of the port's {BWD_METHODS}"
        )
    kw = {k: v for k, v in d.items() if k in _LAYER_FIELDS}
    kw["epilogue"] = _epi_from_json(d.get("epilogue"))
    kw.setdefault("source", "registry")
    return LayerPlan(**kw)


def plan_to_dict(plan: TconvPlan) -> dict:
    """One plan as a JSON-ready dict (entries in execution order)."""
    entries = []
    for e in plan.entries:
        if isinstance(e, FusedPairPlan):
            entries.append({
                "kind": "pair",
                "first": _layer_to_json(e.first),
                "second": _layer_to_json(e.second),
                "source": e.source,
            })
        else:
            entries.append({"kind": "layer", **_layer_to_json(e)})
    return {"name": plan.name, "entries": entries}


def plan_from_dict(d: dict) -> TconvPlan:
    """Inverse of :func:`plan_to_dict`: the same plan objects."""
    entries = []
    for e in d["entries"]:
        if e.get("kind") == "pair":
            entries.append(FusedPairPlan(
                first=_layer_from_json(e["first"]),
                second=_layer_from_json(e["second"]),
                source=e.get("source", "registry"),
            ))
        else:
            entries.append(_layer_from_json(e))
    return TconvPlan(name=d["name"], layers=tuple(entries))


def save_plan_registry(plans: dict, path) -> None:
    """Write ``{key: TconvPlan}`` to ``path`` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "version": REGISTRY_VERSION,
        "plans": {k: plan_to_dict(p) for k, p in plans.items()},
    }
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_plan_registry(path) -> dict:
    """``{key: TconvPlan}`` from ``path``. Raises ``ValueError`` on another
    version or on a plan the port cannot run: silently dropping entries
    would turn a warm start into a surprise cold compile."""
    blob = json.loads(Path(path).read_text())
    if not isinstance(blob, dict) or blob.get("version") != REGISTRY_VERSION:
        raise ValueError(
            f"unsupported plan-registry version "
            f"{blob.get('version') if isinstance(blob, dict) else None!r} "
            f"(this build reads v{REGISTRY_VERSION})"
        )
    return {k: plan_from_dict(d) for k, d in blob.get("plans", {}).items()}
