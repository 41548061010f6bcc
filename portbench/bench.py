"""The harness's data-driven core: find a cell's configuration, traffic mix,
limits and metrics by name, run the cell's driver, read every metric and
assemble the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry),
* ``traffic/<traffic>.json``: the mix, and the ``driver`` that runs it,
  ``drivers/<driver>.py``,
* ``limits/<cell>.json``: the limit of every number the cell compares,
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number, or None where it finds nothing to read,
* ``kernel_names/<family>/*.txt``: the kernel names a device metric counts.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One cell as run: its entries and files, and this run's settings."""

    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    metrics: list          # the BENCHMARK.json entries this cell reports
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: object = None
    t_start: float = 0.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, *, trace: bool, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files; its
    metrics are the end-to-end ones (``trace`` off) or the per-layer ones."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    metrics = [m for m in spec["per_layer" if trace else "end_to_end"]
               if reports(m, workload)]
    return Cell(name=workload, chips=w["chips"], cfg=load_json(root / conf["file"]),
                mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"),
                metrics=metrics, trace=trace)


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nearest_rank(values: list, q: float) -> float:
    """The ``q`` quantile by nearest rank (an infinite value ranks last)."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run(cell: Cell):
    """Run the cell's driver: its :class:`~portbench.drivers.common.Outcome`."""
    return driver(cell.mix["driver"]).run(cell)


def read_metrics(cell: Cell, outcome) -> dict:
    """``{name: {"value", "unit"}}`` of every metric the cell reports.
    ``BENCHMARK.json`` lists each metric's cells, so a metric that reads
    nothing in one of them (a kernel renamed outside ``kernel_names/``, a
    span gone) raises rather than leave the line."""
    out = {}
    for m in cell.metrics:
        value = reader(m["name"])(outcome.ctx)
        if value is None:
            raise RuntimeError(f"metric {m['name']} read nothing in {cell.name}, "
                               "one of the cells BENCHMARK.json says report it")
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} is {value} in {cell.name}: "
                               f"{outcome.ctx.failed} of {outcome.ctx.attempted} "
                               f"operations failed")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell: Cell, numbers: dict) -> tuple:
    """``(correct, checks)``: each compared number beside its limit; a
    number passes at or below its limit."""
    checks = {}
    for name, value in numbers.items():
        limit = cell.limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
