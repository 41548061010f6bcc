"""Exporters: Chrome-trace/Perfetto JSON and Prometheus text exposition.
Mirrors ``repro/obs/export.py``.

Two render targets for the one :class:`~repro_torch.obs.trace.Tracer`
registry:

* :func:`chrome_trace` -- the Trace Event Format ``{"traceEvents": [...]}``
  that ``chrome://tracing`` and Perfetto load. Spans become ``"X"``
  (complete) events, instants ``"i"``, counters one final ``"C"`` sample,
  and request timelines (when passed) ``"i"`` events on a per-request
  track, so one artifact shows the engine's span tree and every request's
  lifecycle on one time axis. Timestamps are microseconds from the
  earliest event.
* :func:`prometheus_text` -- the text exposition format, one metric per
  line: counters (``# TYPE _ counter``), gauges (``gauge``) and each
  observation series as a ``summary`` (``{quantile="0.5|0.95|0.99"}`` plus
  ``_sum``/``_count``). Names are sanitized to the metric charset
  (``[a-zA-Z_:][a-zA-Z0-9_:]*``); :func:`parse_prometheus_text` is the
  line-by-line inverse.

Both are pure functions of the tracer's state: export never mutates.
"""
from __future__ import annotations

import json
import re

from repro_torch.obs.trace import Tracer, percentiles

_METRIC_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_METRIC_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
# one exposition line: name{labels} value
_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)

_SPAN_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def metric_name(name: str) -> str:
    """Sanitize an internal name (``serve.latency_s``) to the Prometheus
    metric charset (``serve_latency_s``)."""
    name = _METRIC_BAD_CHARS.sub("_", name)
    if not _METRIC_OK.match(name):
        name = "_" + name
    return name


# ------------------------------------------------------------ chrome trace

def _base_ts(tracer: Tracer, timeline=None) -> float:
    t0 = None
    for rec in list(tracer.spans) + list(tracer.instants):
        t0 = rec["ts"] if t0 is None else min(t0, rec["ts"])
    if timeline is not None:
        for tl in timeline.timelines():
            for e in tl.events:
                t0 = e["t"] if t0 is None else min(t0, e["t"])
    return t0 or 0.0


def _json_args(args: dict) -> dict:
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else str(v)) for k, v in args.items()}


def chrome_trace(tracer: Tracer, *, timeline=None, pid: int = 1) -> dict:
    """The Trace Event Format dict (see module docstring). ``timeline`` is
    an optional :class:`~repro_torch.obs.timeline.TimelineStore`; its events are
    emitted as instants on one track per request (tid = request id hash),
    named ``"<event> <model>#<rid>"``."""
    t0 = _base_ts(tracer, timeline)
    events = []
    for s in tracer.spans:
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": (s["ts"] - t0) * 1e6,
            "dur": s["dur"] * 1e6,
            "pid": pid,
            "tid": s["tid"] % 100_000,
            "args": _json_args(s["args"]),
        })
    for i in tracer.instants:
        events.append({
            "name": i["name"],
            "ph": "i",
            "s": "t",
            "ts": (i["ts"] - t0) * 1e6,
            "pid": pid,
            "tid": i["tid"] % 100_000,
            "args": _json_args(i["args"]),
        })
    for name, value in sorted(tracer.counters.items()):
        events.append({
            "name": name,
            "ph": "C",
            "ts": 0.0,
            "pid": pid,
            "tid": 0,
            "args": {"value": value},
        })
    if timeline is not None:
        for tl in timeline.timelines():
            tid = abs(hash(tl.rid)) % 100_000
            label = f"{tl.model or 'request'}#{tl.rid}"
            for e in tl.events:
                args = {k: v for k, v in e.items() if k not in ("event", "t")}
                events.append({
                    "name": f"{e['event']} {label}",
                    "ph": "i",
                    "s": "t",
                    "ts": (e["t"] - t0) * 1e6,
                    "pid": pid + 1,
                    "tid": tid,
                    "args": _json_args(args),
                })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"exporter": "repro_torch.obs", "clock": "monotonic-rebased"},
    }


def write_chrome_trace(tracer: Tracer, path, *, timeline=None) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    blob = chrome_trace(tracer, timeline=timeline)
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
    return str(path)


def validate_chrome_trace(blob: dict) -> list[str]:
    """Structural check of a Trace Event dict: returns
    problem strings, empty when the artifact is loadable and every event
    carries the required keys."""
    bad = []
    if not isinstance(blob, dict) or "traceEvents" not in blob:
        return ["missing traceEvents"]
    for i, e in enumerate(blob["traceEvents"]):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in e:
                bad.append(f"event {i} missing {key!r}")
        if e.get("ph") == "X" and "dur" not in e:
            bad.append(f"complete event {i} ({e.get('name')}) missing dur")
    return bad


# -------------------------------------------------------------- prometheus

def _fmt(value: float) -> str:
    return repr(float(value))


def prometheus_text(tracer: Tracer, *, extra_gauges: dict | None = None
                    ) -> str:
    """Text exposition of the registry (see module docstring).

    ``extra_gauges`` lets a caller fold one-off values (e.g. a
    ``ServeMetrics`` summary flattened by
    :meth:`~repro_torch.serve.metrics.ServeMetrics.publish`) into the same
    snapshot without first mutating the tracer.
    """
    lines = []
    for name, value in sorted(tracer.counters.items()):
        m = metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(value)}")
    gauges = dict(tracer.gauges)
    if extra_gauges:
        gauges.update(extra_gauges)
    for name, value in sorted(gauges.items()):
        m = metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(value)}")
    for name, series in sorted(tracer.observations.items()):
        m = metric_name(name)
        vals = list(series)
        p = percentiles(vals)
        lines.append(f"# TYPE {m} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{m}{{quantile="{q}"}} {_fmt(p[key])}')
        lines.append(f"{m}_sum {_fmt(sum(vals))}")
        lines.append(f"{m}_count {len(vals)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Line-by-line parse of :func:`prometheus_text` output. Returns
    ``{"metrics": {name: value} | {(name, labels): value}, "types":
    {name: type}}``; raises ``ValueError`` on any malformed line (the
    exporter-validity tests lean on the strictness)."""
    metrics: dict = {}
    types: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                continue
            raise ValueError(f"line {lineno}: malformed comment {line!r}")
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        key = (m["name"], m["labels"]) if m["labels"] else m["name"]
        metrics[key] = float(m["value"])
    return {"metrics": metrics, "types": types}
