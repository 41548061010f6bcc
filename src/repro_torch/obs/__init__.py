"""Observability: structured tracing, per-request timelines, an autotune
audit trail and a flight recorder. Mirrors ``repro/obs``.

Dependency-free (stdlib and numpy) and disabled by default:

* :mod:`repro_torch.obs.trace` -- the process-global
  :class:`~repro_torch.obs.trace.Tracer`: nestable spans, monotonic
  timestamps, counters, gauges and observation series, and a no-op fast
  path (one module-level flag check, no lock, no allocation, no device
  sync) when tracing is off.
* :mod:`repro_torch.obs.timeline` -- per-request lifecycle timelines of
  the serving path (admit -> queue -> pack -> dispatch -> retry -> slice ->
  reply), joined to the serving conservation ledger.
* :mod:`repro_torch.obs.export` -- Chrome-trace/Perfetto JSON of spans and
  timelines, and Prometheus text of counters, gauges and percentiles.
* :mod:`repro_torch.obs.flight_recorder` -- a bounded ring of recent events
  dumped as JSON on a replica's death, a non-finite output, a NaN-guard
  skip, a crash or SIGTERM.
* :mod:`repro_torch.obs.audit` -- the autotune decision audit trail.

The span taxonomy, the timeline contract and the recorder's triggers are
listed in README.md ("Observability and replicas").
"""
from repro_torch.obs.audit import AuditTrail, get_trail, set_trail
from repro_torch.obs.export import (
    chrome_trace,
    parse_prometheus_text,
    prometheus_text,
    write_chrome_trace,
)
from repro_torch.obs.flight_recorder import FlightRecorder
from repro_torch.obs.timeline import TERMINAL_EVENTS, RequestTimeline, TimelineStore
from repro_torch.obs.trace import (
    Tracer,
    counter,
    disable,
    enable,
    enabled,
    event,
    gauge,
    get_tracer,
    observe,
    percentiles,
    set_tracer,
    span,
)

__all__ = [
    "AuditTrail", "FlightRecorder", "RequestTimeline", "TERMINAL_EVENTS",
    "TimelineStore", "Tracer", "chrome_trace", "counter", "disable",
    "enable", "enabled", "event", "gauge", "get_tracer", "get_trail",
    "observe", "parse_prometheus_text", "percentiles", "prometheus_text",
    "set_tracer", "set_trail", "span", "write_chrome_trace",
]
