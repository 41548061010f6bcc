"""Process-global tracer: nestable spans, counters, gauges, observations.
Mirrors ``repro/obs/trace.py``.

Everything the serving, training and autotune layers report flows through
one registry, a :class:`Tracer`, so a single export call
(:mod:`repro_torch.obs.export`) can emit a Chrome trace of every span and a
Prometheus text snapshot of every counter, gauge and percentile series.

**The disabled fast path is the design constraint.** Tracing is off by
default and the instrumented paths (engine dispatch, trainer step) are
hot, so the module-level helpers (:func:`span`, :func:`counter`,
:func:`gauge`, :func:`observe`, :func:`event`) check one module-level
boolean first and return at once when tracing is off: no lock, no
allocation, no device sync; :func:`span` hands back one shared no-op
context manager.

A span is a host interval. On the card a call of the main path replays one
CUDA graph, which a span cannot enter: the span wraps the replay on the
host, and ends where the path already synchronises (the host copy of a
served batch, the read-back of a training step's scalars). No span adds a
synchronise of its own.

Timestamps are monotonic-clock seconds (``time.monotonic`` by default;
injectable for fake-clock tests), the clock the serving engine schedules
with, so spans, request timelines and dispatch deadlines compare directly.

:class:`GcSpans` records each pass of Python's collector as a ``host.gc``
span while tracing is on; the serving replay and the training loop install
it for their own duration only.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time
from collections import deque

import numpy as np

# The module-level disable flag. Read directly (not via a function) by the
# hot-path helpers below; mutate only through enable()/disable().
_ENABLED = False


def percentiles(values) -> dict:
    """The port's one percentile summary: ``{p50, p95, p99, mean, max}``
    (all 0.0 when empty).

    Shared by ``ServeMetrics`` (request latency, expiry residence),
    :class:`repro_torch.timing.StepTimer` (training step walls) and the
    Prometheus exporter (observation series), so the numbers are
    comparable across subsystems.
    """
    if len(values) == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    a = np.asarray(values)
    return {
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
        "mean": float(a.mean()),
        "max": float(a.max()),
    }


class _NoopSpan:
    """The shared do-nothing span handed out when tracing is off (one
    module-level singleton: the disabled path allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: a context manager that records itself into its tracer
    on exit. ``set(k=v)`` attaches attributes mid-flight (e.g. the chosen
    replica, the packed bucket)."""

    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.depth = 0

    def set(self, **attrs) -> None:
        self.args.update(attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self.tracer.clock()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tracer._record_span(self, t1)
        return False


class _SpanLog:
    """The tracer's finished spans, oldest first, bounded at ``maxlen``.

    Each is kept as one flat tuple of plain values (the args' keys and
    values in turn after the five fields), which Python's collector stops
    tracking at its next pass, and read out as the span's dict (``name``,
    ``ts``, ``dur``, ``depth``, ``tid``, ``args``). Kept as dicts, a long
    trace's records stay tracked until a full pass, and each full pass
    walks them all: with spans on a whole serving window at 3,200 req/s on
    an H100, passes of 43-196 ms that backed the loop up."""

    __slots__ = ("_items",)

    def __init__(self, maxlen: int):
        self._items: deque = deque(maxlen=maxlen)

    def append(self, name: str, ts: float, dur: float, depth: int, tid: int,
               args: dict) -> None:
        self._items.append((name, ts, dur, depth, tid,
                            *itertools.chain.from_iterable(args.items())))

    @staticmethod
    def _read(item) -> dict:
        return {"name": item[0], "ts": item[1], "dur": item[2],
                "depth": item[3], "tid": item[4],
                "args": dict(zip(item[5::2], item[6::2]))}

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return map(self._read, self._items)

    def __getitem__(self, i: int) -> dict:
        return self._read(self._items[i])

    def names(self):
        return (item[0] for item in self._items)


class Tracer:
    """The span/counter/gauge/observation registry (see module docstring).

    Bounded: at most ``max_events`` finished spans + instant events are
    retained (oldest dropped first), and each observation series keeps at
    most ``max_observations`` samples — a long-running server cannot grow
    without limit. Counters and gauges are plain dicts.

    A :class:`Tracer` instance is always live; the on/off switch is the
    module-level flag the :func:`span`/:func:`counter`/... helpers check.
    Tests that want isolation construct their own instance and either call
    it directly or install it with :func:`set_tracer`.
    """

    def __init__(self, *, clock=time.monotonic, max_events: int = 100_000,
                 max_observations: int = 10_000):
        self.clock = clock
        self.max_events = int(max_events)
        self.max_observations = int(max_observations)
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.spans = _SpanLog(self.max_events)
        self.instants: deque = deque(maxlen=self.max_events)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.observations: dict[str, deque] = {}
        self._sinks: list = []
        self._local = threading.local()

    # ------------------------------------------------------------- spans

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def _record_span(self, sp: _Span, t1: float) -> None:
        self._append_span(sp.name, sp.t0, t1, sp.depth, sp.args)

    def _append_span(self, name: str, t0: float, t1: float, depth: int,
                     args: dict) -> None:
        tid = threading.get_ident()
        self.spans.append(name, t0, t1 - t0, depth, tid, args)
        if self._sinks:
            rec = {"name": name, "ts": t0, "dur": t1 - t0, "depth": depth,
                   "tid": tid, "args": args}
            for sink in self._sinks:
                sink("span", rec)

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        """A finished span from ``t0`` to ``t1`` (this tracer's clock),
        nested under the spans open now: an interval whose start was read
        where no ``with`` block could hold it (a collector pass)."""
        self._append_span(name, t0, t1, len(self._stack()), attrs)

    # --------------------------------------------- counters/gauges/series

    def counter(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        series = self.observations.get(name)
        if series is None:
            series = self.observations[name] = deque(
                maxlen=self.max_observations
            )
        series.append(float(value))

    def event(self, name: str, **attrs) -> None:
        """An instant (zero-duration) event with a timestamp."""
        rec = {
            "name": name,
            "ts": self.clock(),
            "tid": threading.get_ident(),
            "args": attrs,
        }
        self.instants.append(rec)
        for sink in self._sinks:
            sink("event", rec)

    # -------------------------------------------------------------- sinks

    def add_sink(self, fn) -> None:
        """Subscribe ``fn(kind, record)`` to every finished span and
        instant event (how the flight recorder shadows the tracer)."""
        self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        # equality, not identity: a bound method (e.g. FlightRecorder._sink)
        # is a fresh object at every attribute access, but compares equal
        self._sinks = [s for s in self._sinks if s != fn]

    # ---------------------------------------------------------- summaries

    def span_names(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name in self.spans.names():
            out[name] = out.get(name, 0) + 1
        return out

    def span_walls(self, name: str) -> list[float]:
        return [s["dur"] for s in self.spans if s["name"] == name]

    def summary(self) -> dict:
        return {
            "spans": len(self.spans),
            "instants": len(self.instants),
            "span_names": self.span_names(),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "observations": {
                k: percentiles(list(v)) for k, v in self.observations.items()
            },
        }


# The process-global tracer every module-level helper records into.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global registry; returns the
    previous one (tests swap in an isolated instance and restore it)."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class GcSpans:
    """A ``gc.callbacks`` hook that records each pass of Python's collector
    as a ``host.gc`` span (``generation``, ``collected``) into the
    process-global tracer, while tracing is on. :meth:`install` is
    idempotent and :meth:`remove` undoes it: a loop installs the hook at
    its first traced pass and removes it when it returns, so no collection
    outside that loop (another package's test, say) records a span.
    Installed while tracing, it records a zero-length ``host.gc.hook``
    span, so that a trace with no ``host.gc`` tells "no pass" from "no
    hook"."""

    __slots__ = ("installed", "_t0", "_hook")

    def __init__(self):
        self.installed = False
        self._t0 = None
        self._hook = self._callback   # one bound method, for remove()

    def install(self) -> None:
        if not self.installed:
            gc.callbacks.append(self._hook)
            self.installed = True
            if _ENABLED:
                t = _TRACER.clock()
                _TRACER.record("host.gc.hook", t, t)

    def remove(self) -> None:
        if self.installed:
            gc.callbacks.remove(self._hook)
            self.installed = False

    def _callback(self, phase: str, info: dict) -> None:
        if not _ENABLED:
            self._t0 = None
            return
        if phase == "start":
            self._t0 = _TRACER.clock()
        elif self._t0 is not None:
            _TRACER.record("host.gc", self._t0, _TRACER.clock(),
                           generation=info["generation"],
                           collected=info["collected"])
            self._t0 = None


# ------------------------------------------------------- hot-path helpers
# Each gates on the bare module flag FIRST and touches nothing else when
# tracing is off — the instrumented seams call these unconditionally.

def span(name: str, **attrs):
    """A nestable span context manager (no-op singleton when disabled)."""
    if not _ENABLED:
        return NOOP_SPAN
    return _TRACER.span(name, **attrs)


def counter(name: str, inc: float = 1.0) -> None:
    if not _ENABLED:
        return
    _TRACER.counter(name, inc)


def gauge(name: str, value: float) -> None:
    if not _ENABLED:
        return
    _TRACER.gauge(name, value)


def observe(name: str, value: float) -> None:
    if not _ENABLED:
        return
    _TRACER.observe(name, value)


def event(name: str, **attrs) -> None:
    if not _ENABLED:
        return
    _TRACER.event(name, **attrs)
