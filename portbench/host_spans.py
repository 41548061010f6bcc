"""The program's nested spans as the host's innermost activity: each
instant belongs to the innermost span open then, so a span's share is its
self time. The split of the device's idle time over them reuses
:meth:`portbench.devtrace.Profile.idle_by_host`."""
from __future__ import annotations


def innermost(spans: list) -> list:
    """``(name, start, end)`` intervals, sorted and not overlapping, of the
    innermost open span at each instant of ``spans`` (the tracer's records:
    ``name``, ``ts``, ``dur``, ``depth``; one thread)."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s["ts"], s["depth"])):
        a = s["ts"]
        while stack and stack[-1][1] <= a:
            name, b = stack.pop()
            if b > t:
                out.append((name, t, b))
                t = b
        if stack and a > t:
            out.append((stack[-1][0], t, a))
        t = a if t is None else max(t, a)
        stack.append((s["name"], a + s["dur"]))
    while stack:
        name, b = stack.pop()
        if b > t:
            out.append((name, t, b))
            t = b
    return out


def idle_split(ctx) -> dict | None:
    """``{name: seconds}`` of the device's idle time in the profiled
    sub-window under each span's self time, and ``host.other`` where no
    span was open; None where the run has no profile or no spans."""
    p = ctx.profile
    if p is None or p.t1 is None or not p.ops or not ctx.spans:
        return None
    flat = innermost(ctx.spans)
    return dict(p.idle_by_host(flat, k=len(flat) + 1))


def in_window(ctx, name: str) -> list:
    """The spans ``name`` that lie wholly in the profiled sub-window (all of
    them where the run has no profile)."""
    p = ctx.profile
    out = [s for s in ctx.spans if s["name"] == name]
    if p is None or p.t1 is None:
        return out
    return [s for s in out if s["ts"] >= p.t0 and s["ts"] + s["dur"] <= p.t1]
