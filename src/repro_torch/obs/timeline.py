"""Per-request lifecycle timelines for the serving path. Mirrors
``repro/obs/timeline.py``.

Every :class:`~repro_torch.serve.gan_engine.GenRequest` state edge becomes
one timestamped event, so a slow request is attributable: admit -> pack is
queue wait, pack -> dispatch is batch formation, dispatch -> slice is the
executable's wall (on the card: the copy of the latents in, the graph's
replay and the host copy of the output), slice -> reply is the handoff.
The event vocabulary follows the engine's state machine:

  admit     accepted into a model queue (``GanEngine.submit``)
  queue     queue position/depth at admission (same instant as admit)
  pack      packed into a bucket (bucket size, real rows)
  dispatch  handed to an executable (replica id when supervised)
  retry     a dispatch attempt failed and the request was requeued
  slice     its rows sliced out of the batch output
  reply     terminal: served (completion latency attached)
  expire    terminal: deadline passed while queued
  reject    terminal: refused at admission (backpressure)
  fail      terminal: admitted but terminally unservable

**The timeline contract** joins the serving conservation ledger: every
admitted request reaches exactly one terminal event, so a drained engine
shows one complete timeline (``admit`` and a terminal event) per admitted
request. :meth:`TimelineStore.incomplete` lists violators and
:meth:`TimelineStore.reconcile` checks the terminal-event counts against
``ServeMetrics.conservation()``.

The engine records only while tracing is enabled
(:func:`repro_torch.obs.trace.enabled`), so the disabled path stays one
flag check. The store is bounded: completed timelines beyond ``capacity``
are dropped oldest first (the counts survive in ``ServeMetrics``).
"""
from __future__ import annotations

from collections import deque

LIFECYCLE_EVENTS = (
    "admit", "queue", "pack", "dispatch", "retry", "slice",
    "reply", "expire", "reject", "fail",
)
TERMINAL_EVENTS = frozenset(("reply", "expire", "reject", "fail"))


class RequestTimeline:
    """One request's ordered event list (see module docstring)."""

    __slots__ = ("rid", "model", "events")

    def __init__(self, rid, model=None):
        self.rid = rid
        self.model = model
        self.events: list[dict] = []

    def add(self, name: str, t: float, **attrs) -> dict:
        if name not in LIFECYCLE_EVENTS:
            raise ValueError(
                f"unknown timeline event {name!r}; valid: {LIFECYCLE_EVENTS}"
            )
        ev = {"event": name, "t": float(t), **attrs}
        self.events.append(ev)
        return ev

    def has(self, name: str) -> bool:
        return any(e["event"] == name for e in self.events)

    @property
    def terminal_event(self) -> str | None:
        for e in reversed(self.events):
            if e["event"] in TERMINAL_EVENTS:
                return e["event"]
        return None

    @property
    def complete(self) -> bool:
        """The timeline contract: an admitted request's timeline is
        complete when it has an ``admit`` event and a terminal event; a
        rejected request's is complete with the bare ``reject``."""
        term = self.terminal_event
        if term == "reject":
            return True
        return term is not None and self.has("admit")

    def segments(self) -> dict:
        """Wall-time decomposition between consecutive lifecycle stages:
        ``{"queue_s": admit->first pack, "dispatch_s": pack->dispatch,
        "execute_s": dispatch->slice, "total_s": admit->terminal}`` —
        missing stages are omitted."""
        first = {}
        for e in self.events:
            first.setdefault(e["event"], e["t"])
        last_t = self.events[-1]["t"] if self.events else None
        out = {}
        if "admit" in first and "pack" in first:
            out["queue_s"] = first["pack"] - first["admit"]
        if "pack" in first and "dispatch" in first:
            out["dispatch_s"] = first["dispatch"] - first["pack"]
        if "dispatch" in first and "slice" in first:
            out["execute_s"] = first["slice"] - first["dispatch"]
        if "admit" in first and last_t is not None:
            out["total_s"] = last_t - first["admit"]
        return out

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "model": self.model,
            "terminal": self.terminal_event,
            "complete": self.complete,
            "events": list(self.events),
        }


class TimelineStore:
    """Bounded per-request timeline registry (active + recently completed).

    ``event(rid, name, t, ...)`` routes to the request's timeline,
    creating it on first touch; a terminal event moves the timeline from
    the active map to the bounded completed ring. ``rid`` is the engine's
    request id; synthetic ids (e.g. ``"reject#3"`` for requests refused
    before an id was assigned) are fine — the store does not interpret
    them.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._active: dict = {}
        self._done: deque = deque(maxlen=self.capacity)

    def event(self, rid, name: str, t: float, *, model=None,
              **attrs) -> RequestTimeline:
        tl = self._active.get(rid)
        if tl is None:
            tl = self._active[rid] = RequestTimeline(rid, model)
        elif model is not None and tl.model is None:
            tl.model = model
        tl.add(name, t, **attrs)
        if name in TERMINAL_EVENTS:
            self._active.pop(rid, None)
            self._done.append(tl)
        return tl

    def get(self, rid) -> RequestTimeline | None:
        tl = self._active.get(rid)
        if tl is not None:
            return tl
        for done in reversed(self._done):
            if done.rid == rid:
                return done
        return None

    def timelines(self) -> list[RequestTimeline]:
        """Every retained timeline, completed first (oldest first), then
        still-active ones."""
        return list(self._done) + list(self._active.values())

    def __len__(self) -> int:
        return len(self._done) + len(self._active)

    @property
    def active(self) -> int:
        return len(self._active)

    def incomplete(self) -> list[RequestTimeline]:
        """Timelines violating the contract: active ones (no terminal yet)
        and completed ones missing their ``admit`` edge."""
        bad = [tl for tl in self._done if not tl.complete]
        bad.extend(self._active.values())
        return bad

    def terminal_counts(self) -> dict:
        counts = {k: 0 for k in sorted(TERMINAL_EVENTS)}
        for tl in self._done:
            term = tl.terminal_event
            if term is not None:
                counts[term] += 1
        return counts

    def reconcile(self, conservation: dict) -> dict:
        """Cross-check terminal-event counts against the serving
        conservation ledger (``ServeMetrics.conservation()``). ``ok`` is
        True iff every ledger terminal count matches the timeline count —
        the "every terminal state has a timeline" invariant. Only valid
        when the store's capacity exceeded nothing (``dropped`` timelines
        make the counts under-read; the caller sizes the store for the
        run it is checking)."""
        counts = self.terminal_counts()
        expect = {
            "reply": conservation.get("done", 0),
            "expire": conservation.get("expired", 0),
            "fail": conservation.get("failed", 0)
            + conservation.get("malformed", 0),
            "reject": conservation.get("rejected", 0),
        }
        mismatches = {
            k: {"timeline": counts[k], "ledger": v}
            for k, v in expect.items() if counts[k] != v
        }
        return {"ok": not mismatches, "mismatches": mismatches,
                "timeline": counts, "ledger": expect}
