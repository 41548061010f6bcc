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

The edges a batch shares (``pack``, ``dispatch``, ``slice``, ``reply``)
are recorded once a batch (:meth:`TimelineStore.batch`): one record with
the batch's request ids and any per-request values, which each request's
timeline holds by reference and expands into its own event when read. A
timeline reads out the same events, in the same order, as if each edge had
been recorded request by request.
"""
from __future__ import annotations

from collections import deque

LIFECYCLE_EVENTS = (
    "admit", "queue", "pack", "dispatch", "retry", "slice",
    "reply", "expire", "reject", "fail",
)
TERMINAL_EVENTS = frozenset(("reply", "expire", "reject", "fail"))


class _BatchEdge:
    """One lifecycle edge shared by a batch's requests: ``per`` maps an
    attribute to its values in ``rids`` order, ``attrs`` are common."""

    __slots__ = ("name", "t", "rids", "per", "attrs", "_at")

    def __init__(self, name: str, t: float, rids, per: dict, attrs: dict):
        self.name = name
        self.t = t
        self.rids = rids
        self.per = per
        self.attrs = attrs
        self._at = None

    def expand(self, rid) -> dict:
        ev = {"event": self.name, "t": self.t}
        if self.per:
            if self._at is None:
                self._at = {r: i for i, r in enumerate(self.rids)}
            i = self._at[rid]
            for k, v in self.per.items():
                ev[k] = v[i]
        ev.update(self.attrs)
        return ev


class RequestTimeline:
    """One request's ordered event list (see module docstring)."""

    __slots__ = ("rid", "model", "_entries")

    def __init__(self, rid, model=None):
        self.rid = rid
        self.model = model
        # own events (dicts) and the batch edges it shares, in order
        self._entries: list = []

    @property
    def events(self) -> list[dict]:
        return [e if isinstance(e, dict) else e.expand(self.rid)
                for e in self._entries]

    def _names(self):
        return (e["event"] if isinstance(e, dict) else e.name
                for e in self._entries)

    def add(self, name: str, t: float, **attrs) -> dict:
        if name not in LIFECYCLE_EVENTS:
            raise ValueError(
                f"unknown timeline event {name!r}; valid: {LIFECYCLE_EVENTS}"
            )
        ev = {"event": name, "t": float(t), **attrs}
        self._entries.append(ev)
        return ev

    def has(self, name: str) -> bool:
        return any(n == name for n in self._names())

    @property
    def terminal_event(self) -> str | None:
        for n in reversed(list(self._names())):
            if n in TERMINAL_EVENTS:
                return n
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
        events = self.events
        first = {}
        for e in events:
            first.setdefault(e["event"], e["t"])
        last_t = events[-1]["t"] if events else None
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

    def batch(self, rids, name: str, t: float, *, model=None, per=None,
              **attrs) -> None:
        """One edge of every request in ``rids`` at ``t``, recorded once
        (see the module docstring): ``per`` maps an attribute to its values
        in ``rids`` order, ``attrs`` are the batch's. Each request's
        timeline reads it as :meth:`event` would have recorded it."""
        if name not in LIFECYCLE_EVENTS:
            raise ValueError(
                f"unknown timeline event {name!r}; valid: {LIFECYCLE_EVENTS}"
            )
        edge = _BatchEdge(name, float(t), rids, per or {}, attrs)
        active = self._active
        terminal = name in TERMINAL_EVENTS
        for rid in rids:
            tl = active.get(rid)
            if tl is None:
                tl = active[rid] = RequestTimeline(rid, model)
            elif model is not None and tl.model is None:
                tl.model = model
            tl._entries.append(edge)
            if terminal:
                del active[rid]
                self._done.append(tl)

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
