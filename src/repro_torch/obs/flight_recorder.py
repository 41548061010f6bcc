"""Flight recorder: a bounded ring of recent events, dumped on a fault.
Mirrors ``repro/obs/flight_recorder.py``.

The :class:`FlightRecorder` keeps the last ``capacity`` events in a ring
buffer -- cheap to record into and independent of the tracing flag (a
component records into an attached recorder unconditionally; no recorder
attached costs nothing) -- and on a trigger writes one JSON artifact with
the trigger, the wall and monotonic timestamps and the full ring.

Trigger matrix (who calls :meth:`dump`, with what trigger string):

==========================  ==================================  =========
condition                   caller                              trigger
==========================  ==================================  =========
replica DEAD transition     ``ReplicaSupervisor._transition``   ``replica_dead:<rid>``
non-finite dispatch output  ``ReplicaSupervisor._execute``      ``nonfinite:<rid>``
NaN-guard skip (training)   ``GanTrainer.run``                  ``nan_guard``
``SimulatedCrash`` / crash  ``GanTrainer.run``                  ``crash:<ExcType>``
SIGTERM (training)          ``GanTrainer.run``                  ``sigterm``
==========================  ==================================  =========

Dumps are JSON files under ``dump_dir`` (else ``$REPRO_FLIGHT_DIR``, else
``./flight_dumps``) or at an explicit path; every dump path is appended to
:attr:`dumps`. The recorder can also shadow a
:class:`~repro_torch.obs.trace.Tracer` as a sink (:meth:`attach`).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque


class FlightRecorder:
    """Bounded event ring + JSON dump on trigger (see module docstring)."""

    def __init__(self, capacity: int = 2048, *, clock=time.monotonic,
                 dump_dir=None):
        self.capacity = int(capacity)
        self.clock = clock
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=self.capacity)
        self.dumps: list[str] = []
        self._seq = 0

    # ---------------------------------------------------------- recording

    def record(self, kind: str, **attrs) -> None:
        """Append one event to the ring. Always cheap (deque append); the
        oldest event falls off once ``capacity`` is exceeded."""
        self._ring.append({"t": self.clock(), "kind": kind, **attrs})

    def attach(self, tracer) -> None:
        """Shadow ``tracer``: every finished span / instant event it records
        is mirrored into the ring (kind ``trace.span`` / ``trace.event``)."""
        tracer.add_sink(self._sink)

    def detach(self, tracer) -> None:
        tracer.remove_sink(self._sink)

    def _sink(self, kind: str, rec: dict) -> None:
        self.record(f"trace.{kind}", name=rec["name"], ts=rec["ts"],
                    **({"dur": rec["dur"]} if "dur" in rec else {}))

    def snapshot(self) -> list[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    # ------------------------------------------------------------ dumping

    def _default_path(self, trigger: str) -> str:
        base = self.dump_dir or os.environ.get(
            "REPRO_FLIGHT_DIR", os.path.join(os.getcwd(), "flight_dumps")
        )
        os.makedirs(base, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in trigger)
        self._seq += 1
        return os.path.join(base, f"flight_{self._seq:03d}_{safe}.json")

    def dump(self, trigger: str, path=None, *, extra: dict | None = None
             ) -> str:
        """Write the ring to a JSON artifact and return its path.

        The artifact is ``{"trigger", "t_monotonic", "t_wall",
        "n_events", "events": [...], "extra": {...}}`` — ``t_wall`` is a
        human-readable UTC stamp for correlating dumps across processes;
        event timestamps stay monotonic (the clock the ring recorded
        with).
        """
        out_path = str(path) if path is not None else \
            self._default_path(trigger)
        blob = {
            "trigger": trigger,
            "t_monotonic": self.clock(),
            "t_wall": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "n_events": len(self._ring),
            "events": list(self._ring),
            "extra": extra or {},
        }
        with open(out_path, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True, default=str)
        self.dumps.append(out_path)
        return out_path

    @staticmethod
    def load(path) -> dict:
        with open(path) as f:
            return json.load(f)
