"""Autotune decision audit trail: why did the race pick that kernel?
Mirrors ``repro/obs/audit.py``.

The autotune cache stores only the winner per key. The
:class:`AuditTrail` keeps one decision record per race:

``{t_wall, kind, key, direction, winner, time_s, source, candidates:
[{method, time_s}...], proxy, tiles, margin}``

``margin`` is ``runner_up_time / winner_time`` (>= 1.0; near 1.0 flags a
coin-flip decision worth racing again), ``None`` with fewer than two
measured candidates.

Records go to a bounded in-memory ring and, when a path is configured and
the decision is persistent, are appended as JSONL: ``$REPRO_AUTOTUNE_AUDIT``
names the file, else it derives from ``$REPRO_AUTOTUNE_CACHE``
(``<cache>.audit.jsonl``), else ``~/.cache/repro_torch/autotune.audit.jsonl``
-- a directory of the port's own, so the card's records never mix with the
reference's. Query with ``python -m repro_torch.obs audit [--key SUBSTR]
[--direction fwd]``.

:mod:`repro_torch.kernels.autotune` appends one record per race here
(ROADMAP's "The autotuner" item); an entry's ``summation_order``, which the
port records where the reference records tiles, lands under ``tiles``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque


def audit_path() -> str:
    """Where persistent decision records append (see module docstring)."""
    env = os.environ.get("REPRO_AUTOTUNE_AUDIT")
    if env:
        return env
    cache = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if cache:
        root, _ = os.path.splitext(cache)
        return root + ".audit.jsonl"
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.audit.jsonl"
    )


def _normalize_candidates(candidates) -> list[dict]:
    """The autotune cache stores candidates as ``{method: time_s}`` (tile
    variants occasionally make the value a nested dict); normalize to
    ``[{"method", "time_s"}, ...]`` sorted fastest-first."""
    out = []
    if isinstance(candidates, dict):
        items = candidates.items()
    else:
        items = [(c.get("method"), c.get("time_s"))
                 for c in (candidates or [])]
    for method, t in items:
        if isinstance(t, dict):   # nested per-tile times: best one stands in
            vals = [v for v in t.values() if isinstance(v, (int, float))]
            t = min(vals) if vals else None
        if isinstance(t, (int, float)):
            out.append({"method": str(method), "time_s": float(t)})
    out.sort(key=lambda c: c["time_s"])
    return out


def _margin(candidates: list[dict]) -> float | None:
    times = [c["time_s"] for c in candidates if c["time_s"] > 0]
    if len(times) < 2:
        return None
    return times[1] / times[0]


class AuditTrail:
    """Bounded in-memory decision ring + optional JSONL appender.

    ``path`` controls persistence: an explicit path appends there,
    ``"auto"`` resolves :func:`audit_path` at each write (so env-var
    changes — e.g. a test pointing ``$REPRO_AUTOTUNE_CACHE`` at a tmpdir
    — always take effect), ``None`` disables the JSONL side entirely.
    """

    def __init__(self, path="auto", capacity: int = 1024):
        self.path = path
        self.capacity = int(capacity)
        self.records: deque = deque(maxlen=self.capacity)

    def _resolved_path(self):
        return audit_path() if self.path == "auto" else self.path

    def record_decision(self, *, kind: str, key: str, direction: str,
                        entry: dict, backend=None, persist: bool = True
                        ) -> dict:
        """Capture one race outcome. ``entry`` is the autotune cache entry
        (winner ``method``/``time_s``/``source``/``candidates``/``proxy``
        plus tile keys); ``kind`` is ``"layer"`` or ``"pair"``; ``persist``
        mirrors the cache's own persist flag so ephemeral races (training
        step tuning with ``persist=False``) stay in-memory only."""
        candidates = _normalize_candidates(entry.get("candidates"))
        tiles = {k: v for k, v in entry.items()
                 if k.startswith(("bm", "bn", "bk", "tile", "cin", "mid",
                                  "cout", "summation"))}
        rec = {
            "t_wall": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "kind": kind,
            "key": key,
            "direction": direction,
            "backend": backend,
            "winner": entry.get("method"),
            "time_s": entry.get("time_s"),
            "source": entry.get("source", "measured"),
            "candidates": candidates,
            "proxy": entry.get("proxy"),
            "tiles": tiles,
            "margin": _margin(candidates),
        }
        self.records.append(rec)
        path = self._resolved_path() if persist else None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def query(self, *, key: str | None = None, direction: str | None = None,
              last: int | None = None) -> list[dict]:
        """Filter the in-memory ring: ``key`` is a substring match on the
        cache key, ``direction`` exact, ``last`` keeps the N most recent."""
        out = [
            r for r in self.records
            if (key is None or key in r["key"])
            and (direction is None or r["direction"] == direction)
        ]
        if last is not None:
            out = out[-last:]
        return out

    @staticmethod
    def load(path) -> list[dict]:
        """Parse a JSONL audit file; skips blank lines, raises on corrupt
        records (an audit file that cannot be trusted should fail loud)."""
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        return records


# The process-global trail an autotuner records into. Path mode "auto":
# every persistent write re-resolves audit_path(), so env monkeypatches
# are honored; set_trail() swaps in isolated instances for tests.
_TRAIL = AuditTrail(path="auto")


def get_trail() -> AuditTrail:
    return _TRAIL


def set_trail(trail: AuditTrail) -> AuditTrail:
    global _TRAIL
    prev, _TRAIL = _TRAIL, trail
    return prev
