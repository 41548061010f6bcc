"""``python -m repro_torch.obs`` -- inspect observability artifacts.
Mirrors ``repro/obs/__main__.py``.

Subcommands:

* ``audit``  -- query the autotune decision audit trail (JSONL):
  ``python -m repro_torch.obs audit [--path P] [--key SUBSTR]
  [--direction fwd|bwd|step|pair] [--last N] [--json]``
* ``flight`` -- summarize a flight-recorder dump:
  ``python -m repro_torch.obs flight DUMP.json [--json]``
* ``trace``  -- validate and summarize a Chrome-trace export:
  ``python -m repro_torch.obs trace TRACE.json [--json]``
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.audit import AuditTrail, audit_path
from repro_torch.obs.export import validate_chrome_trace
from repro_torch.obs.flight_recorder import FlightRecorder


def _cmd_audit(ns) -> int:
    path = ns.path or audit_path()
    if not os.path.exists(path):
        print(f"no audit trail at {path}", file=sys.stderr)
        return 1
    records = AuditTrail.load(path)
    records = [
        r for r in records
        if (ns.key is None or ns.key in r.get("key", ""))
        and (ns.direction is None or r.get("direction") == ns.direction)
    ]
    if ns.last is not None:
        records = records[-ns.last:]
    if ns.json:
        print(json.dumps(records, indent=1, sort_keys=True))
        return 0
    print(f"{len(records)} decision(s) from {path}")
    for r in records:
        margin = r.get("margin")
        margin_s = f"{margin:.2f}x" if margin else "n/a"
        n_cand = len(r.get("candidates") or [])
        print(
            f"  [{r.get('t_wall', '?')}] {r.get('kind')}/"
            f"{r.get('direction')} {r.get('key')}\n"
            f"      winner={r.get('winner')} time_s={r.get('time_s')} "
            f"source={r.get('source')} candidates={n_cand} "
            f"margin={margin_s}"
        )
    return 0


def _cmd_flight(ns) -> int:
    blob = FlightRecorder.load(ns.dump)
    if ns.json:
        print(json.dumps(blob, indent=1, sort_keys=True))
        return 0
    events = blob.get("events", [])
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e.get("kind", "?")] = kinds.get(e.get("kind", "?"), 0) + 1
    print(f"trigger: {blob.get('trigger')}  at {blob.get('t_wall')}")
    print(f"events:  {len(events)}")
    for kind in sorted(kinds):
        print(f"  {kind}: {kinds[kind]}")
    if events:
        span = events[-1].get("t", 0.0) - events[0].get("t", 0.0)
        print(f"window:  {span:.3f}s of recent history")
    return 0


def _cmd_trace(ns) -> int:
    with open(ns.trace) as f:
        blob = json.load(f)
    problems = validate_chrome_trace(blob)
    events = blob.get("traceEvents", [])
    names: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "X":
            names[e["name"]] = names.get(e["name"], 0) + 1
    if ns.json:
        print(json.dumps({"events": len(events), "spans_by_name": names,
                          "problems": problems}, indent=1, sort_keys=True))
        return 1 if problems else 0
    print(f"{ns.trace}: {len(events)} events"
          + ("" if not problems else f", {len(problems)} PROBLEMS"))
    for name in sorted(names):
        print(f"  {name}: {names[name]}")
    for p in problems:
        print(f"  PROBLEM: {p}")
    return 1 if problems else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect observability artifacts.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_audit = sub.add_parser("audit", help="query the autotune audit trail")
    p_audit.add_argument("--path", default=None,
                         help="audit JSONL (default: resolved audit_path())")
    p_audit.add_argument("--key", default=None,
                         help="substring filter on the cache key")
    p_audit.add_argument("--direction", default=None,
                         choices=("fwd", "bwd", "step", "pair"))
    p_audit.add_argument("--last", type=int, default=None,
                         help="only the N most recent records")
    p_audit.add_argument("--json", action="store_true")
    p_audit.set_defaults(fn=_cmd_audit)

    p_flight = sub.add_parser("flight", help="summarize a flight dump")
    p_flight.add_argument("dump")
    p_flight.add_argument("--json", action="store_true")
    p_flight.set_defaults(fn=_cmd_flight)

    p_trace = sub.add_parser("trace", help="validate a Chrome trace")
    p_trace.add_argument("trace")
    p_trace.add_argument("--json", action="store_true")
    p_trace.set_defaults(fn=_cmd_trace)

    ns = parser.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
