"""Port of the observability layer (repro_torch.obs), on the CPU.

The tests of ``tests/test_obs.py`` through the port's API: the tracer's
disabled fast path, spans, counters and sinks; request timelines and their
contract; the Chrome-trace and Prometheus exporters; the flight recorder;
the autotune audit trail, its CLI and the autotuner's race recording into
it; the engine's and the trainer's wiring; the shared percentile summary.

Then both packages on one event stream under one fake clock: equal
``summary()``, ``segments()``, Chrome trace (but for the exporter's name in
its metadata) and Prometheus text. The port's own: batch edges read out as
per-request events, the span log, the collector's ``host.gc`` spans and
their hook's ``host.gc.hook`` mark, and the trainer's ``train.launch``,
``train.readback`` and ``train.commit``.
"""
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import timeline as jtimeline
from repro.obs import trace as jtrace
from repro_torch.models import gan
from repro_torch.obs import trace as obs
from repro_torch.obs.audit import AuditTrail, audit_path
from repro_torch.obs.export import (
    chrome_trace,
    metric_name,
    parse_prometheus_text,
    prometheus_text,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.flight_recorder import FlightRecorder
from repro_torch.obs.timeline import RequestTimeline, TimelineStore
from repro_torch.obs.trace import NOOP_SPAN, GcSpans, Tracer, percentiles
from repro_torch.serve import BucketPolicy, GanEngine, GenRequest, QueueFull

TINY = gan.GANConfig("tiny", 8, ((4, 4, 4), (8, 4, 3)))
ROOT = Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _isolated(enabled: bool):
    tracer = Tracer()
    prev = obs.set_tracer(tracer)
    was = obs.enabled()
    (obs.enable if enabled else obs.disable)()
    return tracer, prev, was


def _restore(prev, was):
    obs.set_tracer(prev)
    (obs.enable if was else obs.disable)()


@pytest.fixture
def iso_tracer():
    """An isolated enabled tracer installed as the process global;
    restores the previous tracer and flag afterwards."""
    tracer, prev, was = _isolated(True)
    yield tracer
    _restore(prev, was)


@pytest.fixture
def iso_disabled():
    """An isolated tracer with tracing forced off (the fast-path tests)."""
    tracer, prev, was = _isolated(False)
    yield tracer
    _restore(prev, was)


# ------------------------------------------------------------------ tracer


def test_percentiles_summary_and_empty():
    p = percentiles([1.0, 2.0, 3.0, 4.0])
    assert p["p50"] == 2.5 and p["max"] == 4.0 and p["mean"] == 2.5
    empty = percentiles([])
    assert set(empty) == {"p50", "p95", "p99", "mean", "max"}
    assert all(v == 0.0 for v in empty.values())


def test_span_nesting_records_depth_and_duration():
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("outer", model="tiny"):
        clock.advance(1.0)
        with tr.span("inner") as sp:
            sp.set(bucket=4)
            clock.advance(0.5)
    assert [s["name"] for s in tr.spans] == ["inner", "outer"]
    inner, outer = tr.spans
    assert inner["depth"] == 1 and outer["depth"] == 0
    assert inner["dur"] == 0.5 and outer["dur"] == 1.5
    assert inner["args"]["bucket"] == 4
    assert outer["args"]["model"] == "tiny"
    assert tr.span_names() == {"inner": 1, "outer": 1}
    assert tr.span_walls("outer") == [1.5]


def test_span_exception_tagged_and_propagated():
    tr = Tracer(clock=FakeClock())
    with pytest.raises(RuntimeError):
        with tr.span("doomed"):
            raise RuntimeError("boom")
    assert tr.spans[0]["args"]["error"] == "RuntimeError"


def test_counters_gauges_observations_bounded():
    tr = Tracer(max_observations=4)
    tr.counter("hits")
    tr.counter("hits", 2.0)
    tr.gauge("depth", 7)
    for i in range(10):
        tr.observe("wall_s", float(i))
    assert tr.counters["hits"] == 3.0
    assert tr.gauges["depth"] == 7.0
    assert list(tr.observations["wall_s"]) == [6.0, 7.0, 8.0, 9.0]
    s = tr.summary()
    assert s["counters"]["hits"] == 3.0
    assert s["observations"]["wall_s"]["max"] == 9.0


def test_event_ring_bounded():
    tr = Tracer(clock=FakeClock(), max_events=3)
    for i in range(5):
        tr.event("tick", i=i)
    assert [e["args"]["i"] for e in tr.instants] == [2, 3, 4]


def test_sink_sees_spans_and_events_until_removed():
    tr = Tracer(clock=FakeClock())
    seen = []
    tr.add_sink(lambda kind, rec: seen.append((kind, rec["name"])))
    with tr.span("s"):
        pass
    tr.event("e")
    assert seen == [("span", "s"), ("event", "e")]
    tr.remove_sink(tr._sinks[0])
    tr.event("after")
    assert len(seen) == 2


def test_disabled_helpers_record_nothing(iso_disabled):
    assert obs.span("x") is NOOP_SPAN       # the shared no-op singleton
    with obs.span("x", a=1) as sp:
        sp.set(b=2)                          # no-op, no error
    obs.counter("c")
    obs.gauge("g", 1.0)
    obs.observe("o", 1.0)
    obs.event("e")
    assert len(iso_disabled.spans) == 0
    assert len(iso_disabled.instants) == 0
    assert not iso_disabled.counters
    assert not iso_disabled.gauges
    assert not iso_disabled.observations


def test_disabled_span_fast_path_cost(iso_disabled):
    """The disabled path is one flag check and a shared singleton: 100k
    span entries far under a millisecond each (a loose absolute bound that
    pins 'no lock, no allocation', not a benchmark)."""
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("hot", a=1):
            pass
    wall = time.perf_counter() - t0
    assert wall < 1.0, f"disabled span path too slow: {wall:.3f}s / {n}"


def test_enabled_helpers_hit_installed_tracer(iso_tracer):
    with obs.span("top", who="test"):
        obs.counter("n")
        obs.observe("w", 0.25)
        obs.event("mark", k=1)
    assert iso_tracer.span_names() == {"top": 1}
    assert iso_tracer.counters["n"] == 1.0
    assert list(iso_tracer.observations["w"]) == [0.25]
    assert iso_tracer.instants[0]["args"]["k"] == 1



def test_record_nests_an_interval_under_the_open_spans():
    clock = FakeClock(1.0)
    tr = Tracer(clock=clock)
    with tr.span("outer"):
        clock.advance(0.5)
        tr.record("host.gc", 1.1, 1.3, generation=2, collected=7)
    gcs, outer = tr.spans
    assert gcs == {"name": "host.gc", "ts": 1.1, "dur": pytest.approx(0.2),
                   "depth": 1, "tid": outer["tid"],
                   "args": {"generation": 2, "collected": 7}}
    assert outer["depth"] == 0


def test_span_log_reads_out_dicts_and_is_left_untracked():
    """Finished spans read out as dicts, oldest first, bounded; they are
    kept as tuples of plain values, which a collector pass stops tracking,
    so a long trace adds nothing to later full passes."""
    clock = FakeClock(2.0)
    tr = Tracer(clock=clock, max_events=3)
    for i in range(5):
        with tr.span("s", i=i, rids=(i, i + 1)):
            clock.advance(0.5)
    assert len(tr.spans) == 3
    assert [s["args"] for s in tr.spans] == [{"i": i, "rids": (i, i + 1)}
                                             for i in (2, 3, 4)]
    assert tr.spans[0] == {"name": "s", "ts": 3.0, "dur": 0.5, "depth": 0,
                           "tid": tr.spans[0]["tid"], "args": {"i": 2, "rids": (2, 3)}}
    assert tr.span_names() == {"s": 3} and tr.span_walls("s") == [0.5] * 3
    gc.collect()
    gc.collect()            # a tuple valued arg goes first, its record next
    assert not any(gc.is_tracked(item) for item in tr.spans._items)


def test_gc_spans_record_only_while_installed_and_tracing(iso_tracer):
    hook = GcSpans()
    before = list(gc.callbacks)
    clock = iso_tracer.clock
    gc.collect()                                    # not installed
    t_on = clock()
    hook.install()
    hook.install()                                  # idempotent
    assert len(gc.callbacks) == len(before) + 1
    with obs.span("outer"):
        gc.collect()
    t_off = clock()
    obs.disable()
    gc.collect()                                    # installed, tracing off
    obs.enable()
    t_on2 = clock()
    hook.remove()
    hook.remove()
    t_off2 = clock()
    assert gc.callbacks == before
    gc.collect()                                    # removed
    passes = [s for s in iso_tracer.spans if s["name"] == "host.gc"]
    outer = next(s for s in iso_tracer.spans if s["name"] == "outer")
    assert any(s["args"]["generation"] == 2 and s["depth"] == 1
               and outer["ts"] <= s["ts"] <= s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]
               for s in passes)
    assert all(t_on <= s["ts"] <= t_off or t_on2 <= s["ts"] <= t_off2 for s in passes)
    assert all(s["args"]["collected"] >= 0 for s in passes)
    # one zero-length mark, at the install that took effect
    marks = [s for s in iso_tracer.spans if s["name"] == "host.gc.hook"]
    assert len(marks) == 1 and marks[0]["dur"] == 0.0 and t_on <= marks[0]["ts"] <= t_off


def test_gc_spans_mark_only_an_install_made_while_tracing(iso_tracer):
    hook = GcSpans()
    obs.disable()
    hook.install()
    obs.enable()
    try:
        gc.collect()
    finally:
        hook.remove()
    names = iso_tracer.span_names()
    assert "host.gc.hook" not in names and names.get("host.gc", 0) >= 1


# ---------------------------------------------------------------- timeline


def test_timeline_rejects_unknown_event():
    tl = RequestTimeline(0)
    with pytest.raises(ValueError, match="unknown timeline event"):
        tl.add("teleport", 0.0)


def test_timeline_completeness_contract():
    served = RequestTimeline(1)
    served.add("admit", 0.0)
    assert not served.complete                 # no terminal yet
    served.add("reply", 1.0)
    assert served.complete and served.terminal_event == "reply"

    rejected = RequestTimeline(2)
    rejected.add("reject", 0.0)
    assert rejected.complete                   # a bare reject is complete

    orphan = RequestTimeline(3)
    orphan.add("reply", 1.0)                   # terminal without admit
    assert not orphan.complete


def test_timeline_segments_decompose_wall():
    tl = RequestTimeline(0, model="tiny")
    tl.add("admit", 1.0)
    tl.add("pack", 1.25, bucket=4)
    tl.add("dispatch", 1.35)
    tl.add("slice", 1.85)
    tl.add("reply", 1.9)
    seg = tl.segments()
    assert seg["queue_s"] == 0.25
    assert seg["dispatch_s"] == pytest.approx(0.1)
    assert seg["execute_s"] == 0.5
    assert seg["total_s"] == pytest.approx(0.9)
    d = tl.to_dict()
    assert d["terminal"] == "reply" and d["complete"] and d["model"] == "tiny"


def test_store_moves_terminal_to_done_and_bounds_ring():
    store = TimelineStore(capacity=3)
    store.event(0, "admit", 0.0, model="tiny")
    assert store.active == 1 and len(store) == 1
    store.event(0, "reply", 1.0)
    assert store.active == 0 and len(store) == 1
    assert store.get(0).complete
    for rid in range(1, 6):                    # overflow the done ring
        store.event(rid, "admit", float(rid))
        store.event(rid, "reply", float(rid) + 0.5)
    assert len(store) == 3                     # oldest dropped
    assert store.get(0) is None
    assert store.get(5) is not None
    assert store.terminal_counts()["reply"] == 3


def test_store_incomplete_lists_contract_violators():
    store = TimelineStore()
    store.event(0, "admit", 0.0)
    store.event(1, "admit", 0.0)
    store.event(1, "reply", 1.0)
    assert [tl.rid for tl in store.incomplete()] == [0]


def test_reconcile_against_conservation_ledger():
    store = TimelineStore()
    store.event(0, "admit", 0.0)
    store.event(0, "reply", 1.0)
    store.event(1, "admit", 0.0)
    store.event(1, "expire", 2.0)
    store.event("reject#1", "reject", 0.5)
    ledger = {"done": 1, "expired": 1, "rejected": 1, "failed": 0,
              "malformed": 0}
    rec = store.reconcile(ledger)
    assert rec["ok"] and not rec["mismatches"]
    rec = store.reconcile({**ledger, "done": 2})
    assert not rec["ok"]
    assert rec["mismatches"]["reply"] == {"timeline": 1, "ledger": 2}


# --------------------------------------------------------------- exporters


def _toy_tracer(tracer_cls=Tracer):
    clock = FakeClock(100.0)
    tr = tracer_cls(clock=clock)
    with tr.span("serve.dispatch", bucket=4):
        clock.advance(0.002)
    tr.event("replica.transition", old="HEALTHY", new="SUSPECT")
    tr.counter("serve.admitted", 5)
    tr.gauge("serve.queue_depth", 2)
    for v in (0.001, 0.002, 0.004):
        tr.observe("serve.latency_s", v)
    return tr


def test_chrome_trace_structure_and_rebased_timestamps(tmp_path):
    tr = _toy_tracer()
    store = TimelineStore()
    store.event(7, "admit", 100.0005, model="tiny")
    store.event(7, "reply", 100.003)
    blob = chrome_trace(tr, timeline=store)
    assert validate_chrome_trace(blob) == []
    events = blob["traceEvents"]
    assert min(e["ts"] for e in events) == 0.0          # rebased
    assert events == sorted(events, key=lambda e: e["ts"])
    assert {e["ph"] for e in events} == {"X", "i", "C"}
    x = next(e for e in events if e["ph"] == "X")
    assert x["dur"] == pytest.approx(2000.0)            # 2 ms in us
    tl_events = [e for e in events if "tiny#7" in e["name"]]
    assert {e["name"].split()[0] for e in tl_events} == {"admit", "reply"}
    assert all(e["pid"] == 2 for e in tl_events)
    assert blob["metadata"]["exporter"] == "repro_torch.obs"

    path = tmp_path / "trace.json"
    write_chrome_trace(tr, path, timeline=store)
    loaded = json.loads(path.read_text())
    assert validate_chrome_trace(loaded) == []
    assert len(loaded["traceEvents"]) == len(events)


def test_validate_chrome_trace_flags_malformed():
    assert validate_chrome_trace({}) == ["missing traceEvents"]
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1,
                            "tid": 1}]}
    assert any("missing dur" in p for p in validate_chrome_trace(bad))
    missing = {"traceEvents": [{"ph": "i", "ts": 0, "pid": 1, "tid": 1}]}
    assert any("missing 'name'" in p for p in validate_chrome_trace(missing))


def test_metric_name_sanitized():
    assert metric_name("serve.latency_s") == "serve_latency_s"
    assert metric_name("9lives") == "_9lives"
    assert metric_name("ok_name") == "ok_name"


def test_prometheus_text_round_trips():
    text = prometheus_text(_toy_tracer(), extra_gauges={"serve.extra": 1.5})
    parsed = parse_prometheus_text(text)
    m, t = parsed["metrics"], parsed["types"]
    assert m["serve_admitted"] == 5.0
    assert t["serve_admitted"] == "counter"
    assert m["serve_queue_depth"] == 2.0
    assert m["serve_extra"] == 1.5
    assert t["serve_latency_s"] == "summary"
    assert m[("serve_latency_s", 'quantile="0.5"')] == pytest.approx(0.002)
    assert m["serve_latency_s_sum"] == pytest.approx(0.007)
    assert m["serve_latency_s_count"] == 3


def test_parse_prometheus_rejects_malformed_lines():
    with pytest.raises(ValueError, match="malformed sample"):
        parse_prometheus_text("not a metric line at all\n")
    with pytest.raises(ValueError, match="malformed comment"):
        parse_prometheus_text("# HELLO\n")


# --------------------------------------------------------- flight recorder


def test_recorder_ring_bounded_and_snapshot():
    rec = FlightRecorder(capacity=3, clock=FakeClock())
    for i in range(5):
        rec.record("tick", i=i)
    assert len(rec) == 3
    assert [e["i"] for e in rec.snapshot()] == [2, 3, 4]


def test_recorder_dump_writes_artifact(tmp_path):
    rec = FlightRecorder(capacity=8, clock=FakeClock(5.0),
                         dump_dir=str(tmp_path))
    rec.record("train.step", step=3)
    path = rec.dump("nan_guard", extra={"step": 3})
    assert rec.dumps == [path]
    blob = FlightRecorder.load(path)
    assert blob["trigger"] == "nan_guard"
    assert blob["n_events"] == 1
    assert blob["events"][0]["kind"] == "train.step"
    assert blob["extra"] == {"step": 3}
    assert Path(path).name == "flight_001_nan_guard.json"
    p2 = rec.dump("replica_dead:r0")             # separators made safe
    assert Path(p2).name == "flight_002_replica_dead_r0.json"


def test_recorder_default_dir_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path / "env"))
    path = FlightRecorder(clock=FakeClock()).dump("sigterm")
    assert Path(path).parent == tmp_path / "env"
    monkeypatch.delenv("REPRO_FLIGHT_DIR")
    monkeypatch.chdir(tmp_path)
    path = FlightRecorder(clock=FakeClock()).dump("sigterm")
    assert Path(path).parent == tmp_path / "flight_dumps"


def test_recorder_shadows_tracer_when_attached():
    tr = Tracer(clock=FakeClock())
    rec = FlightRecorder(clock=FakeClock())
    rec.attach(tr)
    with tr.span("s"):
        pass
    tr.event("e")
    assert [e["kind"] for e in rec.snapshot()] == ["trace.span", "trace.event"]
    rec.detach(tr)
    tr.event("after")
    assert len(rec) == 2


# ------------------------------------------------------------- audit trail


def test_audit_path_resolution(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_AUDIT", "/x/audit.jsonl")
    assert audit_path() == "/x/audit.jsonl"
    monkeypatch.delenv("REPRO_AUTOTUNE_AUDIT")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/y/cache.json")
    assert audit_path() == "/y/cache.audit.jsonl"


def test_audit_default_path_is_the_ports_own(monkeypatch):
    """With neither variable set the port appends under its own cache
    directory, never the reference's, so card and TPU records stay apart."""
    monkeypatch.delenv("REPRO_AUTOTUNE_AUDIT", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    from repro.obs.audit import audit_path as jaudit_path

    path = audit_path()
    assert path.endswith(os.path.join(".cache", "repro_torch",
                                      "autotune.audit.jsonl"))
    assert path != jaudit_path()


def test_audit_record_margin_and_candidate_forms():
    trail = AuditTrail(path=None)
    entry = {"method": "unified", "time_s": 1.0, "source": "measured",
             "candidates": {"unified": 1.0, "conventional": 1.3}, "bm": 8}
    rec = trail.record_decision(kind="layer", key="k1", direction="fwd",
                                entry=entry, backend="cpu")
    assert rec["winner"] == "unified"
    assert rec["margin"] == pytest.approx(1.3)
    assert [c["method"] for c in rec["candidates"]] == [
        "unified", "conventional"]
    assert rec["tiles"] == {"bm": 8}
    nested = {"method": "gemm", "time_s": 0.5,
              "candidates": {"gemm": {"8x8": 0.5, "16x16": 0.7},
                             "lax": 0.6}}
    rec2 = trail.record_decision(kind="layer", key="k2", direction="bwd",
                                 entry=nested)
    assert rec2["candidates"][0] == {"method": "gemm", "time_s": 0.5}
    assert rec2["margin"] == pytest.approx(1.2)
    solo = trail.record_decision(
        kind="pair", key="k3", direction="pair",
        entry={"method": "only", "time_s": 1.0,
               "candidates": {"only": 1.0}})
    assert solo["margin"] is None


def test_audit_persists_jsonl_and_queries(tmp_path, monkeypatch):
    audit = tmp_path / "audit.jsonl"
    monkeypatch.setenv("REPRO_AUTOTUNE_AUDIT", str(audit))
    trail = AuditTrail(path="auto", capacity=2)
    for i, d in enumerate(("fwd", "bwd", "fwd")):
        trail.record_decision(
            kind="layer", key=f"layer{i}", direction=d,
            entry={"method": "m", "time_s": 1.0, "candidates": {"m": 1.0}})
    assert len(trail.records) == 2                # the ring is bounded
    assert len(AuditTrail.load(audit)) == 3       # the JSONL keeps all
    assert [r["key"] for r in trail.query(direction="fwd")] == ["layer2"]
    assert [r["key"] for r in trail.query(key="layer1")] == ["layer1"]
    assert len(trail.query(last=1)) == 1
    trail.record_decision(
        kind="layer", key="ephemeral", direction="step",
        entry={"method": "m", "time_s": 1.0}, persist=False)
    assert len(AuditTrail.load(audit)) == 3


def test_autotune_race_records_audit_decision(tmp_path, monkeypatch):
    from repro_torch.kernels.autotune import tune_layer
    from repro_torch.obs.audit import set_trail

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    trail = AuditTrail(path=None)
    prev = set_trail(trail)
    try:
        tune_layer(1, 4, 4, 2, 3, 1, methods=("conventional", "unified_reshape"),
                   repeats=1, warmup=0, persist=False, device="cpu")
    finally:
        set_trail(prev)
    assert len(trail.records) == 1
    rec = trail.records[0]
    assert rec["kind"] == "layer" and rec["direction"] == "fwd"
    assert rec["backend"] == "torch_cpu" and rec["key"].startswith("torch_cpu|")
    assert rec["winner"] in ("conventional", "unified_reshape")
    assert len(rec["candidates"]) == 2
    assert rec["margin"] is not None and rec["margin"] >= 1.0
    assert not (tmp_path / "autotune.json").exists()   # persist=False


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", *args],
        capture_output=True, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120,
    )


def test_audit_cli_queries_jsonl(tmp_path):
    audit = tmp_path / "audit.jsonl"
    trail = AuditTrail(path=str(audit))
    trail.record_decision(
        kind="layer", key="tcup L1", direction="fwd",
        entry={"method": "unified", "time_s": 0.001,
               "candidates": {"unified": 0.001, "conventional": 0.002}})
    out = _cli("audit", "--path", str(audit), "--direction", "fwd", "--json")
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert len(rows) == 1 and rows[0]["winner"] == "unified"


def test_flight_and_trace_cli_read_artifacts(tmp_path):
    rec = FlightRecorder(clock=FakeClock(), dump_dir=str(tmp_path))
    rec.record("replica.transition", replica="r0")
    dump = rec.dump("replica_dead:r0")
    out = _cli("flight", dump)
    assert out.returncode == 0, out.stderr
    assert "replica_dead:r0" in out.stdout
    trace = tmp_path / "trace.json"
    write_chrome_trace(_toy_tracer(), trace)
    out = _cli("trace", str(trace), "--json")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["spans_by_name"] == {"serve.dispatch": 1}
    trace.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert _cli("trace", str(trace)).returncode == 1


# --------------------------------------------------------- serving wiring


@pytest.fixture(scope="module")
def tiny_engine_parts():
    return TINY, gan.generator_init(torch.Generator().manual_seed(0), TINY,
                                    device="cpu")


def _engine(cfg, params, **policy_kw):
    policy_kw.setdefault("buckets", (1, 2, 4))
    policy_kw.setdefault("max_wait_s", 0.0)
    policy_kw.setdefault("max_queue", 64)
    eng = GanEngine(BucketPolicy(**policy_kw), device="cpu")
    eng.register(cfg, params, name="tiny")
    return eng


def _burst(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [GenRequest("tiny",
                       rng.standard_normal((1, cfg.z_dim)).astype(np.float32))
            for _ in range(n)]


def test_engine_disabled_records_no_timelines(tiny_engine_parts, iso_disabled):
    cfg, params = tiny_engine_parts
    eng = _engine(cfg, params)
    reqs = _burst(cfg, 4)
    eng.serve(reqs)
    assert all(r.done for r in reqs)
    assert len(eng.timeline) == 0
    assert len(iso_disabled.spans) == 0
    assert not iso_disabled.counters


def test_engine_enabled_timelines_complete_and_reconcile(
        tiny_engine_parts, iso_tracer):
    cfg, params = tiny_engine_parts
    eng = _engine(cfg, params)
    reqs = _burst(cfg, 6)
    eng.serve(reqs)
    tls = eng.timeline.timelines()
    assert len(tls) == 6
    assert all(tl.complete and tl.terminal_event == "reply" for tl in tls)
    assert eng.timeline.incomplete() == []
    rec = eng.timeline.reconcile(eng.metrics.conservation())
    assert rec["ok"], rec
    for tl in tls:
        seg = tl.segments()
        assert seg["total_s"] >= 0.0 and "execute_s" in seg
    names = iso_tracer.span_names()
    for expected in ("serve.pack", "serve.dispatch", "serve.slice"):
        assert names.get(expected, 0) >= 1, names
    assert iso_tracer.counters["serve.admitted"] == 6.0
    assert iso_tracer.counters["serve.completed"] == 6.0


def test_engine_reject_timeline_synthetic_rid(tiny_engine_parts, iso_tracer):
    cfg, params = tiny_engine_parts
    eng = _engine(cfg, params, buckets=(1, 2), max_queue=2)
    shed = 0
    for r in _burst(cfg, 4, seed=3):      # 2 admitted, then backpressure
        try:
            eng.submit(r)
        except QueueFull:
            shed += 1
    while eng.step(drain=True):
        pass
    assert shed >= 1 and eng.metrics.rejected == shed
    rejects = [tl for tl in eng.timeline.timelines()
               if tl.terminal_event == "reject"]
    assert len(rejects) == eng.metrics.rejected
    assert all(tl.complete for tl in rejects)
    assert all(str(tl.rid).startswith("reject#") for tl in rejects)
    rec = eng.timeline.reconcile(eng.metrics.conservation())
    assert rec["ok"], rec


def test_serve_metrics_publish_idempotent(tiny_engine_parts, iso_tracer):
    cfg, params = tiny_engine_parts
    eng = _engine(cfg, params)
    eng.serve(_burst(cfg, 3))
    eng.metrics.publish(iso_tracer)
    first = dict(iso_tracer.gauges)
    n_lat = len(iso_tracer.observations.get("serve.latency_s", ()))
    eng.metrics.publish(iso_tracer)       # re-publish must not double
    assert iso_tracer.gauges == first
    assert len(iso_tracer.observations["serve.latency_s"]) == n_lat
    parsed = parse_prometheus_text(prometheus_text(iso_tracer))
    assert parsed["metrics"]["serve_requests_total"] == 3.0


def test_transition_log_bounded_edge_counts_exact():
    from repro_torch.serve.metrics import TRANSITION_LOG_CAP, ServeMetrics

    m = ServeMetrics()
    for i in range(TRANSITION_LOG_CAP + 50):
        m.record_transition(float(i), "r0", "HEALTHY", "SUSPECT", "probe")
    assert len(m.transitions) == TRANSITION_LOG_CAP       # ring bounded
    assert m.transition_counts["HEALTHY->SUSPECT"] == (
        TRANSITION_LOG_CAP + 50)                          # counts exact
    assert m.transitions[-1]["t"] == float(TRANSITION_LOG_CAP + 49)


def test_probe_log_stamped_with_backoff_deadline():
    from repro_torch.serve.metrics import ServeMetrics

    m = ServeMetrics()
    m.record_probe(False, now=10.0, replica="r0", state="DEAD",
                   backoff_s=0.2, next_probe_at=10.2)
    assert m.probes == 1 and m.probe_failures == 1
    entry = m.probe_log[-1]
    assert entry["replica"] == "r0" and entry["ok"] is False
    assert entry["t"] == 10.0
    assert entry["backoff_s"] == 0.2
    assert entry["next_probe_at"] == 10.2


# -------------------------------------------------------- training wiring


def _tiny_trainer(**kwargs):
    from repro_torch.data import SyntheticImages
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    data = SyntheticImages(hw=TINY.out_hw(TINY.layers[-1][0]),
                           channels=TINY.layers[-1][2], global_batch=2,
                           device="cpu")
    wrap = kwargs.pop("wrap", None)
    return GanTrainer(TINY, GanTrainerConfig(global_batch=2),
                      wrap(data) if wrap else data, log_fn=lambda *a: None,
                      device="cpu", **kwargs)


def test_trainer_steps_emit_spans_and_observations(iso_tracer):
    tr = _tiny_trainer()
    tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=2)
    names = iso_tracer.span_names()
    assert names.get("train.step") == 2
    assert names.get("train.batch") == 2
    assert names.get("train.step_fn") == 2
    assert iso_tracer.counters["train.steps"] == 2.0
    assert len(iso_tracer.observations["train.step_s"]) == 2


class _CollectAt:
    """A step hook that runs a full collection at one step."""

    def __init__(self, step):
        self.step, self.hooked = step, []

    def on_step_start(self, step):
        if step == self.step:
            self.hooked.append(len(gc.callbacks))
            gc.collect()


def test_trainer_step_fn_splits_into_child_spans(iso_tracer):
    before = list(gc.callbacks)
    hook = _CollectAt(1)
    tr = _tiny_trainer(hooks=hook)
    tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=3)
    spans = sorted(iso_tracer.spans, key=lambda s: (s["ts"], s["depth"]))
    step_fns = [s for s in spans if s["name"] == "train.step_fn"]
    assert len(step_fns) == 3
    for sf in step_fns:
        kids = [s for s in spans if s["name"] != "host.gc"
                and sf["ts"] <= s["ts"] <= s["ts"] + s["dur"] <= sf["ts"] + sf["dur"]
                and s["depth"] == sf["depth"] + 1]
        assert [s["name"] for s in kids] == ["train.launch", "train.readback",
                                             "train.commit"]
    # the collector's hook lives for the run alone, its pass under the step
    assert hook.hooked == [len(before) + 1] and gc.callbacks == before
    from repro_torch.train.gan_trainer import PORT_SPANS

    assert ({s["name"] for s in spans} - {"train.step", "train.batch", "train.step_fn"}
            == PORT_SPANS)
    assert any(s["name"] == "host.gc" and s["args"]["generation"] == 2
               and s["depth"] == 1 for s in spans)


def test_trainer_nan_guard_dumps_flight_recorder(tmp_path, iso_tracer):
    from repro_torch.train.fault_injection import FaultInjector, FaultPlan

    inj = FaultInjector(FaultPlan(nan_at_steps=(0,)))
    rec = FlightRecorder(dump_dir=str(tmp_path))
    tr = _tiny_trainer(wrap=lambda d: inj.wrap_data(d, accum=1), hooks=inj,
                       recorder=rec)
    tr.run(tr.init_state(torch.Generator().manual_seed(1)), steps=2)
    assert tr.skipped_steps == 1
    assert iso_tracer.counters["train.skipped_steps"] == 1.0
    assert len(rec.dumps) == 1
    blob = FlightRecorder.load(rec.dumps[0])
    assert blob["trigger"] == "nan_guard"
    assert blob["extra"]["skipped_total"] == 1
    assert any(e["kind"] == "train.step" for e in blob["events"])


def test_trainer_crash_dumps_flight_recorder(tmp_path):
    from repro_torch.train.fault_injection import (
        FaultInjector,
        FaultPlan,
        SimulatedCrash,
    )

    rec = FlightRecorder(dump_dir=str(tmp_path))
    tr = _tiny_trainer(hooks=FaultInjector(FaultPlan(kill_at_step=1)),
                       recorder=rec)
    with pytest.raises(SimulatedCrash):
        tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=4)
    assert len(rec.dumps) == 1
    assert FlightRecorder.load(rec.dumps[0])["trigger"] == "crash:SimulatedCrash"


def test_trainer_sigterm_dumps_after_its_checkpoint(tmp_path):
    from repro_torch.train.fault_injection import FaultInjector, FaultPlan

    rec = FlightRecorder(dump_dir=str(tmp_path / "dumps"))
    tr = _tiny_trainer(hooks=FaultInjector(FaultPlan(sigterm_at_step=1)),
                       recorder=rec, ckpt_dir=tmp_path / "ckpt")
    tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=4)
    assert tr.stopped
    blob = FlightRecorder.load(rec.dumps[-1])
    assert blob["trigger"] == "sigterm" and blob["extra"] == {"step": 2}


# ------------------------------------------------------------- step timer


def test_step_timer_percentiles_shared_summary():
    from repro_torch.timing import StepTimer

    st = StepTimer()
    st.steps = [10.0, 1.0, 2.0, 3.0]    # the first step is warm-up, skipped
    assert st.mean(skip=1) == 2.0
    assert st.median(skip=1) == 2.0
    p = st.percentiles(skip=1)
    assert p["max"] == 3.0 and p["mean"] == 2.0
    assert set(p) == {"p50", "p95", "p99", "mean", "max"}
    assert st.percentiles(skip=99)["max"] == 10.0


# ------------------------------------------------ both packages, one stream


def _feed(trace_mod, timeline_mod):
    """One fake-clock event stream into a package's Tracer and
    TimelineStore."""
    clock = FakeClock(50.0)
    tr = trace_mod.Tracer(clock=clock)
    store = timeline_mod.TimelineStore(capacity=4)
    for rid in range(6):
        store.event(rid, "admit", clock(), model="m", n=1 + rid % 3)
        store.event(rid, "queue", clock(), depth=rid)
        with tr.span("serve.pack", bucket=4, reqs=2):
            clock.advance(1e-4 * (rid + 1))
        store.event(rid, "pack", clock(), bucket=4, n_real=3)
        with tr.span("serve.dispatch", model="m", bucket=4):
            store.event(rid, "dispatch", clock(), replica=f"r{rid % 2}")
            if rid == 2:
                store.event(rid, "retry", clock(), reason="timeout", attempt=1)
                tr.event("replica.transition", replica="r0", old="HEALTHY",
                         new="SUSPECT", reason="timeout")
            with tr.span("replica.execute", replica=f"r{rid % 2}"):
                clock.advance(3e-4)
        store.event(rid, "slice", clock(), rows=1)
        store.event(rid, "expire" if rid == 4 else "reply", clock())
        tr.counter("serve.admitted")
        tr.observe("serve.batch_wall_s", 4e-4 + 1e-5 * rid)
        tr.gauge("serve.queue_depth", 6 - rid)
    store.event("reject#1", "reject", clock(), model="m")
    store.event(9, "admit", clock(), model="m")
    return tr, store


def _stream(store, batched):
    """One serving stream into ``store``: the edges a batch shares per
    request, or once a batch (``batched``), with per-request retries and
    terminals between them and timelines touched first by a batch edge."""
    def edge(rids, name, t, model=None, per=None, **attrs):
        if batched:
            store.batch(rids, name, t, model=model, per=per, **attrs)
            return
        for i, rid in enumerate(rids):
            own = {k: v[i] for k, v in (per or {}).items()}
            store.event(rid, name, t, model=model, **own, **attrs)

    t = 10.0
    for b in range(4):
        rids = [3 * b, 3 * b + 1, 3 * b + 2]
        for rid in rids[1:] if b == 1 else rids:    # rid 3: admitted unseen
            store.event(rid, "admit", t, model="m", n=1 + rid % 2, deadline_s=None)
            store.event(rid, "queue", t, depth=rid, queued_samples=2 * rid)
        t += 0.001
        edge(rids, "pack", t, model="m", bucket=4, n_real=3)
        edge(rids, "dispatch", t, model="m", bucket=4)
        if b == 2:
            store.event(rids[0], "retry", t, model="m", reason="timeout", attempt=1)
            store.event(rids[1], "fail", t, model="m", reason="timeout", retries=3)
            rids = [rids[0], rids[2]]
            edge(rids, "pack", t, model="m", bucket=2, n_real=2)
            edge(rids, "dispatch", t, model="m", bucket=2)
        t += 0.002
        edge(rids, "slice", t, model="m", per={"rows": [1 + r % 2 for r in rids]})
        edge(rids, "reply", t, model="m",
             per={"latency_s": [0.003 + r * 1e-4 for r in rids]}, replica=None)
    store.event("reject#1", "reject", t, model="m", n=1)
    store.event(99, "admit", t, model="m")
    edge([99], "pack", t, model="m", bucket=1, n_real=1)


def test_batched_edges_read_out_the_per_request_events():
    from repro_torch.obs import export

    stores = []
    for batched in (False, True):
        store = TimelineStore(capacity=6)
        _stream(store, batched)
        stores.append(store)
    per, batch = stores
    assert len(per) == len(batch) == 7 and per.active == batch.active == 1

    def read(store):
        return [(tl.rid, tl.model, tl.events, tl.segments(), tl.to_dict(),
                 tl.terminal_event, tl.complete, tl.has("retry"))
                for tl in store.timelines()]

    assert read(batch) == read(per)
    assert batch.get(10).events == per.get(10).events and batch.get(1) is None
    assert [tl.rid for tl in batch.incomplete()] == [tl.rid for tl in per.incomplete()]
    assert batch.terminal_counts() == per.terminal_counts()
    ledger = {"done": 5, "expired": 0, "failed": 1, "rejected": 1}
    assert batch.reconcile(ledger) == per.reconcile(ledger)
    tr = Tracer(clock=FakeClock())
    assert (export.chrome_trace(tr, timeline=batch)
            == export.chrome_trace(tr, timeline=per))
    with pytest.raises(ValueError):
        batch.batch([1], "bogus", 0.0)


def test_one_stream_gives_both_packages_the_same_records():
    from repro_torch.obs import export, timeline

    tr, store = _feed(obs, timeline)
    jtr, jstore = _feed(jtrace, jtimeline)
    assert tr.summary() == jtr.summary()
    assert ([(tl.rid, tl.segments(), tl.to_dict()) for tl in store.timelines()]
            == [(tl.rid, tl.segments(), tl.to_dict())
                for tl in jstore.timelines()])
    assert store.terminal_counts() == jstore.terminal_counts()
    ledger = {"done": 3, "expired": 1, "rejected": 1, "failed": 0}
    assert store.reconcile(ledger) == jstore.reconcile(ledger)
    blob = export.chrome_trace(tr, timeline=store)
    jblob = jexport.chrome_trace(jtr, timeline=jstore)
    assert blob["metadata"].pop("exporter") == "repro_torch.obs"
    assert jblob["metadata"].pop("exporter") == "repro.obs"
    assert blob == jblob
    assert export.prometheus_text(tr) == jexport.prometheus_text(jtr)
    assert (export.parse_prometheus_text(export.prometheus_text(tr))
            == jexport.parse_prometheus_text(jexport.prometheus_text(jtr)))
