"""The readers of the program's nested spans, on synthetic spans and a
synthetic profile: the innermost-span split of the device's idle time, the
serving loop's admission lag, the dispatch's parts, the collector's pauses
and the trainer's host idle a step."""
import pytest

import portbench_cpu_cells  # noqa: F401  (puts the repo on sys.path)
from portbench import bench, devtrace
from portbench.drivers import common
from portbench.host_spans import innermost


def _span(name, ts, dur, depth=0, **args):
    return {"name": name, "ts": ts, "dur": dur, "depth": depth, "tid": 1, "args": args}


def _ctx(kind, spans, ops=(), t0=0.0, t1=10.0, profiled=None):
    p = devtrace.Profile()
    p.t0, p.t1, p.ops = t0, t1, list(ops)
    return common.Ctx(kind=kind, gan=None, setup_s=1.0, window_s=t1 - t0, peak_bytes=0,
                      attempted=1, failed=0, spans=spans, profile=p, profiled=profiled)


# one served batch: a step holds pack, dispatch (launch, sync, copy out), slice
BATCH = [
    _span("serve.step", 1.0, 5.0),
    _span("serve.pack", 1.5, 0.5, 1, rids=[0, 1]),
    _span("serve.dispatch", 2.0, 3.0, 1, n_real=2),
    _span("serve.launch", 2.0, 0.5, 2),
    _span("serve.sync", 2.5, 1.5, 2),
    _span("serve.copy_out", 4.0, 1.0, 2),
    _span("serve.slice", 5.0, 0.5, 1),
]


def test_innermost_gives_each_instant_to_the_deepest_open_span():
    # the tracer records a span when it ends: children before their parent
    spans = sorted(BATCH, key=lambda s: s["ts"] + s["dur"]) + [
        _span("serve.wait", 7.0, 1.0), _span("host.gc", 7.5, 0.25, 1)]
    assert innermost(spans) == [
        ("serve.step", 1.0, 1.5), ("serve.pack", 1.5, 2.0), ("serve.launch", 2.0, 2.5),
        ("serve.sync", 2.5, 4.0), ("serve.copy_out", 4.0, 5.0), ("serve.slice", 5.0, 5.5),
        ("serve.step", 5.5, 6.0), ("serve.wait", 7.0, 7.5), ("host.gc", 7.5, 7.75),
        ("serve.wait", 7.75, 8.0)]


def test_unattributed_idle_is_what_no_span_covers():
    read = bench.reader("device_idle_unattributed.serve")
    # busy [3, 4]: idle 9 s, of which the spans cover [1, 3] and [4, 6]
    ctx = _ctx("serve", BATCH, ops=[("k", 3.0, 4.0)])
    assert read(ctx) == pytest.approx(100.0 * 5.0 / 9.0)
    ctx.spans = BATCH + [_span("serve.wait", 0.0, 1.0), _span("serve.wait", 6.0, 4.0)]
    assert read(ctx) == pytest.approx(0.0)
    assert read(_ctx("serve", [], ops=[("k", 3.0, 4.0)])) is None
    assert read(_ctx("serve", BATCH)) is None          # no device operation traced
    assert read(_ctx("train", BATCH, ops=[("k", 3.0, 4.0)])) is None


def test_train_host_idle_is_the_trainers_idle_a_step():
    read = bench.reader("train_host_idle_ms")
    spans = [_span("train.step", 0.0, 4.0), _span("train.batch", 0.0, 1.0, 1),
             _span("train.step_fn", 1.0, 3.0, 1), _span("train.launch", 1.0, 0.5, 2),
             _span("train.readback", 1.5, 2.0, 2), _span("train.commit", 3.5, 0.5, 2)]
    # busy [1.2, 3.4] and [5, 10]: idle 1.2 + 0.6 (under spans) + 1.6 (none)
    ctx = _ctx("train", spans, ops=[("k", 1.2, 3.4), ("k", 5.0, 10.0)], profiled=2)
    assert read(ctx) == pytest.approx(1e3 * 1.8 / 2)
    ctx.profiled = 0
    assert read(ctx) is None
    assert read(_ctx("serve", spans, ops=[("k", 1.2, 3.4)], profiled=2)) is None


def test_host_gc_is_collector_time_a_second_and_zero_without_a_pass():
    read = bench.reader("host_gc_ms.serve")
    hooked = BATCH + [_span("host.gc.hook", 0.5, 0.0)]
    assert read(_ctx("serve", hooked)) == 0.0
    spans = hooked + [_span("host.gc", 2.0, 0.25, 3, generation=2, collected=9),
                      _span("host.gc", 9.9, 0.25, 0, generation=0, collected=0)]
    assert read(_ctx("serve", spans)) == pytest.approx(1e3 * 0.25 / 10.0)
    # no hook (a program without one): nothing measured, not no collector time
    assert read(_ctx("serve", BATCH)) is None
    assert read(_ctx("serve", spans[:-3] + spans[-2:])) is None
    assert read(_ctx("serve", [])) is None
    assert read(_ctx("train", spans)) is None


def test_admit_lag_is_the_mean_over_admitted_requests():
    read = bench.reader("serve_admit_lag_ms")
    spans = [_span("serve.admit", 1.0, 0.1, n=3, refused=0, lag_s=0.006, lag_max_s=0.003),
             _span("serve.admit", 2.0, 0.1, n=1, refused=1, lag_s=0.002, lag_max_s=0.002),
             _span("serve.admit", 2.5, 0.1, n=0, refused=1, lag_s=0.0, lag_max_s=0.0),
             _span("serve.admit", 11.0, 0.1, n=5, refused=0, lag_s=1.0, lag_max_s=0.5)]
    assert read(_ctx("serve", spans)) == pytest.approx(2.0)
    assert read(_ctx("serve", BATCH)) is None


@pytest.mark.parametrize("name,span", [("serve_launch_ms", "serve.launch"),
                                       ("serve_copy_out_ms", "serve.copy_out")])
def test_dispatch_parts_are_mean_walls_in_the_sub_window(name, span):
    read = bench.reader(name)
    spans = [_span(span, 1.0, 0.002), _span(span, 2.0, 0.004), _span(span, 9.999, 0.004)]
    assert read(_ctx("serve", spans)) == pytest.approx(3.0)
    assert read(_ctx("serve", BATCH[:3])) is None
