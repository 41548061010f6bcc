"""Port of the plan-served GAN engine (repro_torch.serve), on the CPU.

Parity: the port's engine against the JAX engine on the same weights,
latents and policy, fp32 within rtol = atol = 1e-5 (the JAX engine's own
batched outputs differ from its unbatched ones by about 1 ulp, so bitwise
equality is not asked of the CPU). Then the engine's unit tests from
``tests/test_gan_engine.py`` through the port's API: bucket policy,
metrics, FIFO and cross-model fairness, deadline flush with a fake clock,
backpressure, expiry, replay and the conservation ledger. Last, the
replay's spans under a fake clock: the port's own (``PORT_SPANS``) cover
the loop, nest per batch and carry the admission lags, the collector's
hook lives only while a traced replay runs, and the timelines and the
reference's span names equal the reference's replay.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro.obs import trace as jobs
from repro.serve import BucketPolicy as JBucketPolicy
from repro.serve import GanEngine as JGanEngine
from repro.serve import GenRequest as JGenRequest
from repro_torch.models import gan
from repro_torch.obs import trace as obs
from repro_torch.serve import BucketPolicy, GanEngine, GenRequest, QueueFull
from repro_torch.serve.batching import pow2_buckets
from repro_torch.serve.gan_engine import PORT_SPANS, sequential_executables
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.weights import from_jax_params


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _z(rng, n, z_dim=100):
    return rng.standard_normal((n, z_dim)).astype(np.float32)


def _params(cfg, seed=0):
    return gan.generator_init(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg = gan.reduced_config(gan.DCGAN, 16)
    return cfg, _params(cfg)


def _engine(policy, cfgs_params, clock=None, warm=True):
    eng = GanEngine(policy, device="cpu",
                    **({"clock": clock} if clock is not None else {}))
    for cfg, params in cfgs_params:
        eng.register(cfg, params)
    if warm:
        eng.warmup()
    return eng


# ------------------------------------------------- parity with the JAX engine

def test_engine_matches_jax_engine():
    cfg_j = jgan.reduced_config(jgan.DCGAN, 16)
    params_np = jax.tree.map(np.asarray,
                             jgan.generator_init(jax.random.key(0), cfg_j))
    rng = np.random.default_rng(0)
    for i in range(len(cfg_j.layers)):
        params_np[f"tconv{i}"]["b"] = (
            0.1 * rng.standard_normal(params_np[f"tconv{i}"]["b"].shape)
        ).astype(np.float32)
    sizes = (1, 3, 2, 1, 4, 2)
    zs = [_z(rng, n) for n in sizes]

    jeng = JGanEngine(JBucketPolicy(buckets=(1, 2, 4), max_queue=64))
    jeng.register(cfg_j, params_np)
    jeng.warmup()
    jreqs = [JGenRequest("dcgan", z) for z in zs]
    jeng.serve(jreqs)

    cfg = gan.reduced_config(gan.DCGAN, 16)
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_queue=64),
                  [(cfg, from_jax_params(params_np, cfg, "cpu"))])
    reqs = [GenRequest("dcgan", z) for z in zs]
    eng.serve(reqs)
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]
    assert eng.metrics.batches == jeng.metrics.batches
    assert eng.metrics.padded == jeng.metrics.padded
    for r, jr in zip(reqs, jreqs):
        assert r.done and jr.done
        assert isinstance(r.output, torch.Tensor) and r.output.device.type == "cpu"
        np.testing.assert_allclose(r.output.numpy(), np.asarray(jr.output),
                                   rtol=1e-5, atol=1e-5)


def test_pad_and_mask_matches_unbatched(tiny):
    """On the CPU too the port's requests equal their own unbatched
    generator call: the plain versions and the row-wise projection do not
    depend on the batch."""
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4, 8), max_queue=64),
                  [(cfg, params)])
    rng = np.random.default_rng(0)
    reqs = [GenRequest("dcgan", _z(rng, n)) for n in (1, 3, 2, 1, 4, 2, 1, 5)]
    eng.serve(reqs)
    for r in reqs:
        ref = gan.generator_apply(params, cfg, r.z, device="cpu")
        np.testing.assert_allclose(r.output.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_sequential_executables(tiny):
    cfg, params = tiny
    fns = sequential_executables(cfg, params, [1, 3], device="cpu")
    assert sorted(fns) == [1, 3]
    z = np.random.default_rng(1).standard_normal((3, 100)).astype(np.float32)
    np.testing.assert_allclose(
        fns[3](params, torch.from_numpy(z)).numpy(),
        gan.generator_apply(params, cfg, z, device="cpu").numpy(), rtol=1e-6,
        atol=1e-6)


# ------------------------------------------------------------ bucket policy

def test_pow2_buckets():
    assert pow2_buckets(16) == (1, 2, 4, 8, 16)
    assert pow2_buckets(1) == (1,)
    for bad in (12, 0):
        with pytest.raises(ValueError):
            pow2_buckets(bad)


def test_bucket_for_and_validation():
    p = BucketPolicy(buckets=(1, 2, 4, 8))
    assert [p.bucket_for(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    for bad in (9, 0):
        with pytest.raises(ValueError):
            p.bucket_for(bad)
    for kw in ({"buckets": ()}, {"buckets": (4, 2, 8)}, {"buckets": (2, 2, 4)},
               {"buckets": (1, 2), "max_queue": 1}, {"max_wait_s": -1.0}):
        with pytest.raises(ValueError):
            BucketPolicy(**kw)


def test_pack_and_should_flush():
    p = BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.5)
    assert p.pack([]) == (0, 0)
    assert p.pack([1, 3, 2, 1, 4]) == (4, 8)
    assert p.pack([8, 1]) == (1, 8)
    assert p.pack([5, 4]) == (1, 8)
    assert not p.should_flush([], 99.0)
    assert not p.should_flush([1, 2], 0.1)
    assert p.should_flush([1, 2], 0.5)
    assert p.should_flush([4, 4], 0.0)
    assert p.should_flush([4, 3, 2], 0.0)


# ----------------------------------------------------------------- metrics

def test_metrics_summary_math():
    m = ServeMetrics()
    m.record_admit(10.0)
    m.record_batch(3, 4, 0.5, now=11.0)
    m.record_batch(1, 4, 0.5, now=12.0)
    for lat in (0.1, 0.2, 0.3, 0.4):
        m.record_completion(lat)
    m.record_reject()
    s = m.summary()
    assert s["samples"] == 4 and s["batches"] == 2 and s["requests"] == 4
    assert s["bucket_batches"] == {4: 2}
    assert s["pad_waste"] == pytest.approx(0.5)
    assert s["samples_per_s"] == pytest.approx(2.0)
    assert s["latency_s"]["p50"] == pytest.approx(0.25)
    assert s["latency_s"]["max"] == pytest.approx(0.4)
    empty = ServeMetrics().summary()
    assert empty["pad_waste"] == 0.0 and empty["latency_s"]["p50"] == 0.0
    assert "latency ms p50" in m.describe()


# ------------------------------------------------------- engine: admission

def test_submit_validation(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2), max_queue=16), [(cfg, params)],
                  warm=False)
    for req in (GenRequest("nope", np.zeros((1, 100), np.float32)),
                GenRequest("dcgan", np.zeros((3,), np.float32)),
                GenRequest("dcgan", np.zeros((3, 100), np.float32)),
                GenRequest("dcgan", np.zeros((0, 100), np.float32)),
                GenRequest("dcgan", np.zeros((1, 100), np.float32),
                           deadline_s=0.0)):
        with pytest.raises(ValueError):
            eng.submit(req)
    assert eng.queued_requests == 0
    with pytest.raises(ValueError):
        eng.register(cfg, params)


# -------------------------------------------------------- engine: fairness

def test_fifo_order_within_model(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_queue=64), [(cfg, params)])
    rng = np.random.default_rng(2)
    reqs = [GenRequest("dcgan", _z(rng, n)) for n in (1, 2, 1, 3, 1, 1, 2)]
    eng.serve(reqs)
    assert [r.rid for r in eng.completed] == sorted(r.rid for r in reqs)


def test_fairness_across_models_serves_oldest_head_first(tiny):
    cfg_d, params_d = tiny
    cfg_g = gan.reduced_config(gan.GPGAN, 16)
    clock = FakeClock()
    eng = _engine(BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=64),
                  [(cfg_d, params_d), (cfg_g, _params(cfg_g, 1))], clock)
    rng = np.random.default_rng(3)
    a0, a1, a2 = (GenRequest("dcgan", _z(rng, 1)) for _ in range(3))
    b0 = GenRequest("gpgan", _z(rng, 1))
    for t, r in [(0.0, a0), (0.0, a1), (0.5, b0), (2.0, a2)]:
        clock.t = t
        eng.submit(r)
    while eng.step(drain=True):
        pass
    assert [r.rid for r in eng.completed] == [a0.rid, a1.rid, b0.rid, a2.rid]
    assert b0.output.shape == (1, 64, 64, 2)


# ------------------------------------------------- engine: deadline flush

def test_deadline_flushes_partial_batch(tiny):
    cfg, params = tiny
    clock = FakeClock()
    eng = _engine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.25,
                               max_queue=64), [(cfg, params)], clock)
    r = GenRequest("dcgan", _z(np.random.default_rng(4), 2))
    eng.submit(r)
    assert not eng.step()
    clock.advance(0.1)
    assert not eng.step()
    clock.advance(0.2)
    assert eng.step()
    assert r.done and eng.metrics.batches == 1
    assert eng.metrics.padded == 2 and eng.metrics.samples == 2


def test_full_bucket_flushes_immediately(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_wait_s=999.0,
                               max_queue=64), [(cfg, params)], FakeClock())
    rng = np.random.default_rng(5)
    for n in (2, 2):
        eng.submit(GenRequest("dcgan", _z(rng, n)))
    assert eng.step()
    assert eng.metrics.samples == 4 and eng.metrics.pad_waste == 0.0


# ------------------------------------------------- engine: backpressure

def test_backpressure_rejects_above_queue_bound(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_wait_s=999.0,
                               max_queue=6), [(cfg, params)], FakeClock(),
                  warm=False)
    rng = np.random.default_rng(6)
    eng.submit(GenRequest("dcgan", _z(rng, 4)))
    eng.submit(GenRequest("dcgan", _z(rng, 2)))
    overflow = GenRequest("dcgan", _z(rng, 1))
    with pytest.raises(QueueFull):
        eng.submit(overflow)
    assert overflow.rid == -1 and overflow.rejected
    assert eng.queued_requests == 2 and eng.metrics.rejected == 1
    while eng.step(drain=True):
        pass
    overflow.rejected = False
    eng.submit(overflow)
    assert eng.queued_requests == 1


# ------------------------------------------------ engine: executables

def test_no_builds_after_warmup(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4, 8), max_queue=256),
                  [(cfg, params)])
    assert eng.warmup_recompiles == 4
    rng = np.random.default_rng(7)
    for _ in range(2):
        reqs = [GenRequest("dcgan", _z(rng, 1 + int(n)))
                for n in rng.integers(0, 8, size=6)]
        eng.serve(reqs)
        assert all(r.done for r in reqs)
    assert eng.metrics.recompiles == eng.warmup_recompiles


def test_unwarmed_engine_builds_inline_and_counts_it(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2), max_queue=16), [(cfg, params)],
                  warm=False)
    rng = np.random.default_rng(8)
    eng.serve([GenRequest("dcgan", _z(rng, 2))])
    assert eng.metrics.recompiles == 1
    eng.serve([GenRequest("dcgan", _z(rng, 2))])
    assert eng.metrics.recompiles == 1


# ---------------------------------------------------------- replay mode

def test_replay_serves_trace_and_sheds_under_backpressure(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_wait_s=0.002,
                               max_queue=64), [(cfg, params)])
    rng = np.random.default_rng(9)
    reqs = [GenRequest("dcgan", _z(rng, 1 + i % 2)) for i in range(6)]
    eng.replay(reqs, [i * 1e-3 for i in range(6)])
    assert all(r.done for r in reqs) and eng.metrics.requests == 6

    eng = _engine(BucketPolicy(buckets=(1, 2), max_wait_s=999.0, max_queue=2),
                  [(cfg, params)])
    reqs = [GenRequest("dcgan", _z(rng, 1)) for _ in range(6)]
    eng.replay(reqs, [0.0] * 6)
    served = [r for r in reqs if r.done]
    assert eng.metrics.rejected == 6 - len(served) > 0
    assert eng.conservation()["ok"]
    with pytest.raises(ValueError):
        eng.replay(reqs[:2], [0.2, 0.1])


def test_replay_malformed_request_failed_not_abort(tiny):
    cfg, params = tiny
    eng = _engine(BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=16),
                  [(cfg, params)])
    rng = np.random.default_rng(10)
    good = GenRequest("dcgan", _z(rng, 1))
    bad = GenRequest("nope", _z(rng, 1))
    eng.replay([bad, good], [0.0, 0.0])
    assert bad.failed and bad.terminal_state == "failed"
    assert good.done and eng.metrics.malformed == 1


# ------------------------------------------------ engine: request deadlines

def test_expired_request_rejected_not_served_stale(tiny):
    cfg, params = tiny
    clock = FakeClock()
    eng = _engine(BucketPolicy(buckets=(1, 2, 4), max_wait_s=999.0,
                               max_queue=64), [(cfg, params)], clock)
    rng = np.random.default_rng(11)
    head = GenRequest("dcgan", _z(rng, 1))
    impatient = GenRequest("dcgan", _z(rng, 1), deadline_s=0.05)
    tail = GenRequest("dcgan", _z(rng, 1))
    for r in (head, impatient, tail):
        eng.submit(r)
    clock.advance(0.2)
    assert eng.step(drain=True)
    assert impatient.expired and not impatient.done and impatient.output is None
    assert impatient.latency_s == pytest.approx(0.2)
    assert head.done and tail.done
    assert [r.rid for r in eng.completed] == [head.rid, tail.rid]
    assert eng.metrics.expired == 1 and eng.metrics.samples == 2
    assert eng.metrics.expired_residence_s == [pytest.approx(0.2)]


def test_conservation_ledger(tiny):
    cfg, params = tiny
    clock = FakeClock()
    eng = _engine(BucketPolicy(buckets=(1, 2), max_wait_s=999.0, max_queue=3),
                  [(cfg, params)], clock)
    rng = np.random.default_rng(12)
    reqs = [GenRequest("dcgan", _z(rng, 1), deadline_s=0.5 if i == 1 else None)
            for i in range(4)]
    for r in reqs[:3]:
        eng.submit(r)
    with pytest.raises(QueueFull):
        eng.submit(reqs[3])
    mid = eng.conservation()
    assert mid["ok"] and mid["queued"] == 3
    clock.advance(1.0)
    while eng.step(drain=True):
        pass
    c = eng.conservation()
    assert c["ok"] and c["admitted"] == 3 and c["done"] == 2
    assert c["expired"] == 1 and c["rejected"] == 1 and c["queued"] == 0
    assert sorted(r.terminal_state for r in reqs) == [
        "done", "done", "expired", "rejected"]


# ------------------------------------------------ replay: spans and stamps

class TickClock(FakeClock):
    """A fake clock that also moves by ``tick`` at each reading: the host's
    cost between two readings, which some span must hold."""

    def __init__(self, t=0.0, tick=1e-6):
        super().__init__(t)
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


class CostlyEngine(GanEngine):
    """An engine whose device work and admissions take fake-clock time."""

    def _sync(self):
        self.clock.advance(2e-3)

    def submit(self, req):
        self.clock.advance(5e-6)
        return super().submit(req)


@pytest.fixture
def traced_clock():
    """Tracing on into a tracer on a :class:`TickClock`; the previous
    tracer and flag restored afterwards."""
    clock = TickClock(100.0)
    tracer = obs.Tracer(clock=clock)
    prev, was = obs.set_tracer(tracer), obs.enabled()
    obs.enable()
    yield clock, tracer
    obs.set_tracer(prev)
    (obs.enable if was else obs.disable)()


def _schedule(cfg, n=60, seed=13):
    rng = np.random.default_rng(seed)
    reqs = [GenRequest("dcgan", _z(rng, 1 + i % 2, cfg.z_dim)) for i in range(n)]
    arrivals = np.cumsum(rng.exponential(7e-4, size=n)).tolist()
    return reqs, arrivals


def _costly(cfg, params, clock):
    eng = CostlyEngine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.004,
                                    max_queue=64), device="cpu", clock=clock)
    eng.register(cfg, params)
    eng.warmup()
    return eng


def _inside(s, outer):
    return (outer["ts"] <= s["ts"]
            and s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]
            and s["depth"] == outer["depth"] + 1)


def _dispatched_at(eng, rid):
    return next(e["t"] for e in eng.timeline.get(rid).events
                if e["event"] == "dispatch")


def test_replay_wall_lies_under_program_spans(tiny, traced_clock):
    cfg, params = tiny
    clock, tracer = traced_clock
    eng = _costly(cfg, params, clock)
    reqs, arrivals = _schedule(cfg)
    t_start = clock.t
    eng.replay(reqs, arrivals, sleep=clock.advance)
    wall = clock.t - t_start
    assert all(r.done for r in reqs)
    top = [s for s in tracer.spans if s["depth"] == 0]
    # a collector pass may fall between two spans: host.gc then holds it;
    # the hook's zero-length mark opens the replay's first traced pass
    assert ({s["name"] for s in top} - {"host.gc"}
            == {"serve.admit", "serve.step", "serve.wait", "host.gc.hook"})
    assert sum(s["dur"] for s in top) >= 0.99 * wall
    assert eng.timeline.incomplete() == []
    assert eng.timeline.reconcile(eng.conservation())["ok"]


def test_replay_span_tree_per_batch(tiny, traced_clock):
    cfg, params = tiny
    clock, tracer = traced_clock
    eng = _costly(cfg, params, clock)
    reqs, arrivals = _schedule(cfg)
    eng.replay(reqs, arrivals, sleep=clock.advance)
    spans = sorted(tracer.spans, key=lambda s: (s["ts"], s["depth"]))
    dispatches = [s for s in spans if s["name"] == "serve.dispatch"]
    assert len(dispatches) == eng.metrics.batches > 1
    spans = [s for s in spans if s["name"] != "host.gc"]   # anywhere, any time
    packed = []
    for d in dispatches:
        kids = [s["name"] for s in spans if _inside(s, d)]
        assert kids == ["serve.launch", "serve.sync", "serve.copy_out"]
        step = next(s for s in spans if s["name"] == "serve.step" and _inside(d, s))
        batch = [s for s in spans if _inside(s, step)]
        assert [s["name"] for s in batch] == ["serve.pack", "serve.dispatch",
                                               "serve.slice"]
        pack = batch[0]
        rids = [r.rid for r in reqs
                if pack["ts"] + pack["dur"] <= _dispatched_at(eng, r.rid) <= d["ts"]]
        assert pack["args"]["rids"] == tuple(rids) and rids
        assert pack["args"]["reqs"] == len(rids)
        packed += rids
    assert packed == [r.rid for r in eng.completed] == list(range(len(reqs)))


def test_replay_admit_spans_carry_the_stamped_lags(tiny, traced_clock):
    cfg, params = tiny
    clock, tracer = traced_clock
    eng = _costly(cfg, params, clock)
    reqs, arrivals = _schedule(cfg)
    t0 = clock.t + clock.tick        # the replay's first reading
    eng.replay(reqs, arrivals, sleep=clock.advance)
    assert [r.t_due for r in reqs] == [t0 + a for a in arrivals]
    admits = [s for s in tracer.spans if s["name"] == "serve.admit"]
    assert sum(s["args"]["n"] for s in admits) == len(reqs)
    for s in admits:
        mine = [r for r in reqs if s["ts"] <= r.t_submit <= s["ts"] + s["dur"]]
        lags = [r.t_submit - r.t_due for r in mine]
        assert s["args"]["n"] == len(mine) and s["args"]["refused"] == 0
        assert s["args"]["lag_s"] == sum(lags)
        assert s["args"]["lag_max_s"] == max(lags)
    m = eng.metrics
    assert m.due_latencies_s == [r.t_done - r.t_due for r in eng.completed]
    assert m.latencies_s == [r.t_done - r.t_submit for r in eng.completed]
    assert m.summary()["due_latency_s"]["max"] == max(m.due_latencies_s)


def test_replay_admit_refused_counts_backpressure_only(tiny, traced_clock):
    cfg, params = tiny
    clock, tracer = traced_clock
    eng = CostlyEngine(BucketPolicy(buckets=(1, 2, 4), max_wait_s=0.004,
                                    max_queue=4), device="cpu", clock=clock)
    eng.register(cfg, params)
    eng.warmup()
    reqs, _ = _schedule(cfg, n=20)
    reqs[5].deadline_s = -1.0                      # malformed
    arrivals = [0.003 * (i // 5) for i in range(len(reqs))]
    eng.replay(reqs, arrivals, sleep=clock.advance)
    admits = [s["args"] for s in tracer.spans if s["name"] == "serve.admit"]
    m = eng.metrics
    assert m.rejected > 0 and m.malformed == 1 and reqs[5].failed
    assert sum(a["refused"] for a in admits) == m.rejected
    assert tracer.counters["serve.rejected"] == m.rejected
    assert sum(a["n"] for a in admits) == len(reqs) - m.rejected - 1


def test_replay_records_collector_passes_and_removes_its_hook(tiny, traced_clock):
    cfg, params = tiny
    clock, tracer = traced_clock
    eng = _costly(cfg, params, clock)
    reqs, arrivals = _schedule(cfg, n=12)
    before = list(gc.callbacks)
    hooked = []

    def sleep(dt):
        if not hooked:
            hooked.append(len(gc.callbacks))
            gc.collect()
        clock.advance(dt)

    eng.replay(reqs, arrivals, sleep=sleep)
    assert hooked == [len(before) + 1]
    assert gc.callbacks == before
    passes = [s for s in tracer.spans if s["name"] == "host.gc"]
    full = [s for s in passes if s["args"]["generation"] == 2]
    assert all(s["args"]["collected"] >= 0 for s in passes)
    assert any(_inside(g, w) for g in full
               for w in tracer.spans if w["name"] == "serve.wait")

    def failing(dt):
        raise RuntimeError("stop")

    with pytest.raises(RuntimeError):
        eng.replay(*_schedule(cfg, n=4), sleep=failing)
    assert gc.callbacks == before


def test_untraced_replay_records_nothing_and_installs_no_hook(tiny):
    cfg, params = tiny
    clock = FakeClock(5.0)
    tracer = obs.Tracer(clock=clock)
    prev, was = obs.set_tracer(tracer), obs.enabled()
    obs.disable()
    try:
        eng = _costly(cfg, params, clock)
        reqs, arrivals = _schedule(cfg, n=12)
        before = list(gc.callbacks)
        seen = []

        def sleep(dt):   # at least a microsecond: a sub-ulp step would stall
            if not seen:
                gc.collect()
            seen.append(list(gc.callbacks))
            clock.advance(max(dt, 1e-6))

        t0 = clock.t
        eng.replay(reqs, arrivals, sleep=sleep)
    finally:
        obs.set_tracer(prev)
        (obs.enable if was else obs.disable)()
    assert seen and all(cbs == before for cbs in seen)
    assert len(tracer.spans) == 0 and not tracer.counters
    assert len(eng.timeline) == 0
    # the stamps are plain fields, written whether tracing is on or off
    assert [r.t_due for r in reqs] == [t0 + a for a in arrivals]
    assert eng.metrics.due_latencies_s == [r.t_done - r.t_due for r in eng.completed]


def test_replay_matches_the_reference_replay(tmp_path, monkeypatch):
    """Both packages replay one schedule under fake clocks with tracing on:
    the port's batched timelines read out the reference's per-request
    events, event for event; the span names equal the reference's over its
    names, and the port's extra names are exactly ``PORT_SPANS``. Both plan
    cold (a fresh autotune cache) and per layer."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    cfg_j = jgan.reduced_config(jgan.DCGAN, 16)
    params_np = jax.tree.map(np.asarray,
                             jgan.generator_init(jax.random.key(0), cfg_j))
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = from_jax_params(params_np, cfg, "cpu")
    reqs, _ = _schedule(cfg, n=25, seed=14)
    # bursts of five (past the queue's bound: some are refused), and a
    # deadline on every seventh request (some expire while queued)
    arrivals = [0.002 * (i // 5) for i in range(len(reqs))]
    deadlines = [0.001 if i % 7 == 3 else None for i in range(len(reqs))]
    policy = dict(buckets=(1, 2, 4), max_wait_s=0.003, max_queue=6)

    def run(engine_cls, request_cls, p, c):
        clock = FakeClock(3.0)
        eng = engine_cls(policy_cls(**policy), clock=clock, fuse="off", **device)
        eng.register(c, p)
        eng.warmup()
        mine = [request_cls("dcgan", r.z, deadline_s=d)
                for r, d in zip(reqs, deadlines)]
        collected = []

        def sleep(dt):   # at least a microsecond: a sub-ulp step would stall
            if not collected:
                collected.append(gc.collect())
            clock.advance(max(dt, 1e-6))

        eng.replay(mine, arrivals, sleep=sleep)
        return eng, mine

    tracers = (obs.Tracer(), jobs.Tracer())
    prev = (obs.set_tracer(tracers[0]), jobs.set_tracer(tracers[1]))
    was = (obs.enabled(), jobs.enabled())
    obs.enable()
    jobs.enable()
    try:
        policy_cls, device = JBucketPolicy, {}
        jeng, jreqs = run(JGanEngine, JGenRequest, params_np, cfg_j)
        policy_cls, device = BucketPolicy, {"device": "cpu"}
        eng, preqs = run(GanEngine, GenRequest, params, cfg)
    finally:
        for mod, tracer, on in ((obs, prev[0], was[0]), (jobs, prev[1], was[1])):
            mod.set_tracer(tracer)
            (mod.enable if on else mod.disable)()

    assert eng.metrics.rejected == jeng.metrics.rejected > 0
    assert eng.metrics.expired == jeng.metrics.expired > 0
    assert ([r.terminal_state for r in preqs]
            == [r.terminal_state for r in jreqs])

    def events(store):
        return [(tl.rid, tl.model, tl.events) for tl in store.timelines()]

    assert events(eng.timeline) == events(jeng.timeline)
    assert eng.timeline.incomplete() == [] and jeng.timeline.incomplete() == []
    assert eng.timeline.reconcile(eng.conservation())["ok"]
    names, jnames = tracers[0].span_names(), tracers[1].span_names()
    assert {k: names.get(k) for k in jnames} == jnames
    assert set(names) - set(jnames) == PORT_SPANS
    assert (sum(s["args"]["refused"] for s in tracers[0].spans
                if s["name"] == "serve.admit") == eng.metrics.rejected)
    assert tracers[0].counters == tracers[1].counters
