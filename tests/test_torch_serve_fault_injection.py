"""Port of the serving chaos harness (repro_torch.serve.fault_injection), on
the CPU: the tests of ``tests/test_serve_fault_injection.py`` through the
port's API (faults fire at exact per-replica dispatch indices, crashes
persist, hangs stall the injected clock, transients are one-shot, NaN
poisons exactly one output plane of a tensor, revival is probe-counted),
the flight-recorder dumps of a real supervisor, and one plan driven through
both packages' injectors firing identically."""
import numpy as np
import pytest
import torch

from repro.serve.fault_injection import ReplicaCrash as JReplicaCrash
from repro.serve.fault_injection import ServeFaultInjector as JServeFaultInjector
from repro.serve.fault_injection import ServeFaultPlan as JServeFaultPlan
from repro.serve.fault_injection import (
    TransientDispatchError as JTransientDispatchError,
)
from repro_torch.models import gan
from repro_torch.obs.flight_recorder import FlightRecorder
from repro_torch.serve import BucketPolicy, GenRequest, Replica, ReplicaSupervisor
from repro_torch.serve.fault_injection import (
    ReplicaCrash,
    ServeFaultInjector,
    ServeFaultPlan,
    TransientDispatchError,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeReplica:
    """The injector only reads ``replica_id`` off the seam's first arg."""

    def __init__(self, replica_id):
        self.replica_id = replica_id


def test_crash_fires_at_exact_index_and_persists():
    inj = ServeFaultInjector(ServeFaultPlan(crash_at=(("r0", 3),)))
    r0, r1 = FakeReplica("r0"), FakeReplica("r1")
    assert inj.hook(r0, 1, "m", 4) is None
    assert inj.hook(r0, 2, "m", 4) is None
    with pytest.raises(ReplicaCrash):
        inj.hook(r0, 3, "m", 4)
    with pytest.raises(ReplicaCrash):           # down: dispatches refuse
        inj.hook(r0, 4, "m", 4)
    with pytest.raises(ReplicaCrash):           # ...and probes
        inj.hook(r0, 1, "m", 1, probe=True)
    assert inj.hook(r1, 3, "m", 4) is None       # other replicas untouched
    assert inj.fired == [("crash", "r0", 3)]
    assert inj.crashed == {"r0"}


def test_transient_fires_once_then_clears():
    inj = ServeFaultInjector(ServeFaultPlan(transient_at=(("r0", 2),)))
    r0 = FakeReplica("r0")
    assert inj.hook(r0, 1, "m", 2) is None
    with pytest.raises(TransientDispatchError):
        inj.hook(r0, 2, "m", 2)
    assert inj.hook(r0, 3, "m", 2) is None       # next dispatch succeeds
    assert inj.fired == [("transient", "r0", 2)]


def test_hang_advances_fake_clock_and_lets_dispatch_through():
    clock = FakeClock()
    inj = ServeFaultInjector(
        ServeFaultPlan(hang_at=(("r0", 1, 2.5),)), clock=clock
    )
    r0 = FakeReplica("r0")
    assert inj.hook(r0, 1, "m", 2) is None       # completes, but late
    assert clock.t == 2.5
    assert inj.hook(r0, 2, "m", 2) is None       # one-shot
    assert clock.t == 2.5
    assert inj.fired == [("hang", "r0", 1)]


def test_hang_without_fake_clock_sleeps(monkeypatch):
    slept = []
    import repro_torch.serve.fault_injection as fi

    monkeypatch.setattr(fi.time, "sleep", lambda s: slept.append(s))
    inj = ServeFaultInjector(ServeFaultPlan(hang_at=(("r0", 1, 0.25),)))
    inj.hook(FakeReplica("r0"), 1, "m", 1)
    assert slept == [0.25]


def test_nan_poisons_exactly_one_plane_of_one_dispatch():
    inj = ServeFaultInjector(ServeFaultPlan(nan_at=(("r0", 2),)))
    r0 = FakeReplica("r0")
    assert inj.hook(r0, 1, "m", 2) is None
    transform = inj.hook(r0, 2, "m", 2)
    assert transform is not None
    clean = torch.ones((2, 4, 4, 1))
    poisoned = transform(clean)
    assert torch.isnan(poisoned[0]).all()
    assert torch.isfinite(poisoned[1]).all()
    assert torch.isfinite(clean).all()           # the original untouched
    assert inj.hook(r0, 3, "m", 2) is None
    assert inj.fired == [("nan", "r0", 2)]


def test_probes_refused_while_crashed_until_revival_count():
    inj = ServeFaultInjector(ServeFaultPlan(
        crash_at=(("r0", 1),), revive_after_probes=(("r0", 3),)
    ))
    r0 = FakeReplica("r0")
    with pytest.raises(ReplicaCrash):
        inj.hook(r0, 1, "m", 1)
    for n in (1, 2):
        with pytest.raises(ReplicaCrash):
            inj.hook(r0, n, "m", 1, probe=True)
    assert inj.hook(r0, 3, "m", 1, probe=True) is None    # revived
    assert "r0" not in inj.crashed
    assert inj.hook(r0, 2, "m", 1) is None       # dispatches work again
    assert inj.fired == [("crash", "r0", 1), ("revive", "r0", 3)]


def test_probe_of_healthy_replica_passes_through():
    inj = ServeFaultInjector(ServeFaultPlan())
    assert inj.hook(FakeReplica("r0"), 1, "m", 1, probe=True) is None
    assert inj.fired == []


PLAN = dict(crash_at=(("r1", 2),), transient_at=(("r0", 1),),
            nan_at=(("r0", 3),), revive_after_probes=(("r1", 2),))


def _drive(inj, errors):
    r0, r1 = FakeReplica("r0"), FakeReplica("r1")
    for rep, idx in ((r0, 1), (r0, 2), (r1, 1), (r1, 2), (r0, 3), (r1, 3)):
        try:
            inj.hook(rep, idx, "m", 2)
        except errors:
            pass
    for n in (1, 2):
        try:
            inj.hook(r1, n, "m", 1, probe=True)
        except errors:
            pass
    return list(inj.fired)


def test_identical_plans_fire_identically():
    """Chaos runs are reproducible: the same plan driven by the same
    dispatch sequence fires the same events in the same order."""
    errors = (ReplicaCrash, TransientDispatchError)
    a = _drive(ServeFaultInjector(ServeFaultPlan(**PLAN)), errors)
    b = _drive(ServeFaultInjector(ServeFaultPlan(**PLAN)), errors)
    assert a == b
    assert [e[0] for e in a] == ["transient", "crash", "nan", "revive"]


def test_plan_fires_as_the_reference_injector_does():
    port = _drive(ServeFaultInjector(ServeFaultPlan(**PLAN)),
                  (ReplicaCrash, TransientDispatchError))
    ref = _drive(JServeFaultInjector(JServeFaultPlan(**PLAN)),
                 (JReplicaCrash, JTransientDispatchError))
    assert port == ref


# --------------------------------------------------- flight recorder dumps

TINY = gan.GANConfig("tiny", 8, ((4, 4, 4), (8, 4, 3)))


@pytest.fixture(scope="module")
def tiny_gan():
    return TINY, gan.generator_init(torch.Generator().manual_seed(0), TINY,
                                    device="cpu")


def _recorder_supervisor(cfg, params, plan, tmp_path, **kwargs):
    clock = FakeClock()
    inj = ServeFaultInjector(plan, clock=clock)
    replicas = [Replica(f"r{i}", device="cpu", dispatch_hook=inj.hook)
                for i in range(2)]
    recorder = FlightRecorder(dump_dir=str(tmp_path), clock=clock)
    kwargs.setdefault("timeout_s", 1.0)
    sup = ReplicaSupervisor(
        replicas,
        BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=64),
        device="cpu", clock=clock, recorder=recorder, **kwargs,
    )
    sup.register(cfg, params)
    return sup, recorder, clock


def _one(rng, cfg):
    return GenRequest(cfg.name,
                      rng.standard_normal((1, cfg.z_dim)).astype(np.float32))


def test_replica_dead_dumps_flight_artifact(tmp_path, tiny_gan):
    """Crash -> SUSPECT, then the due probe fails -> DEAD writes one dump
    whose ring holds the transitions and whose extra carries the replica
    states and the conservation ledger at death."""
    cfg, params = tiny_gan
    plan = ServeFaultPlan(crash_at=(("r0", 1),))
    sup, recorder, clock = _recorder_supervisor(
        cfg, params, plan, tmp_path, probe_backoff_s=0.05)
    rng = np.random.default_rng(0)
    sup.serve([_one(rng, cfg) for _ in range(3)])
    assert sup.replica_states()["r0"] == "SUSPECT"
    assert recorder.dumps == []              # not dead yet: no artifact
    clock.advance(0.06)                      # past the probe backoff
    sup.serve([_one(rng, cfg)])              # the due probe fails -> DEAD
    assert sup.replica_states()["r0"] == "DEAD"
    assert len(recorder.dumps) == 1
    blob = FlightRecorder.load(recorder.dumps[0])
    assert blob["trigger"] == "replica_dead:r0"
    assert blob["extra"]["states"]["r0"] == "DEAD"
    assert "admitted" in blob["extra"]["conservation"]
    edges = [(e["old"], e["new"]) for e in blob["events"]
             if e["kind"] == "replica.transition"]
    assert ("HEALTHY", "SUSPECT") in edges
    assert ("SUSPECT", "DEAD") in edges
    dead = [e for e in blob["events"]
            if e["kind"] == "replica.transition" and e["new"] == "DEAD"][0]
    assert dead["next_probe_at"] is not None
    assert dead["backoff_s"] > 0.0


def test_nonfinite_output_dumps_flight_artifact(tmp_path, tiny_gan):
    """A poisoned output plane dumps before the batch is retried, and the
    retried batch still serves finite."""
    cfg, params = tiny_gan
    plan = ServeFaultPlan(nan_at=(("r0", 1),))
    sup, recorder, _ = _recorder_supervisor(cfg, params, plan, tmp_path)
    rng = np.random.default_rng(1)
    reqs = [_one(rng, cfg) for _ in range(4)]
    sup.serve(reqs)
    assert sup.metrics.nonfinite == 1
    assert all(r.done and torch.isfinite(r.output).all() for r in reqs)
    triggers = [FlightRecorder.load(p)["trigger"] for p in recorder.dumps]
    assert "nonfinite:r0" in triggers
    blob = FlightRecorder.load(
        recorder.dumps[triggers.index("nonfinite:r0")])
    assert blob["extra"]["model"] == cfg.name
    assert any(e["kind"] == "nonfinite" for e in blob["events"])


def test_no_recorder_means_no_artifacts(tmp_path, tiny_gan, monkeypatch):
    """The recorder is opt-in: the same chaos run without one writes
    nothing anywhere (no default dump directory)."""
    cfg, params = tiny_gan
    monkeypatch.chdir(tmp_path)
    clock = FakeClock()
    inj = ServeFaultInjector(
        ServeFaultPlan(crash_at=(("r0", 1),)), clock=clock)
    replicas = [Replica(f"r{i}", device="cpu", dispatch_hook=inj.hook)
                for i in range(2)]
    sup = ReplicaSupervisor(
        replicas,
        BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=64),
        device="cpu", clock=clock, timeout_s=1.0,
    )
    sup.register(cfg, params)
    rng = np.random.default_rng(2)
    reqs = [_one(rng, cfg) for _ in range(3)]
    sup.serve(reqs)
    assert all(r.done for r in reqs)
    assert list(tmp_path.iterdir()) == []
