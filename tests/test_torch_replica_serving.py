"""Port of resilient multi-replica serving (repro_torch.serve.replica and
repro_torch.serve.supervisor), on the CPU.

The 24 tests of ``tests/test_replica_serving.py`` through the port's API:
replica executables, routing, the health state machine, timeouts, retries,
the output guard, degradation, the circuit breaker, per-replica recompiles,
per-model metrics and conservation. The three tests whose bitwise checks
the reference fails by about 1 ulp on this CPU
(``test_supervisor_outputs_bitwise_equal_across_replicas``,
``test_nonfinite_output_never_served``,
``test_all_dead_inline_fallback_serves_bitwise_equal``) hold the port to
bitwise equality with its unbatched ``generator_apply``.

Then the port against the reference: one fake clock schedule, one request
stream and one ``ServeFaultPlan`` through both supervisors (the reference's
with ``fuse="off"``, whose default ``"auto"`` reads an autotune cache), with
tracing on: identical timeline events (names, rids, buckets, replica ids,
fake-clock times), transition and probe logs, retry counts, terminal states
and span counts, and outputs within fp32 rtol = atol = 1e-5.
"""
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro.obs import trace as jobs
from repro.serve import BucketPolicy as JBucketPolicy
from repro.serve import Replica as JReplica
from repro.serve import ReplicaSupervisor as JReplicaSupervisor
from repro.serve import GenRequest as JGenRequest
from repro.serve.fault_injection import ServeFaultInjector as JServeFaultInjector
from repro.serve.fault_injection import ServeFaultPlan as JServeFaultPlan
from repro_torch.models import gan
from repro_torch.obs import trace as obs
from repro_torch.serve import (
    BucketPolicy,
    GenRequest,
    QueueFull,
    Replica,
    ReplicaSupervisor,
)
from repro_torch.serve.fault_injection import ServeFaultInjector, ServeFaultPlan
from repro_torch.weights import from_jax_params

_tiny = gan.reduced_config


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _z(rng, n, z_dim):
    return rng.standard_normal((n, z_dim)).astype(np.float32)


def _unbatched(params, cfg, z):
    return gan.generator_apply(params, cfg, z, device="cpu")


@pytest.fixture(scope="module")
def tiny_dcgan():
    cfg = _tiny(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    return cfg, params


def make_supervisor(cfg, params, *, n_replicas=2, plan=None, clock=None,
                    buckets=(1, 2, 4), max_wait_s=0.0, max_queue=64,
                    **kwargs):
    """Two warmed CPU replicas (optionally fault-injected) under one
    supervisor with a fake clock and an explicit dispatch timeout."""
    clock = clock or FakeClock()
    inj = ServeFaultInjector(plan, clock=clock) if plan is not None else None
    hook = inj.hook if inj is not None else None
    replicas = [Replica(f"r{i}", device="cpu", dispatch_hook=hook)
                for i in range(n_replicas)]
    kwargs.setdefault("timeout_s", 1.0)
    sup = ReplicaSupervisor(
        replicas,
        BucketPolicy(buckets=buckets, max_wait_s=max_wait_s,
                     max_queue=max_queue),
        device="cpu", clock=clock, **kwargs,
    )
    sup.register(cfg, params)
    sup.warmup()
    return sup, inj, clock


# --------------------------------------------------------------- replica

def test_replica_outputs_bitwise_equal_unbatched(tiny_dcgan):
    cfg, params = tiny_dcgan
    rep = Replica("r0", device="cpu")
    rep.register(cfg, params)
    rep.warmup([1, 2])
    rng = np.random.default_rng(0)
    z = _z(rng, 2, cfg.z_dim)
    out = rep.execute("dcgan", z, 2)
    assert torch.equal(out, _unbatched(params, cfg, z))


def test_replica_warmup_measures_baselines_and_compiles_once(tiny_dcgan):
    cfg, params = tiny_dcgan
    rep = Replica("r0", device="cpu")
    rep.register(cfg, params)
    rep.warmup([1, 2, 4])
    assert rep.recompiles == 3                    # one build per bucket
    assert set(rep.baseline_s) == {("dcgan", 1), ("dcgan", 2), ("dcgan", 4)}
    assert all(v > 0 for v in rep.baseline_s.values())
    rng = np.random.default_rng(1)
    for n in (1, 2, 4, 1, 2):                     # steady state: no builds
        rep.execute("dcgan", _z(rng, n, cfg.z_dim), n)
    assert rep.recompiles == 3


def test_replica_dispatch_seam_sees_every_dispatch(tiny_dcgan):
    cfg, params = tiny_dcgan
    seen = []

    def hook(replica, index, name, bucket, probe=False):
        seen.append((replica.replica_id, index, name, bucket, probe))
        return None

    rep = Replica("r7", device="cpu", dispatch_hook=hook)
    rep.register(cfg, params)
    rep.warmup([1])
    rng = np.random.default_rng(2)
    rep.execute("dcgan", _z(rng, 1, cfg.z_dim), 1)
    rep.execute("dcgan", _z(rng, 1, cfg.z_dim), 1)
    assert rep.probe() is True
    assert seen == [
        ("r7", 1, "dcgan", 1, False),
        ("r7", 2, "dcgan", 1, False),
        ("r7", 1, "dcgan", 1, True),   # probes count separately
    ]


def test_replica_hook_transform_poisons_only_this_output(tiny_dcgan):
    cfg, params = tiny_dcgan

    def hook(replica, index, name, bucket, probe=False):
        if not probe and index == 1:
            def poison(out):
                out = out.clone()
                out[0] = float("nan")
                return out
            return poison
        return None

    rep = Replica("r0", device="cpu", dispatch_hook=hook)
    rep.register(cfg, params)
    rep.warmup([1])
    rng = np.random.default_rng(3)
    z = _z(rng, 1, cfg.z_dim)
    bad = rep.execute("dcgan", z, 1)
    good = rep.execute("dcgan", z, 1)
    assert torch.isnan(bad).any()
    assert torch.isfinite(good).all()


def test_replica_duplicate_register_rejected(tiny_dcgan):
    cfg, params = tiny_dcgan
    rep = Replica("r0", device="cpu")
    rep.register(cfg, params)
    with pytest.raises(ValueError):
        rep.register(cfg, params)


# ---------------------------------------------------- supervisor: routing

def test_supervisor_outputs_bitwise_equal_across_replicas(tiny_dcgan):
    """Both replicas serve mixed traffic; every output is bitwise its
    unbatched call (the reference misses this by about 1 ulp)."""
    cfg, params = tiny_dcgan
    sup, _, _ = make_supervisor(cfg, params)
    rng = np.random.default_rng(4)
    reqs = [GenRequest("dcgan", _z(rng, 1 + i % 3, cfg.z_dim))
            for i in range(8)]
    sup.serve(reqs)
    assert all(r.done for r in reqs)
    for r in reqs:
        assert torch.equal(r.output, _unbatched(params, cfg, r.z))
    assert {r.replica for r in reqs} == {"r0", "r1"}


def test_supervisor_round_robin_balances_dispatches(tiny_dcgan):
    cfg, params = tiny_dcgan
    sup, _, _ = make_supervisor(cfg, params)
    rng = np.random.default_rng(5)
    sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))
               for _ in range(10)])
    d0 = sup.rslots["r0"].replica.dispatches
    d1 = sup.rslots["r1"].replica.dispatches
    assert d0 + d1 == sup.metrics.batches
    assert abs(d0 - d1) <= 1


def test_supervisor_single_replica_works(tiny_dcgan):
    cfg, params = tiny_dcgan
    sup, _, _ = make_supervisor(cfg, params, n_replicas=1)
    rng = np.random.default_rng(6)
    reqs = [GenRequest("dcgan", _z(rng, 2, cfg.z_dim)) for _ in range(3)]
    sup.serve(reqs)
    assert all(r.done and r.replica == "r0" for r in reqs)


def test_supervisor_validation(tiny_dcgan):
    with pytest.raises(ValueError):
        ReplicaSupervisor([], device="cpu")                    # no replicas
    with pytest.raises(ValueError):
        ReplicaSupervisor([Replica("a", device="cpu"),
                           Replica("a", device="cpu")], device="cpu")
    with pytest.raises(ValueError, match="runs on"):           # device clash
        ReplicaSupervisor([Replica("a", device="cpu")], device="meta")
    with pytest.raises(ValueError):
        ReplicaSupervisor([Replica("a", device="cpu")], device="cpu",
                          degraded_mode="explode")
    with pytest.raises(ValueError):
        ReplicaSupervisor([Replica("a", device="cpu")], device="cpu",
                          retry_budget=-1)
    # "auto" (the default, as the reference's) reads the autotuner's pair
    # race; a value the pair pass does not know raises
    assert Replica("a", device="cpu").fuse == "auto"
    assert Replica("a", device="cpu", fuse="auto", train=True).train
    with pytest.raises(ValueError, match="fuse"):
        Replica("a", device="cpu", fuse="sometimes")


def test_supervisor_inherits_engine_invariants(tiny_dcgan):
    """FIFO order, deadline expiry and backpressure all still hold under
    the supervisor: it reuses the engine's admission half unchanged."""
    cfg, params = tiny_dcgan
    clock = FakeClock()
    sup, _, _ = make_supervisor(cfg, params, clock=clock, max_queue=4,
                                buckets=(1, 2))
    rng = np.random.default_rng(7)
    a = GenRequest("dcgan", _z(rng, 2, cfg.z_dim))
    b = GenRequest("dcgan", _z(rng, 2, cfg.z_dim), deadline_s=0.01)
    sup.submit(a)
    sup.submit(b)
    with pytest.raises(QueueFull):
        sup.submit(GenRequest("dcgan", _z(rng, 1, cfg.z_dim)))
    clock.advance(0.1)                 # b expires while queued
    while sup.step(drain=True):
        pass
    assert a.done and b.expired and not b.done
    assert sup.metrics.expired == 1 and sup.metrics.rejected == 1
    assert sup.conservation()["ok"]


# --------------------------------------------- supervisor: health machine

def test_crash_requeues_batch_onto_surviving_replica(tiny_dcgan):
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 2),))
    sup, inj, _ = make_supervisor(cfg, params, plan=plan)
    rng = np.random.default_rng(8)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(6)]
    for r in reqs:   # one batch per serve so r0 reaches dispatch index 2
        sup.serve([r])
    assert inj.fired and inj.fired[0][0] == "crash"
    assert all(r.done for r in reqs)
    assert sup.metrics.requeues >= 1 and sup.metrics.retries >= 1
    retried = [r for r in reqs if r.retries > 0]
    assert retried and all(r.replica != "r0" for r in retried)
    for r in reqs:
        assert torch.equal(r.output, _unbatched(params, cfg, r.z))
    assert sup.conservation()["ok"]


def test_failure_transitions_healthy_suspect_dead(tiny_dcgan):
    """Two strikes: first failure HEALTHY->SUSPECT, second (when the
    suspect replica is routed again or probed) -> DEAD."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1), ("r1", 1)))
    sup, _, _ = make_supervisor(cfg, params, plan=plan, retry_budget=10)
    rng = np.random.default_rng(9)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(2)]
    sup.serve(reqs)
    tc = sup.metrics.transition_counts
    assert tc.get("HEALTHY->SUSPECT", 0) == 2
    assert tc.get("SUSPECT->DEAD", 0) == 2
    assert sup.replica_states() == {"r0": "DEAD", "r1": "DEAD"}
    assert all(r.done and r.replica == "inline" for r in reqs)
    assert sup.metrics.degraded_batches >= 1
    assert sup.conservation()["ok"]


def test_transient_error_bounces_suspect_then_healthy(tiny_dcgan):
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(transient_at=(("r0", 2),))
    sup, inj, _ = make_supervisor(cfg, params, n_replicas=1, plan=plan)
    rng = np.random.default_rng(10)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(4)]
    for r in reqs:   # one batch per serve so dispatch 2 hits the fault
        sup.serve([r])
    assert ("transient", "r0", 2) in inj.fired
    assert all(r.done for r in reqs)
    tc = sup.metrics.transition_counts
    assert tc.get("HEALTHY->SUSPECT", 0) == 1
    assert tc.get("SUSPECT->HEALTHY", 0) == 1
    assert sup.replica_states()["r0"] == "HEALTHY"
    assert sup.conservation()["ok"]


def test_timeout_marks_suspect_and_requeues(tiny_dcgan):
    """A dispatch stalling past the deadline is a straggler: its late
    result is discarded, the replica goes SUSPECT, the batch requeues and
    completes elsewhere."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(hang_at=(("r1", 1, 5.0),))
    sup, inj, _ = make_supervisor(cfg, params, plan=plan, timeout_s=1.0)
    rng = np.random.default_rng(11)
    reqs = [GenRequest("dcgan", _z(rng, 2, cfg.z_dim)) for _ in range(4)]
    sup.serve(reqs)   # two bucket-4 batches: round-robin hits r1 second
    assert any(f[0] == "hang" for f in inj.fired)
    assert sup.metrics.timeouts == 1
    assert sup.metrics.requeues >= 1
    assert all(r.done for r in reqs)
    assert "HEALTHY->SUSPECT" in sup.metrics.transition_counts
    assert sup.conservation()["ok"]


def test_timeout_derived_from_warmup_baselines(tiny_dcgan):
    cfg, params = tiny_dcgan
    clock = FakeClock()
    sup = ReplicaSupervisor(
        [Replica("r0", device="cpu")],
        BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=16),
        timeout_factor=8.0, min_timeout_s=0.05, device="cpu", clock=clock,
    )
    sup.register(cfg, params)
    sup.warmup()
    base = sup._baseline_s[("dcgan", 1)]
    assert base > 0
    assert sup.timeout_for("dcgan", 1) == max(0.05, 8.0 * base)
    # an unknown (model, bucket) signature floors at min_timeout_s
    assert sup.timeout_for("dcgan", 999) == 0.05


def test_nonfinite_output_never_served(tiny_dcgan):
    """A poisoned output plane is retried, never handed to a client; the
    retried batch is bitwise its unbatched call (the reference misses
    this by about 1 ulp)."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(nan_at=(("r0", 1),))
    sup, inj, _ = make_supervisor(cfg, params, plan=plan)
    rng = np.random.default_rng(12)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(4)]
    sup.serve(reqs)
    assert any(f[0] == "nan" for f in inj.fired)
    assert sup.metrics.nonfinite == 1
    assert all(r.done for r in reqs)
    for r in reqs:
        assert torch.isfinite(r.output).all()
        assert torch.equal(r.output, _unbatched(params, cfg, r.z))
    assert sup.conservation()["ok"]


# ---------------------------------------- supervisor: retry budget / shed

def test_retry_budget_exhaustion_fails_terminally(tiny_dcgan):
    """Every dispatch fails everywhere and degradation sheds: the requests
    terminally fail (bounded), never spin."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1), ("r1", 1)))
    sup, _, _ = make_supervisor(cfg, params, plan=plan, retry_budget=2,
                                degraded_mode="shed")
    rng = np.random.default_rng(13)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(3)]
    sup.serve(reqs)
    assert all(r.failed and not r.done for r in reqs)
    assert all(r.terminal_state == "failed" for r in reqs)
    assert all(r.retries >= 1 for r in reqs)
    assert sup.metrics.failed == 3
    assert sup.queued_requests == 0
    assert sup.conservation()["ok"]


def test_all_dead_shed_mode_bounded_shedding(tiny_dcgan):
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1), ("r1", 1)))
    sup, _, _ = make_supervisor(cfg, params, plan=plan, retry_budget=10,
                                degraded_mode="shed")
    rng = np.random.default_rng(14)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(4)]
    sup.serve(reqs)
    assert all(r.terminal_state == "failed" for r in reqs)
    assert sup.metrics.shed == 4
    assert sup.conservation()["ok"]


def test_all_dead_inline_fallback_serves_bitwise_equal(tiny_dcgan):
    """Every replica dead: the supervisor's own executables serve the
    batch (built at first use, visible in the recompile counter), bitwise
    equal to the unbatched call (the reference misses this by about
    1 ulp)."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1), ("r1", 1)))
    sup, _, _ = make_supervisor(cfg, params, plan=plan, retry_budget=10,
                                degraded_mode="inline")
    rng = np.random.default_rng(15)
    reqs = [GenRequest("dcgan", _z(rng, 1, cfg.z_dim)) for _ in range(4)]
    assert sup.metrics.recompiles == 0       # inline executables are cold
    sup.serve(reqs)
    assert all(r.done and r.replica == "inline" for r in reqs)
    assert sup.metrics.degraded_batches >= 1
    assert sup.metrics.recompiles >= 1       # the inline build is visible
    for r in reqs:
        assert torch.equal(r.output, _unbatched(params, cfg, r.z))
    assert sup.conservation()["ok"]


# ------------------------------------------- supervisor: circuit breaker

def test_circuit_breaker_backoff_doubles_and_revives(tiny_dcgan):
    """DEAD replicas are probed on an exponential backoff; a reviving probe
    moves them RECOVERING, and one successful dispatch re-earns HEALTHY."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1),),
                          revive_after_probes=(("r0", 3),))
    sup, inj, clock = make_supervisor(cfg, params, plan=plan,
                                      probe_backoff_s=0.1,
                                      probe_backoff_max_s=10.0)
    rng = np.random.default_rng(16)
    sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))
               for _ in range(3)])
    for _ in range(40):   # traffic keeps flowing while due probes fire
        clock.advance(0.1)
        sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))])
        if sup.replica_states()["r0"] == "HEALTHY":
            break
    assert ("revive", "r0", 3) in inj.fired
    tc = sup.metrics.transition_counts
    assert tc.get("SUSPECT->DEAD", 0) == 1
    assert tc.get("DEAD->RECOVERING", 0) == 1
    assert tc.get("RECOVERING->HEALTHY", 0) == 1
    assert sup.replica_states()["r0"] == "HEALTHY"
    assert sup.metrics.probes >= 3
    assert sup.metrics.probe_failures >= 2
    d0_before = sup.rslots["r0"].replica.dispatches
    for _ in range(4):
        sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))])
    assert sup.rslots["r0"].replica.dispatches > d0_before
    assert sup.conservation()["ok"]


def test_unhealthy_replica_not_probed_before_backoff(tiny_dcgan):
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 1),))
    sup, _, clock = make_supervisor(cfg, params, plan=plan,
                                    probe_backoff_s=100.0)
    rng = np.random.default_rng(17)
    sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))
               for _ in range(4)])
    assert sup.replica_states()["r0"] in ("SUSPECT", "DEAD")
    probes_before = sup.metrics.probes
    clock.advance(1.0)                       # far inside the backoff
    sup.serve([GenRequest("dcgan", _z(rng, 1, cfg.z_dim))])
    assert sup.metrics.probes == probes_before


# -------------------------------------- zero steady-state recompiles

def test_per_replica_zero_steady_state_recompiles_under_faults(tiny_dcgan):
    """After warmup, mixed traffic with injected faults (crash and NaN
    retries) builds nothing on any replica: a retried bucket re-runs a
    warmed executable."""
    cfg, params = tiny_dcgan
    plan = ServeFaultPlan(crash_at=(("r0", 3),), nan_at=(("r1", 2),))
    sup, _, _ = make_supervisor(cfg, params, plan=plan, retry_budget=10)
    warm = dict(sup.replica_recompiles)
    assert all(v == len(sup.policy.buckets) for v in warm.values())
    rng = np.random.default_rng(18)
    for _ in range(3):
        reqs = [GenRequest("dcgan", _z(rng, 1 + int(n), cfg.z_dim))
                for n in rng.integers(0, 4, size=6)]
        sup.serve(reqs)
        assert all(r.done for r in reqs)
    assert sup.replica_recompiles == warm, "steady-state serving rebuilt"
    assert sup.metrics.recompiles == 0       # inline fallback never engaged
    assert sup.conservation()["ok"]


# ------------------------------------------------- per-model metrics

def test_per_model_metrics_attribute_degradation(tiny_dcgan):
    """Two models through one supervisor; faults hit only one model's
    batches, and the per-model labels attribute retries to it."""
    cfg_d, params_d = tiny_dcgan
    cfg_g = _tiny(gan.GPGAN)
    params_g = gan.generator_init(torch.Generator().manual_seed(1), cfg_g,
                                  device="cpu")
    clock = FakeClock()
    inj = ServeFaultInjector(
        ServeFaultPlan(transient_at=(("r0", 1),)), clock=clock
    )
    sup = ReplicaSupervisor(
        [Replica("r0", device="cpu", dispatch_hook=inj.hook)],
        BucketPolicy(buckets=(1, 2), max_wait_s=0.0, max_queue=64),
        timeout_s=1.0, device="cpu", clock=clock,
    )
    sup.register(cfg_d, params_d)
    sup.register(cfg_g, params_g)
    sup.warmup()
    rng = np.random.default_rng(19)
    d_reqs = [GenRequest("dcgan", _z(rng, 1, cfg_d.z_dim)) for _ in range(2)]
    g_reqs = [GenRequest("gpgan", _z(rng, 1, cfg_g.z_dim)) for _ in range(2)]
    for r in d_reqs + g_reqs:   # dcgan first: its batch hits the fault
        sup.submit(r)
        clock.advance(1e-3)
    while sup.step(drain=True):
        pass
    assert all(r.done for r in d_reqs + g_reqs)
    pm = sup.metrics.summary()["per_model"]
    assert set(pm) == {"dcgan", "gpgan"}
    assert pm["dcgan"]["retries"] >= 1
    assert pm["gpgan"]["retries"] == 0
    assert pm["dcgan"]["requests"] == 2 and pm["gpgan"]["requests"] == 2
    text = sup.metrics.describe()
    assert "[dcgan]" in text and "[gpgan]" in text
    assert sup.conservation()["ok"]


# ---------------------------------------------- conservation (randomized)

def test_conservation_under_randomized_interleaving(tiny_dcgan):
    """Arbitrary interleavings of submit / step / clock advance / expiry
    with injected crash, NaN and hang faults end with every admitted
    request in exactly one terminal state and the ledger balanced."""
    cfg, params = tiny_dcgan
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        plan = ServeFaultPlan(
            crash_at=(("r0", int(rng.integers(1, 6))),),
            nan_at=(("r1", int(rng.integers(1, 6))),),
            hang_at=(("r1", int(rng.integers(6, 10)), 5.0),),
            revive_after_probes=(("r0", 2),),
        )
        sup, _, clock = make_supervisor(
            cfg, params, plan=plan, max_queue=8,
            degraded_mode=("inline", "shed")[seed % 2],
        )
        all_reqs = []
        for _ in range(40):
            op = rng.integers(0, 4)
            if op == 0:
                deadline = (None if rng.integers(0, 2)
                            else float(rng.uniform(0.01, 0.2)))
                r = GenRequest("dcgan",
                               _z(rng, int(rng.integers(1, 4)), cfg.z_dim),
                               deadline_s=deadline)
                all_reqs.append(r)
                try:
                    sup.submit(r)
                except QueueFull:
                    pass
            elif op == 1:
                sup.step()
            elif op == 2:
                clock.advance(float(rng.uniform(0.0, 0.15)))
            else:
                sup.step(drain=True)
        while sup.step(drain=True):
            pass
        sup._purge_expired(sup.clock())

        states = [r.terminal_state for r in all_reqs]
        assert all(s is not None for s in states), (
            f"seed {seed}: unresolved requests {states}"
        )
        c = Counter(states)
        assert len(all_reqs) == (
            c["done"] + c["expired"] + c["rejected"] + c["failed"]
        )
        ledger = sup.conservation()
        assert ledger["ok"], f"seed {seed}: {ledger}"
        assert sup.queued_requests == 0
        for r in all_reqs:   # nothing non-finite was ever served
            if r.done:
                assert torch.isfinite(r.output).all()


# ------------------------------------------ the port against the reference

@pytest.fixture
def both_tracing():
    """Tracing on in both packages, each into an isolated tracer; restores
    both tracers and flags afterwards."""
    tracers = (obs.Tracer(), jobs.Tracer())
    prev = (obs.set_tracer(tracers[0]), jobs.set_tracer(tracers[1]))
    was = (obs.enabled(), jobs.enabled())
    obs.enable()
    jobs.enable()
    yield tracers
    for mod, tracer, on in ((obs, prev[0], was[0]), (jobs, prev[1], was[1])):
        mod.set_tracer(tracer)
        (mod.enable if on else mod.disable)()


CHAOS_PLAN = dict(
    crash_at=(("r0", 3),), nan_at=(("r1", 2),), transient_at=(("r1", 4),),
    hang_at=(("r1", 6, 2.0),), revive_after_probes=(("r0", 2),),
)


def _drive(sup, make_request, clock, zs, deadlines):
    """One schedule for both packages: submit each request, advancing the
    fake clock and stepping between arrivals, then drain."""
    reqs = []
    for i, (z, deadline) in enumerate(zip(zs, deadlines)):
        r = make_request("dcgan", z, deadline_s=deadline)
        reqs.append(r)
        sup.submit(r)
        clock.advance(0.02)
        if i % 2:
            sup.step()
        if i % 5 == 4:
            sup.step(drain=True)
    while sup.step(drain=True):
        clock.advance(0.03)
    return reqs


def test_chaos_run_matches_the_reference(both_tracing):
    cfg_j = jgan.reduced_config(jgan.DCGAN)
    params_np = jax.tree.map(np.asarray,
                             jgan.generator_init(jax.random.key(0), cfg_j))
    cfg = gan.reduced_config(gan.DCGAN)
    params = from_jax_params(params_np, cfg, "cpu")
    rng = np.random.default_rng(21)
    sizes = rng.integers(1, 4, size=14)
    zs = [_z(rng, int(n), cfg.z_dim) for n in sizes]
    deadlines = [0.05 if i == 9 else None for i in range(len(zs))]
    policy = dict(buckets=(1, 2, 4), max_wait_s=0.01, max_queue=64)
    sup_kw = dict(timeout_s=1.0, probe_backoff_s=0.05, retry_budget=2)

    jclock = FakeClock()
    jinj = JServeFaultInjector(JServeFaultPlan(**CHAOS_PLAN), clock=jclock)
    jsup = JReplicaSupervisor(
        [JReplica(f"r{i}", fuse="off", dispatch_hook=jinj.hook)
         for i in range(2)],
        JBucketPolicy(**policy), fuse="off", clock=jclock, **sup_kw)
    jsup.register(cfg_j, params_np)
    jsup.warmup()
    jreqs = _drive(jsup, JGenRequest, jclock, zs, deadlines)

    clock = FakeClock()
    inj = ServeFaultInjector(ServeFaultPlan(**CHAOS_PLAN), clock=clock)
    sup = ReplicaSupervisor(
        [Replica(f"r{i}", device="cpu", dispatch_hook=inj.hook)
         for i in range(2)],
        BucketPolicy(**policy), device="cpu", clock=clock, **sup_kw)
    sup.register(cfg, params)
    sup.warmup()
    reqs = _drive(sup, GenRequest, clock, zs, deadlines)

    assert inj.fired == jinj.fired
    assert {f[0] for f in inj.fired} == {"crash", "nan", "transient",
                                         "hang", "revive"}
    assert ([(r.terminal_state, r.retries, r.replica) for r in reqs]
            == [(r.terminal_state, r.retries, r.replica) for r in jreqs])
    assert list(sup.metrics.transitions) == list(jsup.metrics.transitions)
    assert list(sup.metrics.probe_log) == list(jsup.metrics.probe_log)
    assert sup.metrics.conservation() == jsup.metrics.conservation()
    for key in ("retries", "requeues", "timeouts", "nonfinite", "probes",
                "probe_failures", "degraded_batches", "batches", "padded"):
        assert getattr(sup.metrics, key) == getattr(jsup.metrics, key), key

    def events(store):
        return [(tl.rid, tl.model, tl.events) for tl in store.timelines()]

    assert events(sup.timeline) == events(jsup.timeline)
    assert sup.timeline.incomplete() == [] and jsup.timeline.incomplete() == []
    assert sup.timeline.reconcile(sup.conservation())["ok"]
    tracer, jtracer = both_tracing
    names, jnames = tracer.span_names(), jtracer.span_names()
    assert {k: names.get(k) for k in jnames} == jnames
    # the supervisor dispatches through its own _execute, and the run steps
    # rather than replays: none of the port's own spans (PORT_SPANS) applies
    assert set(names) - set(jnames) == set()
    assert tracer.counters == jtracer.counters
    assert ([(e["name"], e["args"]) for e in tracer.instants]
            == [(e["name"], e["args"]) for e in jtracer.instants])
    for r, jr in zip(reqs, jreqs):
        if r.done:
            np.testing.assert_allclose(r.output.numpy(), np.asarray(jr.output),
                                       rtol=1e-5, atol=1e-5)
