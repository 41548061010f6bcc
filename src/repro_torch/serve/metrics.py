"""Serving metrics. Mirrors ``repro/serve/metrics.py``.

Throughput, latency percentiles, pad waste and recompiles of the serving
engine, and the resilience counters of the replica supervisor.

One :class:`ServeMetrics` instance rides inside each engine. Everything is
recorded in plain Python (no device sync beyond what the engine already
does), so the overhead per batch is a few dict updates.

The four signals the bucket policy is tuned against:

* **throughput** — completed samples (and requests) per second of serving
  wall time (first admission to last completion).
* **latency percentiles** — p50/p95/p99 of request completion latency
  (admission to output ready). The max-wait deadline bounds the queueing
  component; bucket sizes trade the execution component against pad waste.
  Beside it, where a request carries the time it was due
  (``GenRequest.t_due``, stamped by the engine's replay), the latency from
  that due time (``due_latency_s``): an open-loop client's latency, which
  also counts how late the loop admitted the request.
* **pad-waste fraction** — padded-but-discarded rows / dispatched rows.
  High pad waste means the bucket set is too coarse for the traffic's size
  distribution (or ``max_wait_s`` is too small, flushing half-empty).
* **recompile counter** — incremented once per executable the engine
  builds (a plan resolved for one (model, bucket); on the card, one CUDA
  graph captured). After warmup this must stay flat: a moving counter in
  steady state means some (model, bucket) signature was not warmed and a
  request paid its build inline.

``bucket_batches`` counts the batches dispatched at each bucket: the
traffic the autotuner's serving choice is weighted by
(:func:`repro_torch.kernels.autotune.record_traffic`).

The resilience counters the
:class:`~repro_torch.serve.supervisor.ReplicaSupervisor` records (all zero
for a plain :class:`~repro_torch.serve.gan_engine.GanEngine`):

* **retries / requeues / timeouts / nonfinite** — per-request retry
  attempts, batches put back at the queue head after a dispatch failure,
  dispatches past the per-(model, bucket) timeout, and dispatches whose
  output failed the finiteness guard (retried, never served).
* **failed / shed** — admitted requests that terminally failed (retry
  budget exhausted, or shed with every replica dead); ``shed`` counts the
  subset dropped because no replica was available.
* **probes / probe_failures / degraded_batches** — health probes of
  suspect or dead replicas, how many failed, and batches served by the
  inline fallback with every replica dead.
* **replica transitions** — every health-state edge
  (``HEALTHY→SUSPECT→DEAD→RECOVERING``) with timestamp, replica id and
  reason, plus an edge-count histogram for cheap assertions.

**Conservation accounting** (the serving layer's headline invariant —
every admitted request terminally resolves as exactly one of
``done | expired | rejected | failed``, nothing silently lost):
``admitted`` counts requests accepted into a queue; a full drained run must
satisfy ``admitted == requests + expired + failed`` (``rejected`` and
``malformed`` requests were never admitted and are counted separately).
:meth:`conservation` returns the components; the engine's
``conservation()`` adds the still-queued term for mid-run checks.

**Per-model labels**: every admission/completion/retry/failure/expiry is
additionally recorded under its model name, so multi-model degradation is
attributable — ``summary()["per_model"]`` and the extra ``describe()``
lines break latency, throughput, and retries down by model.

Percentile math lives in :func:`repro_torch.obs.trace.percentiles`
(shared with the training timer and the Prometheus exporter);
:meth:`publish` flattens the counters and latency series into an obs
tracer, so one :func:`repro_torch.obs.export.prometheus_text` call
exposes serving and training through a single registry.
"""
from __future__ import annotations

from collections import deque

from repro_torch.obs.trace import get_tracer
from repro_torch.obs.trace import percentiles as _percentiles

# Bounded history rings: the edge/probe COUNTS stay exact forever; only the
# per-event logs are capped so long chaos runs cannot grow without limit.
TRANSITION_LOG_CAP = 256
PROBE_LOG_CAP = 256


class ServeMetrics:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.latencies_s: list = []       # per completed request
        self.due_latencies_s: list = []   # from t_due, where it was set
        self.batches: int = 0             # dispatches
        self.samples: int = 0             # real rows dispatched
        self.padded: int = 0              # total rows dispatched (incl. pad)
        self.bucket_batches: dict = {}    # bucket -> dispatches at it
        self.admitted: int = 0            # requests accepted into a queue
        self.requests: int = 0            # completed requests
        self.rejected: int = 0            # backpressure rejections
        self.malformed: int = 0           # replay-mode invalid submits
        self.expired: int = 0             # deadline-expired (never served)
        self.expired_residence_s: list = []   # queue residence at expiry
        self.failed: int = 0              # admitted, terminally failed
        self.recompiles: int = 0          # executables built
        self.batch_wall_s: float = 0.0    # time inside execute calls
        self.t_first: float | None = None  # first admission
        self.t_last: float | None = None   # last completion
        # ------------------------- replica-serving resilience counters
        self.retries: int = 0             # per-request retry attempts
        self.requeues: int = 0            # batches put back at the head
        self.timeouts: int = 0            # dispatches past the deadline
        self.nonfinite: int = 0           # outputs failing the NaN guard
        self.shed: int = 0                # requests dropped in degraded mode
        self.probes: int = 0              # replica health probes
        self.probe_failures: int = 0
        self.degraded_batches: int = 0    # inline-fallback dispatches
        # bounded event logs (counts above stay exact; see module docstring)
        self.transitions: deque = deque(maxlen=TRANSITION_LOG_CAP)
        self.probe_log: deque = deque(maxlen=PROBE_LOG_CAP)
        self.transition_counts: dict = {}  # "OLD->NEW" -> count
        self.per_model: dict = {}         # model -> label dict

    # --------------------------------------------------- per-model labels

    def _pm(self, model: str | None) -> dict | None:
        if model is None:
            return None
        d = self.per_model.get(model)
        if d is None:
            d = self.per_model[model] = {
                "admitted": 0, "requests": 0, "samples": 0, "batches": 0,
                "rejected": 0, "expired": 0, "failed": 0, "retries": 0,
                "latencies_s": [],
            }
        return d

    # ---------------------------------------------------------- recording

    def count_recompile(self) -> None:
        """Called once per executable the engine builds, never when it
        reuses one."""
        self.recompiles += 1

    def record_admit(self, now: float, model: str | None = None) -> None:
        if self.t_first is None:
            self.t_first = now
        self.admitted += 1
        pm = self._pm(model)
        if pm is not None:
            pm["admitted"] += 1

    def record_reject(self, model: str | None = None) -> None:
        self.rejected += 1
        pm = self._pm(model)
        if pm is not None:
            pm["rejected"] += 1

    def record_malformed(self, model: str | None = None) -> None:
        """Replay mode only: an invalid request (unknown model, bad shape)
        is recorded as terminally failed instead of aborting the trace."""
        self.malformed += 1

    def record_expired(self, now: float, residence_s: float | None = None,
                       model: str | None = None) -> None:
        """A queued request crossed its deadline before dispatch: it is
        REJECTED (client told), never silently served stale.
        ``residence_s`` is how long it sat in the queue (admission →
        purge), the time-to-expiry signal the policy is tuned against."""
        self.expired += 1
        if residence_s is not None:
            self.expired_residence_s.append(residence_s)
        self.t_last = now if self.t_last is None else max(self.t_last, now)
        pm = self._pm(model)
        if pm is not None:
            pm["expired"] += 1

    def record_batch(self, n_real: int, n_padded: int, wall_s: float,
                     now: float, model: str | None = None) -> None:
        self.batches += 1
        self.samples += n_real
        self.padded += n_padded
        self.bucket_batches[n_padded] = self.bucket_batches.get(n_padded, 0) + 1
        self.batch_wall_s += wall_s
        self.t_last = now
        pm = self._pm(model)
        if pm is not None:
            pm["batches"] += 1
            pm["samples"] += n_real

    def record_completion(self, latency_s: float,
                          model: str | None = None,
                          due_latency_s: float | None = None) -> None:
        self.requests += 1
        self.latencies_s.append(latency_s)
        if due_latency_s is not None:
            self.due_latencies_s.append(due_latency_s)
        pm = self._pm(model)
        if pm is not None:
            pm["requests"] += 1
            pm["latencies_s"].append(latency_s)

    # ------------------------------------------ resilience recording

    def record_retry(self, model: str | None = None, n: int = 1) -> None:
        self.retries += n
        pm = self._pm(model)
        if pm is not None:
            pm["retries"] += n

    def record_requeue(self) -> None:
        self.requeues += 1

    def record_timeout(self) -> None:
        self.timeouts += 1

    def record_nonfinite(self) -> None:
        self.nonfinite += 1

    def record_failed(self, now: float, model: str | None = None,
                      shed: bool = False) -> None:
        """An ADMITTED request terminally failed (retry budget exhausted or
        shed with every replica dead) — counted, never silently lost."""
        self.failed += 1
        if shed:
            self.shed += 1
        self.t_last = now if self.t_last is None else max(self.t_last, now)
        pm = self._pm(model)
        if pm is not None:
            pm["failed"] += 1

    def record_probe(self, ok: bool, *, now: float | None = None,
                     replica: str | None = None, state: str | None = None,
                     backoff_s: float | None = None,
                     next_probe_at: float | None = None) -> None:
        """Count a health probe; when the supervisor passes the stamping
        kwargs, the outcome also lands in the bounded ``probe_log`` with the
        resulting state, current backoff, and the deadline of the NEXT probe
        — enough to reconstruct the DEAD→RECOVERING arc offline."""
        self.probes += 1
        if not ok:
            self.probe_failures += 1
        if now is not None or replica is not None:
            self.probe_log.append({
                "t": now, "replica": replica, "ok": ok, "state": state,
                "backoff_s": backoff_s, "next_probe_at": next_probe_at,
            })

    def record_degraded_batch(self) -> None:
        self.degraded_batches += 1

    def record_transition(self, now: float, replica: str, old: str,
                          new: str, reason: str, *,
                          backoff_s: float | None = None,
                          next_probe_at: float | None = None) -> None:
        self.transitions.append({
            "t": now, "replica": replica, "old": old, "new": new,
            "reason": reason, "backoff_s": backoff_s,
            "next_probe_at": next_probe_at,
        })
        key = f"{old}->{new}"
        self.transition_counts[key] = self.transition_counts.get(key, 0) + 1

    # ---------------------------------------------------------- summaries

    @property
    def pad_waste(self) -> float:
        """Fraction of dispatched rows that were padding."""
        return (self.padded - self.samples) / self.padded if self.padded else 0.0

    @property
    def elapsed_s(self) -> float:
        if self.t_first is None or self.t_last is None:
            return 0.0
        return max(self.t_last - self.t_first, 0.0)

    def latency_percentiles(self) -> dict:
        return _percentiles(self.latencies_s)

    def publish(self, tracer=None, prefix: str = "serve") -> None:
        """Flatten the current counters, gauges, and latency series into an
        obs :class:`~repro_torch.obs.trace.Tracer` (the process-global one
        by default) so :func:`repro_torch.obs.export.prometheus_text`
        exposes serving next to training. Counters are published as
        absolute totals (gauge-set, not incremented) so repeated publishes
        are idempotent."""
        tr = tracer if tracer is not None else get_tracer()
        s = self.summary()
        for key in ("admitted", "requests", "samples", "batches", "rejected",
                    "malformed", "expired", "failed", "recompiles", "retries",
                    "requeues", "timeouts", "nonfinite", "shed", "probes",
                    "probe_failures", "degraded_batches"):
            tr.gauge(f"{prefix}.{key}_total", float(s[key]))
        for key in ("requests_per_s", "samples_per_s", "pad_waste",
                    "elapsed_s", "batch_wall_s"):
            tr.gauge(f"{prefix}.{key}", float(s[key]))
        for edge, n in self.transition_counts.items():
            tr.gauge(f"{prefix}.transition.{edge}", float(n))
        for name, series in ((f"{prefix}.latency_s", self.latencies_s),
                             (f"{prefix}.due_latency_s",
                              self.due_latencies_s),
                             (f"{prefix}.expired_residence_s",
                              self.expired_residence_s)):
            tr.observations.pop(name, None)  # republish, don't duplicate
            for v in series:
                tr.observe(name, v)

    def conservation(self) -> dict:
        """The terminal-state ledger: every admitted request must end as
        exactly one of done/expired/failed (rejected and malformed requests
        were never admitted). ``resolved`` is the sum; a drained engine must
        show ``admitted == resolved`` — the engine-level ``conservation()``
        adds the still-queued term for mid-run checks."""
        return {
            "admitted": self.admitted,
            "done": self.requests,
            "expired": self.expired,
            "failed": self.failed,
            "rejected": self.rejected,
            "malformed": self.malformed,
            "resolved": self.requests + self.expired + self.failed,
        }

    def summary(self) -> dict:
        el = self.elapsed_s
        per_model = {}
        for name, pm in self.per_model.items():
            per_model[name] = {
                k: v for k, v in pm.items() if k != "latencies_s"
            }
            per_model[name]["latency_s"] = _percentiles(pm["latencies_s"])
            per_model[name]["samples_per_s"] = (
                pm["samples"] / el if el else 0.0
            )
        return {
            "admitted": self.admitted,
            "requests": self.requests,
            "samples": self.samples,
            "batches": self.batches,
            "bucket_batches": dict(sorted(self.bucket_batches.items())),
            "rejected": self.rejected,
            "malformed": self.malformed,
            "expired": self.expired,
            "expired_residence_s": _percentiles(self.expired_residence_s),
            "failed": self.failed,
            "recompiles": self.recompiles,
            "retries": self.retries,
            "requeues": self.requeues,
            "timeouts": self.timeouts,
            "nonfinite": self.nonfinite,
            "shed": self.shed,
            "probes": self.probes,
            "probe_failures": self.probe_failures,
            "degraded_batches": self.degraded_batches,
            "replica_transitions": dict(self.transition_counts),
            "elapsed_s": el,
            "batch_wall_s": self.batch_wall_s,
            "requests_per_s": self.requests / el if el else 0.0,
            "samples_per_s": self.samples / el if el else 0.0,
            "pad_waste": self.pad_waste,
            "latency_s": self.latency_percentiles(),
            "due_latency_s": _percentiles(self.due_latencies_s),
            "per_model": per_model,
        }

    def describe(self) -> str:
        s = self.summary()
        lat = s["latency_s"]
        lines = [
            f"{s['requests']} reqs / {s['samples']} samples in "
            f"{s['elapsed_s'] * 1e3:.1f} ms "
            f"({s['samples_per_s']:.0f} samples/s, {s['batches']} batches, "
            f"pad waste {s['pad_waste'] * 100:.1f}%, "
            f"{s['rejected']} rejected, {s['expired']} expired, "
            f"{s['failed']} failed, {s['recompiles']} compiles) | "
            f"latency ms p50 {lat['p50'] * 1e3:.1f} "
            f"p95 {lat['p95'] * 1e3:.1f} p99 {lat['p99'] * 1e3:.1f}"
        ]
        if (self.retries or self.timeouts or self.requeues or self.probes
                or self.degraded_batches or self.transitions):
            lines.append(
                f"resilience: {s['retries']} retries, {s['requeues']} "
                f"requeues, {s['timeouts']} timeouts, {s['nonfinite']} "
                f"non-finite, {s['shed']} shed, {s['probes']} probes "
                f"({s['probe_failures']} failed), "
                f"{s['degraded_batches']} degraded batches, transitions "
                f"{s['replica_transitions']}"
            )
        for name, pm in sorted(s["per_model"].items()):
            plat = pm["latency_s"]
            lines.append(
                f"  [{name}] {pm['requests']} reqs / {pm['samples']} samples "
                f"({pm['samples_per_s']:.0f} samples/s), "
                f"{pm['retries']} retries, {pm['failed']} failed, "
                f"{pm['expired']} expired, {pm['rejected']} rejected | "
                f"latency ms p50 {plat['p50'] * 1e3:.1f} "
                f"p99 {plat['p99'] * 1e3:.1f}"
            )
        return "\n".join(lines)
