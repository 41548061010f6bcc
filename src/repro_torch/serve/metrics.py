"""Serving metrics. Mirrors ``repro/serve/metrics.py``.

Throughput, latency percentiles, pad waste and recompiles of the
serving engine.

One :class:`ServeMetrics` instance rides inside each engine. Everything is
recorded in plain Python (no device sync beyond what the engine already
does), so the overhead per batch is a few dict updates.

The four signals the bucket policy is tuned against:

* **throughput** — completed samples (and requests) per second of serving
  wall time (first admission to last completion).
* **latency percentiles** — p50/p95/p99 of request completion latency
  (admission to output ready). The max-wait deadline bounds the queueing
  component; bucket sizes trade the execution component against pad waste.
* **pad-waste fraction** — padded-but-discarded rows / dispatched rows.
  High pad waste means the bucket set is too coarse for the traffic's size
  distribution (or ``max_wait_s`` is too small, flushing half-empty).
* **recompile counter** — incremented once per executable the engine
  builds (a plan resolved for one (model, bucket)). After warmup this must
  stay flat: a moving counter in steady state means some (model, bucket,
  dtype) signature was not warmed and a request paid its build inline.

The reference's resilience counters (retries, requeues, timeouts,
nonfinite, failed, shed, probes, probe_failures, degraded_batches) come
across as plain fields, zero until the replica supervisor is ported.

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

Percentiles come from :func:`percentiles` below (the reference shares
:func:`repro.obs.trace.percentiles`; the port keeps its own copy).
Publishing to an observability registry waits for the port of
``repro.obs``.
"""
from __future__ import annotations

import numpy as np


def percentiles(values) -> dict:
    """``{p50, p95, p99, mean, max}`` of ``values`` (all 0.0 when empty)."""
    if len(values) == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    a = np.asarray(values)
    return {
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
        "mean": float(a.mean()),
        "max": float(a.max()),
    }


class ServeMetrics:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.latencies_s: list = []       # per completed request
        self.batches: int = 0             # dispatches
        self.samples: int = 0             # real rows dispatched
        self.padded: int = 0              # total rows dispatched (incl. pad)
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
        self.batch_wall_s += wall_s
        self.t_last = now
        pm = self._pm(model)
        if pm is not None:
            pm["batches"] += 1
            pm["samples"] += n_real

    def record_completion(self, latency_s: float,
                          model: str | None = None) -> None:
        self.requests += 1
        self.latencies_s.append(latency_s)
        pm = self._pm(model)
        if pm is not None:
            pm["requests"] += 1
            pm["latencies_s"].append(latency_s)

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
        return percentiles(self.latencies_s)

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
            per_model[name]["latency_s"] = percentiles(pm["latencies_s"])
            per_model[name]["samples_per_s"] = (
                pm["samples"] / el if el else 0.0
            )
        return {
            "admitted": self.admitted,
            "requests": self.requests,
            "samples": self.samples,
            "batches": self.batches,
            "rejected": self.rejected,
            "malformed": self.malformed,
            "expired": self.expired,
            "expired_residence_s": percentiles(self.expired_residence_s),
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
            "elapsed_s": el,
            "batch_wall_s": self.batch_wall_s,
            "requests_per_s": self.requests / el if el else 0.0,
            "samples_per_s": self.samples / el if el else 0.0,
            "pad_waste": self.pad_waste,
            "latency_s": self.latency_percentiles(),
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
