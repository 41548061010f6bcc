"""Resilient multi-replica serving: health-checked dispatch with retry,
timeout, backoff and graceful degradation. Mirrors
``repro/serve/supervisor.py``.

The :class:`ReplicaSupervisor` keeps the
:class:`~repro_torch.serve.gan_engine.GanEngine`'s admission half (queues,
buckets, FIFO fairness, deadlines; it *is* a ``GanEngine`` subclass) and
replaces the execution half: every packed bucket is routed to a routable
:class:`~repro_torch.serve.replica.Replica`, and every dispatch outcome
feeds a per-replica health state machine::

                 success                failure
    HEALTHY  ──────────────► HEALTHY   ────────► SUSPECT
    SUSPECT  ──────────────► HEALTHY   ────────► DEAD
    RECOVERING ────────────► HEALTHY   ────────► DEAD
    SUSPECT  ── probe ok ──► HEALTHY   ── probe bad ──► DEAD
    DEAD     ── probe ok ──► RECOVERING
             ── probe bad ─► DEAD (backoff doubles: circuit breaker)

Failure responses:

* **timeout** -- each dispatch gets a per-(model, bucket) deadline from the
  walls measured at warm-up (``timeout_factor`` x the slowest replica's
  synced call wall, floored at ``min_timeout_s``; or the explicit
  ``timeout_s``). A dispatch past its deadline is a straggler: its result
  is discarded, the replica goes SUSPECT and the batch is requeued.
* **retry / requeue** -- a failed batch goes back to the head of its
  model's queue (requeued requests keep their ``t_submit``) and the next
  step routes it to a healthy replica. Each requeue increments every
  member's ``retries``; a request past ``retry_budget`` terminally fails.
* **circuit breaker** -- a DEAD replica is probed again only after an
  exponentially growing backoff (``probe_backoff_s`` doubling up to
  ``probe_backoff_max_s``); a good probe moves it to RECOVERING, and one
  successful real dispatch re-earns HEALTHY.
* **output guard** -- every dispatched output's host copy (replica or
  inline) must be finite; a NaN/Inf plane is a dispatch failure and the
  batch is retried: a poisoned output is never served.
* **graceful degradation** -- with every replica dead and none revivable
  now, ``degraded_mode="inline"`` runs the batch on the supervisor's own
  executables (on the card each captures its CUDA graph at its first
  call, counted in the recompile counter); ``"shed"`` terminally fails the
  batch. Either way ``step()`` returns and the conservation ledger holds.

The engine's invariants carry over: FIFO fairness, and served outputs
bitwise equal to an unbatched ``generator_apply`` on the same device
(every replica runs the same batch-invariant plans; the reference is off
by about 1 ulp on its CPU here, the port is not). Zero steady-state builds
hold per replica (``Replica.recompiles``). The transitions land in
``metrics.transitions`` and, while tracing, as ``replica.transition``
events beside the ``serve.dispatch`` and ``serve.probe`` spans; a flight
recorder (``recorder=``) dumps at a replica's death (``replica_dead:<id>``)
and at a non-finite output (``nonfinite:<id>``).

Departures from the reference: there is no ``dtype=`` (the port serves
fp32), and the replicas' ``device`` must be the supervisor's. ``train``
and ``fuse`` (default ``"auto"``, the autotune cache's pair race) are the
engine's, for the inline executables.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time

import torch

from repro_torch.obs import trace as obs
from repro_torch.serve.gan_engine import GanEngine
from repro_torch.serve.replica import Replica


class ReplicaState(enum.Enum):
    HEALTHY = "HEALTHY"
    SUSPECT = "SUSPECT"
    DEAD = "DEAD"
    RECOVERING = "RECOVERING"


class DispatchTimeout(RuntimeError):
    """A dispatch exceeded its per-(model, bucket) deadline."""


class NonFiniteOutput(RuntimeError):
    """A dispatch returned NaN/Inf rows — retried, never served."""


@dataclasses.dataclass
class _ReplicaSlot:
    replica: Replica
    state: ReplicaState = ReplicaState.HEALTHY
    backoff_s: float = 0.0        # current probe backoff (DEAD only)
    next_probe_at: float = 0.0    # clock time the next probe is due


class ReplicaSupervisor(GanEngine):
    """Routes packed buckets across health-tracked replicas (see module
    docstring). Construction takes the replicas; :meth:`register` fans each
    model out to every replica (plus the inline-fallback slot the base
    engine keeps), and :meth:`warmup` warms every replica and derives the
    dispatch timeouts from the measured call walls."""

    def __init__(self, replicas, policy=None, *, retry_budget: int = 2,
                 timeout_s: float | None = None, timeout_factor: float = 8.0,
                 min_timeout_s: float = 0.05, probe_backoff_s: float = 0.05,
                 probe_backoff_max_s: float = 5.0,
                 degraded_mode: str = "inline", device=None,
                 train: bool = False, fuse="auto", clock=time.monotonic,
                 recorder=None):
        super().__init__(policy, device=device, train=train, fuse=fuse,
                         clock=clock, recorder=recorder)
        replicas = list(replicas)
        if not replicas:
            raise ValueError("supervisor needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"replica ids must be unique, got {ids}")
        for r in replicas:
            if r.device != self.device:
                raise ValueError(
                    f"replica {r.replica_id!r} runs on {r.device}, the "
                    f"supervisor on {self.device}"
                )
        if degraded_mode not in ("inline", "shed"):
            raise ValueError(
                f"degraded_mode must be 'inline' or 'shed', "
                f"got {degraded_mode!r}"
            )
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        self.rslots = {r.replica_id: _ReplicaSlot(replica=r)
                       for r in replicas}
        self.retry_budget = int(retry_budget)
        self.timeout_s = timeout_s
        self.timeout_factor = float(timeout_factor)
        self.min_timeout_s = float(min_timeout_s)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.degraded_mode = degraded_mode
        self._rr = itertools.count()
        self._baseline_s: dict = {}   # (model, bucket) -> max replica wall

    # ----------------------------------------------------------- registry

    def register(self, cfg, params: dict, *, name: str | None = None) -> str:
        name = super().register(cfg, params, name=name)
        for slot in self.rslots.values():
            slot.replica.register(cfg, params, name=name)
        return name

    def warmup(self, registry_path=None) -> None:
        """Warm every replica's (model, bucket) executables and derive the
        per-batch dispatch timeouts from the measured call walls (the max
        across replicas, so a healthy-but-slower replica is not branded a
        straggler). The supervisor's own inline-fallback executables stay
        cold: they are built only if degradation happens, and the
        recompile counter shows that cost when it does."""
        del registry_path   # replicas compile their own plans
        for slot in self.rslots.values():
            slot.replica.warmup(self.policy.buckets)
            for key, wall in slot.replica.baseline_s.items():
                self._baseline_s[key] = max(
                    self._baseline_s.get(key, 0.0), wall
                )
        self.warmup_recompiles = self.metrics.recompiles

    @property
    def replica_recompiles(self) -> dict:
        """Per-replica recompile counters (zero growth after warmup is the
        per-replica steady-state invariant)."""
        return {rid: s.replica.recompiles for rid, s in self.rslots.items()}

    def replica_states(self) -> dict:
        return {rid: s.state.value for rid, s in self.rslots.items()}

    def timeout_for(self, name: str, bucket: int) -> float:
        """The dispatch deadline for one (model, bucket): the explicit
        ``timeout_s`` override, or ``timeout_factor`` x the warmed call
        wall, floored at ``min_timeout_s``."""
        if self.timeout_s is not None:
            return self.timeout_s
        base = self._baseline_s.get((name, bucket), 0.0)
        return max(self.min_timeout_s, self.timeout_factor * base)

    # ------------------------------------------------------- health logic

    def _transition(self, slot: _ReplicaSlot, new: ReplicaState,
                    reason: str, now: float) -> None:
        old = slot.state
        if old is new:
            return
        slot.state = new
        if new in (ReplicaState.DEAD, ReplicaState.SUSPECT):
            slot.backoff_s = self.probe_backoff_s
            slot.next_probe_at = now + slot.backoff_s
        rid = slot.replica.replica_id
        # record AFTER the backoff update so the log entry carries the
        # deadline of the next probe (the DEAD->RECOVERING arc is
        # reconstructable offline)
        self.metrics.record_transition(
            now, rid, old.value, new.value, reason,
            backoff_s=slot.backoff_s, next_probe_at=slot.next_probe_at,
        )
        obs.event("replica.transition", replica=rid, old=old.value,
                  new=new.value, reason=reason)
        if self.recorder is not None:
            self.recorder.record(
                "replica.transition", replica=rid, old=old.value,
                new=new.value, reason=reason, backoff_s=slot.backoff_s,
                next_probe_at=slot.next_probe_at,
            )
            if new is ReplicaState.DEAD:
                self.recorder.dump(
                    f"replica_dead:{rid}",
                    extra={"states": self.replica_states(),
                           "conservation": self.metrics.conservation()},
                )

    def _on_dispatch_success(self, slot: _ReplicaSlot, now: float) -> None:
        self._transition(slot, ReplicaState.HEALTHY, "dispatch ok", now)

    def _on_dispatch_failure(self, slot: _ReplicaSlot, reason: str,
                             now: float) -> None:
        if slot.state is ReplicaState.HEALTHY:
            self._transition(slot, ReplicaState.SUSPECT, reason, now)
        else:   # SUSPECT or RECOVERING: second strike
            self._transition(slot, ReplicaState.DEAD, reason, now)

    def _probe_due(self, now: float) -> None:
        """Probe SUSPECT and DEAD replicas whose backoff has elapsed.

        A SUSPECT replica that real traffic is avoiding (healthy peers
        absorb it all) would otherwise linger unresolved — a due probe
        settles it: ok -> HEALTHY, failed -> DEAD. A DEAD replica is the
        circuit breaker: probe ok -> RECOVERING (one successful real
        dispatch re-earns HEALTHY); probe failed -> backoff doubles,
        capped at ``probe_backoff_max_s``."""
        for slot in self.rslots.values():
            if slot.state not in (ReplicaState.DEAD, ReplicaState.SUSPECT):
                continue
            if now < slot.next_probe_at:
                continue
            with obs.span("serve.probe", replica=slot.replica.replica_id):
                try:
                    ok = slot.replica.probe()
                except Exception:
                    ok = False
            if ok:
                new = (ReplicaState.HEALTHY
                       if slot.state is ReplicaState.SUSPECT
                       else ReplicaState.RECOVERING)
                self._transition(slot, new, "probe ok", now)
            else:
                if slot.state is ReplicaState.SUSPECT:
                    self._transition(slot, ReplicaState.DEAD,
                                     "probe failed", now)
                else:
                    slot.backoff_s = min(slot.backoff_s * 2,
                                         self.probe_backoff_max_s)
                    slot.next_probe_at = self.clock() + slot.backoff_s
            # stamp the outcome AFTER the state/backoff update: the log
            # entry carries the resulting state and the next probe's
            # deadline
            self.metrics.record_probe(
                ok, now=now, replica=slot.replica.replica_id,
                state=slot.state.value, backoff_s=slot.backoff_s,
                next_probe_at=slot.next_probe_at,
            )

    def _pick_replica(self, now: float) -> _ReplicaSlot | None:
        """An idle routable replica: HEALTHY and RECOVERING share the
        primary pool (a RECOVERING replica just passed a probe — real
        traffic is how it re-earns HEALTHY; keeping it starved behind
        healthy peers would strand it RECOVERING forever), SUSPECT is the
        last resort, round-robin within a pool for balance. DEAD replicas
        are never routed real traffic — only probes."""
        self._probe_due(now)
        for states in ((ReplicaState.HEALTHY, ReplicaState.RECOVERING),
                       (ReplicaState.SUSPECT,)):
            pool = [s for s in self.rslots.values() if s.state in states]
            if pool:
                return pool[next(self._rr) % len(pool)]
        return None

    # ----------------------------------------------------------- dispatch

    def _execute(self, name: str, reqs: list, bucket: int) -> None:
        """One routed dispatch attempt for one packed bucket. On failure
        (seam exception, timeout, non-finite output) the batch is requeued
        at the queue head under the retry budget and the next step retries
        it on a healthy replica; with no routable replica the batch takes
        the degradation path. Every path terminally resolves or strictly
        consumes retry budget, so the loop can never spin forever."""
        z, n_real = self._pack_latents(reqs, bucket)
        rslot = self._pick_replica(self.clock())
        if rslot is None:
            self._degrade(name, reqs, z, n_real, bucket)
            return
        t0 = self.clock()
        tracing = obs.enabled()
        if tracing:
            for r in reqs:
                self._tl(r.rid, "dispatch", t0, model=name, bucket=bucket,
                         replica=rslot.replica.replica_id)
        try:
            with (obs.span("serve.dispatch", model=name, bucket=bucket,
                           n_real=n_real, replica=rslot.replica.replica_id)
                  if tracing else obs.NOOP_SPAN):
                out = rslot.replica.execute(name, z, bucket)
        except Exception as e:
            self._dispatch_failed(rslot, name, reqs,
                                  type(e).__name__, self.clock())
            return
        elapsed = self.clock() - t0
        if elapsed > self.timeout_for(name, bucket):
            # straggler: the result is past its deadline — discard it
            # (never serve output the client's retry may already race)
            self.metrics.record_timeout()
            self._dispatch_failed(rslot, name, reqs, "timeout",
                                  self.clock())
            return
        if not bool(torch.isfinite(out).all()):
            self.metrics.record_nonfinite()
            if self.recorder is not None:
                self.recorder.record(
                    "nonfinite", replica=rslot.replica.replica_id,
                    model=name, bucket=bucket,
                )
                self.recorder.dump(
                    f"nonfinite:{rslot.replica.replica_id}",
                    extra={"model": name, "bucket": bucket},
                )
            self._dispatch_failed(rslot, name, reqs, "non-finite output",
                                  self.clock())
            return
        self._on_dispatch_success(rslot, self.clock())
        self._finalize(name, reqs, out, n_real, bucket, t0,
                       replica=rslot.replica.replica_id)

    def _dispatch_failed(self, rslot: _ReplicaSlot, name: str, reqs: list,
                         reason: str, now: float) -> None:
        """Health-account the failure, then requeue the batch at the head
        of its model queue under the per-request retry budget; requests
        past the budget terminally fail (counted — never silently lost)."""
        self._on_dispatch_failure(rslot, reason, now)
        survivors = []
        for r in reqs:
            r.retries += 1
            self.metrics.record_retry(name)
            if r.retries > self.retry_budget:
                r.failed = True
                r.t_done = now
                self.metrics.record_failed(now, model=name)
                self._tl(r.rid, "fail", now, model=name, reason=reason,
                         retries=r.retries)
            else:
                survivors.append(r)
                self._tl(r.rid, "retry", now, model=name, reason=reason,
                         attempt=r.retries)
        if survivors:
            self.registry[name].queue.extendleft(reversed(survivors))
            self.metrics.record_requeue()

    def _degrade(self, name: str, reqs: list, z, n_real: int,
                 bucket: int) -> None:
        """All replicas dead and none revivable right now. Never hang:
        ``inline`` runs the batch on the supervisor's own executables (built
        at first use, visible in the recompile counter); ``shed`` -- or an
        inline attempt that itself fails or returns non-finite rows --
        terminally fails the batch (bounded shedding)."""
        now = self.clock()
        if self.degraded_mode == "inline":
            slot = self.registry[name]
            t0 = self.clock()
            try:
                out = self._executable(name, bucket)(
                    slot.params, torch.from_numpy(z)
                ).cpu()
            except Exception:
                out = None
            if out is not None and bool(torch.isfinite(out).all()):
                self.metrics.record_degraded_batch()
                self._finalize(name, reqs, out, n_real, bucket, t0,
                               replica="inline")
                return
        for r in reqs:
            r.failed = True
            r.t_done = now
            self.metrics.record_failed(now, model=name, shed=True)
            self._tl(r.rid, "fail", now, model=name, reason="shed")

    # ------------------------------------------------------------ display

    def describe_replicas(self) -> str:
        lines = []
        for rid, slot in self.rslots.items():
            lines.append(f"[{slot.state.value:>10}] {slot.replica.describe()}")
        return "\n".join(lines)
