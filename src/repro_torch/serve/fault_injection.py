"""Deterministic fault-injection harness for the serving stack. Mirrors
``repro/serve/fault_injection.py``.

The training twin (:mod:`repro_torch.train.fault_injection`) injects the
trainer's failures through its one seam; this module does the same for
serving, on the :class:`~repro_torch.serve.replica.Replica` dispatch seam,
so every failure response the
:class:`~repro_torch.serve.supervisor.ReplicaSupervisor` promises is
machine-checked:

  failure                                 injection here
  ------------------------------------    ------------------------------------
  replica crash (hard failure)            ``ServeFaultPlan.crash_at`` -- the
                                          replica raises :class:`ReplicaCrash`
                                          at dispatch N and on every later
                                          dispatch AND probe (it is down);
                                          the supervisor must requeue the
                                          batch and finish it elsewhere
  replica hang / straggler                ``ServeFaultPlan.hang_at`` -- the
                                          dispatch stalls ``hang_s`` (fake
                                          clocks advance, real clocks sleep)
                                          and then *returns*; the timeout
                                          must discard the late result,
                                          requeue, and mark the replica
                                          SUSPECT
  transient error (flaky link/runtime)    ``ServeFaultPlan.transient_at`` --
                                          one dispatch raises
                                          :class:`TransientDispatchError`;
                                          the next succeeds, so the replica
                                          must bounce SUSPECT -> HEALTHY
  poisoned output (bad node, SDC)         ``ServeFaultPlan.nan_at`` -- the
                                          dispatch completes but its first
                                          output plane is NaN; the finiteness
                                          guard must retry the batch, and the
                                          poisoned plane is never served
  replica restart / recovery              ``ServeFaultPlan.revive_after_probes``
                                          -- the Nth health probe of a crashed
                                          replica succeeds (DEAD ->
                                          RECOVERING -> HEALTHY)

Faults fire at exact per-replica dispatch indices (``Replica.dispatches``
counts from 1; probes count separately), so a chaos run is as reproducible
as a clean one. The injector is the ``dispatch_hook`` a replica takes at
construction: it runs on the host before the replica's graph replays, and
a poisoned plane is written into the host copy of the output, never into
the graph's buffers. Nothing on the production path imports this module.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class ReplicaCrash(RuntimeError):
    """An injected hard replica failure (the serving stand-in for a chip
    or host dying under the engine)."""


class TransientDispatchError(RuntimeError):
    """An injected one-shot dispatch failure (a flaky link or runtime hiccup):
    the same replica's next dispatch succeeds."""


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """Which replica faults fire at which per-replica dispatch indices.

    ``crash_at`` / ``transient_at`` / ``nan_at`` are tuples of
    ``(replica_id, dispatch_index)``; ``hang_at`` adds the stall length:
    ``(replica_id, dispatch_index, hang_s)``. ``revive_after_probes`` is
    ``(replica_id, n)``: the n-th probe after the crash succeeds.
    """

    crash_at: tuple = ()
    hang_at: tuple = ()
    transient_at: tuple = ()
    nan_at: tuple = ()
    revive_after_probes: tuple = ()


class ServeFaultInjector:
    """Drives a :class:`ServeFaultPlan` through the replica dispatch seam.

    Usage::

        plan = ServeFaultPlan(crash_at=(("r1", 3),))
        inj = ServeFaultInjector(plan, clock=clock)
        replicas = [Replica("r0", dispatch_hook=inj.hook),
                    Replica("r1", dispatch_hook=inj.hook)]
        sup = ReplicaSupervisor(replicas, policy, clock=clock)

    ``clock`` — pass the engine's injected clock when it is a fake one
    (anything with an ``advance`` method): hangs then advance it
    deterministically instead of sleeping. ``fired`` records what actually
    triggered, so tests can assert the fault landed where the plan said.
    """

    def __init__(self, plan: ServeFaultPlan, *, clock=None):
        self.plan = plan
        self.clock = clock
        self.fired: list = []
        self.crashed: set = set()
        self._crash = {tuple(k) for k in plan.crash_at}
        self._hang = {(r, i): float(s) for r, i, s in plan.hang_at}
        self._transient = {tuple(k) for k in plan.transient_at}
        self._nan = {tuple(k) for k in plan.nan_at}
        self._revive = dict(plan.revive_after_probes)
        self._probes_down: dict = {}   # replica_id -> probes while crashed

    def _stall(self, seconds: float) -> None:
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(seconds)
        else:
            time.sleep(seconds)

    def hook(self, replica, index: int, name: str, bucket: int, *,
             probe: bool = False):
        """The replica dispatch seam (see
        :class:`~repro_torch.serve.replica.Replica`): raises to fail the
        dispatch, returns an output transform to poison it, or returns None
        to let it through."""
        rid = replica.replica_id
        if probe:
            if rid in self.crashed:
                n = self._probes_down[rid] = self._probes_down.get(rid, 0) + 1
                revive = self._revive.get(rid)
                if revive is not None and n >= revive:
                    self.crashed.discard(rid)
                    self.fired.append(("revive", rid, n))
                    return None
                raise ReplicaCrash(f"{rid} is down (probe {n} refused)")
            return None
        if rid in self.crashed:
            raise ReplicaCrash(f"{rid} is down")
        key = (rid, index)
        if key in self._crash:
            self.crashed.add(rid)
            self.fired.append(("crash", rid, index))
            raise ReplicaCrash(f"injected crash on {rid} at dispatch {index}")
        if key in self._hang:
            self.fired.append(("hang", rid, index))
            self._stall(self._hang[key])
            return None   # completes LATE: the timeout must discard it
        if key in self._transient:
            self.fired.append(("transient", rid, index))
            raise TransientDispatchError(
                f"injected transient error on {rid} at dispatch {index}"
            )
        if key in self._nan:
            self.fired.append(("nan", rid, index))

            def poison(out):
                out = torch.as_tensor(out).clone()
                out[0] = float("nan")   # one whole output plane
                return out

            return poison
        return None
