"""Plan-served GAN inference engine: bucketed dynamic batching over
precompiled :class:`~repro_torch.kernels.plan.TconvPlan`s. Mirrors
``GenRequest``, ``GanEngine`` and ``sequential_executables`` of
``repro/serve/gan_engine.py``.

1. **warmup** -- for every registered model and every policy bucket,
   resolve the whole-generator plan
   (:func:`~repro_torch.kernels.plan.compile_plan_buckets` from the
   autotune cache, fused epilogues included, and adjacent layers fused into
   pair launches as ``fuse`` says) or adopt it from a plan registry
   (:mod:`repro_torch.kernels.plan_registry`, written by
   :meth:`GanEngine.save_plans`), build its executable and run it once on
   zero latents. Each executable built increments the metrics recompile
   counter, so a flat counter after warmup shows that steady-state serving
   builds nothing.
2. **admit** -- requests (``n`` latent rows for one model) enter a
   per-model FIFO queue, or are rejected with
   :class:`~repro_torch.serve.batching.QueueFull` past the queued-sample
   bound (backpressure).
3. **bucket + execute + recycle** -- the step loop serves the model whose
   head request is oldest, packs whole head-of-queue requests into the
   smallest bucket that holds them (padding with zero rows), runs the
   executable on the device, and hands each request its slice as a CPU
   tensor. A max-wait deadline flushes partial batches.

The engine runs on the CUDA card unless constructed with another device.
On the card each executable is one CUDA graph (:mod:`repro_torch.graphs`),
the counterpart of the reference's ``jax.jit``: the buckets of one model
share a memory pool, the registered parameters are captured by address
(an executable called with any other parameters raises), and a call
copies the padded latents into the graph's static input, replays, and
copies the static output to the host before the next replay (of any of
the model's graphs, which share their pool) can overwrite it. On the CPU
each executable runs the generator eagerly.

Observability (:mod:`repro_torch.obs`), as in the reference: while tracing
is enabled the engine records each request's lifecycle in
:attr:`GanEngine.timeline` and the spans ``serve.pack``,
``serve.dispatch`` (the executable's call, the graph's replay on the card,
and the host copy of its output, the one sync a batch has) and
``serve.slice``, with the counters ``serve.admitted``,
``serve.completed``, ``serve.rejected``, ``serve.expired`` and
``serve.malformed`` and the observation ``serve.batch_wall_s``. The port
adds the spans :data:`PORT_SPANS`, so that every instant of a
:meth:`GanEngine.replay` lies under a span: ``serve.admit`` (a loop pass's
submits), ``serve.step`` (a :meth:`GanEngine.step`), ``serve.wait`` (the
idle sleep), the children ``serve.launch``, ``serve.sync`` and
``serve.copy_out`` of this engine's ``serve.dispatch``, and ``host.gc``
(a collector pass during the replay; ``host.gc.hook`` marks the hook).
With tracing off each seam is one flag check. The
:class:`~repro_torch.serve.supervisor.ReplicaSupervisor` subclasses this
engine and routes the packed batches across replicas.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_plan_apply
from repro_torch.graphs import CudaGraph, require_captured
from repro_torch.kernels.plan import (
    check_fuse,
    compile_plan_buckets,
    plan_follows_fuse,
)
from repro_torch.kernels.plan_registry import (
    load_plan_registry,
    save_plan_registry,
)
from repro_torch.models.gan import generator_apply, generator_epilogues
from repro_torch.obs import trace as obs
from repro_torch.obs.timeline import TimelineStore
from repro_torch.serve.batching import BucketPolicy, QueueFull
from repro_torch.serve.metrics import ServeMetrics

# the spans the port records beyond the reference's (module docstring)
PORT_SPANS = frozenset(("serve.admit", "serve.step", "serve.wait",
                        "serve.launch", "serve.sync", "serve.copy_out",
                        "host.gc", "host.gc.hook"))


@dataclasses.dataclass
class GenRequest:
    """One generation request: ``n`` latent rows for one registered model.

    ``deadline_s`` (optional) is the request's maximum queueing budget in
    seconds from admission; a request still queued past it is **expired**,
    never served stale. Every request reaches exactly one terminal state:
    ``done`` (``output`` holds the samples), ``expired``, ``rejected``
    (backpressure at admission) or ``failed`` (malformed in replay mode,
    retry budget exhausted, or shed with every replica dead under the
    :class:`~repro_torch.serve.supervisor.ReplicaSupervisor`). ``t_done``
    is stamped at every terminal resolution. ``retries`` counts dispatch
    attempts beyond the first; ``replica`` records which replica (or
    ``"inline"``) served the request, when a supervisor did. ``t_due`` is
    when the request was due (:meth:`GanEngine.replay` stamps its arrival
    on the engine's clock); it stays None where unknown.
    """

    model: str
    z: object                  # (n, z_dim) latents
    deadline_s: float | None = None
    # filled by the engine:
    rid: int = -1
    t_submit: float = 0.0
    t_done: float = 0.0
    output: object = None      # (n, H, W, C) CPU tensor on completion
    done: bool = False
    expired: bool = False
    rejected: bool = False
    failed: bool = False
    retries: int = 0
    replica: str | None = None
    t_due: float | None = None

    @property
    def n(self) -> int:
        return int(np.shape(self.z)[0])

    @property
    def terminal_state(self) -> str | None:
        """``"done" | "expired" | "rejected" | "failed"``, or None while
        pending. Raises if the request is in more than one terminal state."""
        states = [s for s in ("done", "expired", "rejected", "failed")
                  if getattr(self, s)]
        if len(states) > 1:
            raise AssertionError(
                f"request {self.rid} in {len(states)} terminal states: "
                f"{states}"
            )
        return states[0] if states else None

    @property
    def latency_s(self) -> float:
        """Admission to terminal resolution (NaN while pending)."""
        if self.done or self.expired or self.failed or self.rejected:
            return self.t_done - self.t_submit
        return float("nan")


@dataclasses.dataclass
class _ModelSlot:
    cfg: object
    params: dict
    plans: dict = dataclasses.field(default_factory=dict)   # bucket -> plan
    apply: dict = dataclasses.field(default_factory=dict)   # bucket -> fn
    queue: deque = dataclasses.field(default_factory=deque)
    pool: object = None        # the buckets' shared CUDA graph memory pool


def generator_executable(params: dict, cfg, plan, batch: int, device, *,
                         pool=None, shard: bool = False, mesh=None):
    """``fn(params, z)``: the whole generator at ``batch`` under ``plan``.
    On a CUDA device one CUDA graph, captured here over ``params`` (which
    each call must pass again, the same dict) and replayed per call; its
    output is the graph's static buffer, which the next call of this
    executable, or of any other whose graph shares ``pool``, may overwrite.
    On another device the generator runs eagerly. ``shard`` runs it through
    :func:`~repro_torch.distributed.sharding.shard_plan_apply` over ``mesh``
    (else the ambient ``DeviceMesh``, read when the graph is captured), its
    collectives inside the graph."""

    def apply_fn(p, z, pl):
        return generator_apply(p, cfg, z, plan=pl, device=device)

    def run(p, z):
        if shard:
            return shard_plan_apply(apply_fn, p, z, plan, mesh=mesh)
        return apply_fn(p, z, plan)

    if device.type != "cuda":
        return run
    dtype = params["proj"]["w"].dtype
    graph = CudaGraph(
        lambda z: run(params, z),
        torch.zeros((batch, cfg.z_dim), dtype=dtype, device=device), pool=pool)

    def replay(p, z):
        require_captured(p, params, "params")
        return graph(torch.as_tensor(z, dtype=dtype))

    replay.graph = graph
    return replay


class GanEngine:
    """Bucketed dynamic-batching engine over plan-compiled generators.

    ``device`` is where the generators run (the CUDA card unless given);
    registered parameters must live there. ``train`` resolves ``auto`` from
    the autotuner's training entries (whose winner may differ by bucket).
    ``fuse`` is the plans' pair pass: ``"auto"`` (the pairs whose race the
    pair kernel won; none on a cold cache), ``"off"`` (per layer) or
    ``"force"`` (every legal adjacent pair as one pair-kernel launch). A
    bucket's CUDA graph pins the plan it captured: a retune takes effect at
    the next warm-up of a new engine. ``clock`` is injectable for
    deterministic deadline tests. ``recorder`` is an optional
    :class:`~repro_torch.obs.flight_recorder.FlightRecorder` that the
    supervisor dumps into on a replica's death or a non-finite output.
    """

    def __init__(self, policy: BucketPolicy | None = None, *, device=None,
                 train: bool = False, fuse="auto", clock=time.monotonic,
                 recorder=None):
        check_fuse(fuse)
        self.policy = policy or BucketPolicy()
        self.device = resolve_device(device)
        self.train = train
        self.fuse = fuse
        self.clock = clock
        self.metrics = ServeMetrics()
        self.registry: dict[str, _ModelSlot] = {}
        self.completed: list[GenRequest] = []   # completion order
        self.warmup_recompiles: int | None = None
        self._rid = itertools.count()
        # per-request lifecycle timelines, recorded only while tracing is
        # enabled; the flight recorder records whatever the flag says
        self.timeline = TimelineStore()
        self.recorder = recorder

    def _tl(self, rid, event: str, t: float, *, model=None, **attrs) -> None:
        """Record one request-lifecycle edge: one flag check when off. The
        hot seams check :func:`obs.enabled` once before building any
        argument (a queue depth is a scan of the queues), so with tracing
        off they evaluate and allocate nothing."""
        if not obs.enabled():
            return
        self.timeline.event(rid, event, t, model=model, **attrs)

    # ----------------------------------------------------------- registry

    def register(self, cfg, params: dict, *, name: str | None = None) -> str:
        """Add one generator (config + parameters on the engine's device).
        Call for each model to be served, then :meth:`warmup` once."""
        name = name or cfg.name
        if name in self.registry:
            raise ValueError(f"model {name!r} already registered")
        if params["proj"]["w"].device != self.device:
            raise ValueError(
                f"params live on {params['proj']['w'].device}, the engine "
                f"runs on {self.device}"
            )
        self.registry[name] = _ModelSlot(cfg=cfg, params=params)
        return name

    def warmup(self, registry_path=None) -> None:
        """Build every (model, bucket) executable and run it once on zero
        latents. Afterwards the recompile counter is frozen at
        :attr:`warmup_recompiles`.

        ``registry_path`` is the warm start: every ``"{model}:{bucket}"``
        plan the registry file holds (written by :meth:`save_plans`) is
        adopted as it is, without compiling; only the (model, bucket)
        combinations it lacks compile the normal way. A registry plan whose
        pairs do not follow the engine's ``fuse`` (one saved by a
        ``fuse="force"`` engine, adopted by a ``fuse="off"`` one, or the
        other way round; for ``"auto"``, pairs other than the cache's race
        fuses now) raises ``ValueError``."""
        if registry_path is not None:
            reg = load_plan_registry(registry_path)
            for name, slot in self.registry.items():
                for bucket in self.policy.buckets:
                    plan = reg.get(f"{name}:{bucket}")
                    if plan is None:
                        continue
                    if not plan_follows_fuse(plan, "off" if self.train
                                             else self.fuse):
                        raise ValueError(
                            f"registry plan {name}:{bucket} in "
                            f"{registry_path} was not fused as "
                            f"fuse={self.fuse!r} fuses"
                        )
                    slot.plans[bucket] = plan
        for name, slot in self.registry.items():
            for bucket in self.policy.buckets:
                fn = self._executable(name, bucket)
                fn(slot.params, torch.zeros((bucket, slot.cfg.z_dim),
                                            device=self.device))
        self._sync()
        self.warmup_recompiles = self.metrics.recompiles

    def save_plans(self, path) -> None:
        """Write every compiled (model, bucket) plan to ``path`` as a plan
        registry under ``"{model}:{bucket}"`` keys: the file
        :meth:`warmup` warm-starts from."""
        save_plan_registry(
            {f"{name}:{bucket}": plan
             for name, slot in self.registry.items()
             for bucket, plan in slot.plans.items()},
            path,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _executable(self, name: str, bucket: int):
        """The whole-generator callable ``fn(params, z)`` for one (model,
        bucket) (:func:`generator_executable`; on the card, a CUDA graph in
        the model's pool), built lazily: an un-warmed engine still serves,
        and the recompile counter shows the inline build."""
        slot = self.registry[name]
        fn = slot.apply.get(bucket)
        if fn is None:
            if bucket not in slot.plans:
                slot.plans.update(compile_plan_buckets(
                    slot.cfg, [bucket], train=self.train,
                    epilogues=generator_epilogues(slot.cfg), fuse=self.fuse,
                ))
            if self.device.type == "cuda" and slot.pool is None:
                slot.pool = torch.cuda.graph_pool_handle()
            fn = generator_executable(slot.params, slot.cfg, slot.plans[bucket],
                                      bucket, self.device, pool=slot.pool)
            slot.apply[bucket] = fn
            self.metrics.count_recompile()
        return fn

    # ---------------------------------------------------------- admission

    @property
    def queued_samples(self) -> int:
        return sum(r.n for s in self.registry.values() for r in s.queue)

    @property
    def queued_requests(self) -> int:
        return sum(len(s.queue) for s in self.registry.values())

    def submit(self, req: GenRequest) -> int:
        """Admit one request (FIFO per model). Raises :class:`QueueFull`
        past the queued-sample bound and ``ValueError`` for a malformed
        request (a request must fit one dispatch: ``n <= max_bucket``)."""
        slot = self.registry.get(req.model)
        if slot is None:
            raise ValueError(
                f"model {req.model!r} not registered "
                f"(have {sorted(self.registry)})"
            )
        n = req.n
        if np.ndim(req.z) != 2 or np.shape(req.z)[1] != slot.cfg.z_dim:
            raise ValueError(
                f"z must be (n, {slot.cfg.z_dim}), got {np.shape(req.z)}"
            )
        if n < 1:
            raise ValueError("request must carry at least one latent row")
        if n > self.policy.max_bucket:
            raise ValueError(
                f"request of {n} samples exceeds the largest bucket "
                f"{self.policy.max_bucket}; split it client-side"
            )
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {req.deadline_s}"
            )
        queued = self.queued_samples
        if queued + n > self.policy.max_queue:
            req.rejected = True
            req.t_submit = req.t_done = self.clock()
            self.metrics.record_reject(req.model)
            if obs.enabled():   # no rid is assigned before backpressure
                self._tl(f"reject#{self.metrics.rejected}", "reject",
                         req.t_done, model=req.model, n=n)
                obs.counter("serve.rejected")
            raise QueueFull(
                f"queue holds {queued} samples, request of {n} "
                f"exceeds max_queue={self.policy.max_queue}"
            )
        req.rid = next(self._rid)
        req.t_submit = self.clock()
        self.metrics.record_admit(req.t_submit, req.model)
        slot.queue.append(req)
        if obs.enabled():
            self._tl(req.rid, "admit", req.t_submit, model=req.model, n=n,
                     deadline_s=req.deadline_s)
            self._tl(req.rid, "queue", req.t_submit, depth=len(slot.queue),
                     queued_samples=queued + n)
            obs.counter("serve.admitted")
        return req.rid

    # --------------------------------------------------------------- step

    def _purge_expired(self, now: float) -> int:
        """Drop queued requests past their deadline, anywhere in a queue,
        before every dispatch decision."""
        dropped = 0
        for name, slot in self.registry.items():
            keep = deque()
            for r in slot.queue:
                if r.deadline_s is not None and now - r.t_submit > r.deadline_s:
                    r.expired = True
                    r.t_done = now
                    self.metrics.record_expired(
                        now, residence_s=now - r.t_submit, model=name
                    )
                    if obs.enabled():
                        self._tl(r.rid, "expire", now, model=name,
                                 residence_s=now - r.t_submit)
                        obs.counter("serve.expired")
                    dropped += 1
                else:
                    keep.append(r)
            slot.queue = keep
        return dropped

    def _next_model(self) -> str | None:
        """FIFO fairness across models: the queue whose head is oldest."""
        best, best_t = None, None
        for name, slot in self.registry.items():
            if slot.queue and (best_t is None
                               or slot.queue[0].t_submit < best_t):
                best, best_t = name, slot.queue[0].t_submit
        return best

    def step(self, now: float | None = None, *, drain: bool = False) -> bool:
        """One batching-loop iteration; ``drain=True`` forces a flush.
        Returns whether a batch ran."""
        if now is None:
            now = self.clock()
        self._purge_expired(now)
        name = self._next_model()
        if name is None:
            return False
        slot = self.registry[name]
        sizes = [r.n for r in slot.queue]
        if not drain and not self.policy.should_flush(
            sizes, now - slot.queue[0].t_submit
        ):
            return False
        count, bucket = self.policy.pack(sizes)
        reqs = [slot.queue.popleft() for _ in range(count)]
        self._execute(name, reqs, bucket)
        return True

    def _pack_latents(self, reqs: list, bucket: int):
        """The requests' latents, padded with zero rows up to the bucket:
        ``(z, n_real)`` with ``z`` a host array of ``bucket`` rows."""
        tracing = obs.enabled()
        if tracing:
            rids = tuple(r.rid for r in reqs)
        with (obs.span("serve.pack", bucket=bucket, reqs=len(reqs), rids=rids)
              if tracing else obs.NOOP_SPAN):
            z = np.concatenate(
                [np.asarray(r.z, dtype=np.float32) for r in reqs], axis=0
            )
            n_real = z.shape[0]
            if n_real < bucket:
                z = np.concatenate(
                    [z, np.zeros((bucket - n_real, z.shape[1]), z.dtype)],
                    axis=0,
                )
        if tracing:
            self.timeline.batch(rids, "pack", self.clock(),
                                model=reqs[0].model, bucket=bucket,
                                n_real=n_real)
        return z, n_real

    def _finalize(self, name: str, reqs: list, out: torch.Tensor,
                  n_real: int, bucket: int, t0: float, *,
                  replica: str | None = None) -> None:
        """Record the batch and hand each request its contiguous rows; pad
        rows never reach a client."""
        tracing = obs.enabled()
        with (obs.span("serve.slice", model=name, reqs=len(reqs))
              if tracing else obs.NOOP_SPAN):
            now = self.clock()
            self.metrics.record_batch(n_real, bucket, now - t0, now, model=name)
            row = 0
            for r in reqs:
                r.output = out[row : row + r.n]
                row += r.n
                r.done = True
                r.t_done = now
                r.replica = replica
                self.metrics.record_completion(
                    r.latency_s, model=name,
                    due_latency_s=None if r.t_due is None else now - r.t_due)
                self.completed.append(r)
            if tracing:
                rids = [r.rid for r in reqs]
                self.timeline.batch(rids, "slice", now, model=name,
                                    per={"rows": [r.n for r in reqs]})
                self.timeline.batch(
                    rids, "reply", now, model=name,
                    per={"latency_s": [r.latency_s for r in reqs]},
                    replica=replica)
                obs.counter("serve.completed", len(reqs))
                obs.observe("serve.batch_wall_s", now - t0)

    def _execute(self, name: str, reqs: list, bucket: int) -> None:
        """Pad-and-mask dispatch: run the executable on the packed latents
        (copied to the device), wait for it, and slice the CPU copy per
        request. The copy is taken before the next call, which on the card
        overwrites the graph's output. The
        :class:`~repro_torch.serve.supervisor.ReplicaSupervisor` overrides
        this method (same pack and finalize helpers) to route the batch
        through health-checked replicas."""
        slot = self.registry[name]
        z, n_real = self._pack_latents(reqs, bucket)
        t0 = self.clock()
        tracing = obs.enabled()
        if tracing:
            self.timeline.batch([r.rid for r in reqs], "dispatch", t0,
                                model=name, bucket=bucket)
            dispatch = obs.span("serve.dispatch", model=name, bucket=bucket,
                                n_real=n_real)
            launch, sync = obs.span("serve.launch"), obs.span("serve.sync")
            copy_out = obs.span("serve.copy_out")
        else:
            dispatch = launch = sync = copy_out = obs.NOOP_SPAN
        with dispatch:
            with launch:
                out = self._executable(name, bucket)(slot.params,
                                                     torch.from_numpy(z))
            with sync:
                self._sync()
            with copy_out:
                out = out.cpu()
        self._finalize(name, reqs, out, n_real, bucket, t0)

    # -------------------------------------------------------- conservation

    def conservation(self) -> dict:
        """The terminal-state ledger: ``ok`` is False iff an admitted
        request is neither done, expired, failed nor still queued."""
        c = self.metrics.conservation()
        c["queued"] = self.queued_requests
        c["ok"] = c["admitted"] == c["resolved"] + c["queued"]
        return c

    # ---------------------------------------------------------------- run

    def serve(self, requests, *, drain: bool = True) -> list:
        """Burst mode: submit everything, then run the loop to completion."""
        for r in requests:
            self.submit(r)
        while self.step(drain=drain):
            pass
        return requests

    def replay(self, requests, arrivals_s, *, sleep=time.sleep) -> list:
        """Trace-replay mode: submit each request when the clock passes its
        arrival offset (seconds from replay start, sorted ascending),
        batching between arrivals under the live policy, then drain. A
        ``QueueFull`` sheds that request (``rejected``); a malformed one is
        marked ``failed`` and counted in ``metrics.malformed``; the rest of
        the trace is served. Each request's ``t_due`` is the replay's start
        plus its offset.

        While tracing, each loop pass lies under the spans ``serve.admit``
        (its submits: ``n`` admitted, ``refused``, and the sum ``lag_s`` and
        largest ``lag_max_s`` of admission minus due time), ``serve.step``
        and ``serve.wait``, and a collector pass records ``host.gc``
        (:class:`~repro_torch.obs.trace.GcSpans`, installed at the first
        traced pass and removed on return)."""
        order = list(zip(requests, arrivals_s))
        if any(b < a for (_, a), (_, b) in zip(order, order[1:])):
            raise ValueError("arrivals_s must be sorted ascending")
        gc_spans = obs.GcSpans()
        t0 = self.clock()
        i = 0
        try:
            while i < len(order) or self.queued_requests:
                tracing = obs.enabled()
                if tracing and not gc_spans.installed:
                    gc_spans.install()
                now = self.clock() - t0
                if i < len(order) and order[i][1] <= now:
                    with (obs.span("serve.admit") if tracing
                          else obs.NOOP_SPAN) as sp:
                        i = self._admit_due(order, i, now, t0, sp, tracing)
                with obs.span("serve.step") if tracing else obs.NOOP_SPAN:
                    ran = self.step()
                if ran:
                    continue
                if i < len(order):   # idle until the next arrival or deadline
                    wait = order[i][1] - (self.clock() - t0)
                    if self.queued_requests:
                        wait = min(wait, self.policy.max_wait_s)
                    if wait > 0:
                        with obs.span("serve.wait") if tracing else obs.NOOP_SPAN:
                            sleep(min(wait, 1e-3))
                elif self.queued_requests:
                    # no more arrivals: flush the tail
                    with obs.span("serve.step") if tracing else obs.NOOP_SPAN:
                        self.step(drain=True)
        finally:
            gc_spans.remove()
        return requests

    def _admit_due(self, order: list, i: int, now: float, t0: float, sp,
                   tracing: bool) -> int:
        """Submit every request of ``order`` from ``i`` on that is due by
        ``now`` (replay-relative), stamping ``t_due``; returns the next
        index. While tracing, ``sp`` (the pass's ``serve.admit``) gets the
        counts and the lags."""
        n = refused = 0
        lag = lag_max = 0.0
        while i < len(order) and order[i][1] <= now:
            req, at = order[i]
            req.t_due = t0 + at
            try:
                self.submit(req)
            except QueueFull:
                refused += 1   # shed: request marked rejected by submit
            except ValueError:
                req.failed = True
                req.t_submit = req.t_done = self.clock()
                self.metrics.record_malformed(getattr(req, "model", None))
                if obs.enabled():
                    self._tl(f"malformed#{self.metrics.malformed}", "fail",
                             req.t_done, model=getattr(req, "model", None),
                             reason="malformed")
                    obs.counter("serve.malformed")
            else:
                if tracing:
                    n += 1
                    late = req.t_submit - req.t_due
                    lag += late
                    lag_max = max(lag_max, late)
            i += 1
        if tracing:
            sp.set(n=n, refused=refused, lag_s=lag, lag_max_s=lag_max)
        return i


def sequential_executables(cfg, params: dict, sizes, *, device=None,
                           train: bool = False, fuse="auto") -> dict:
    """Warmed per-size executables ``{n: fn(params, z)}``, each running the
    whole generator at exactly batch ``n`` (plans as the engine compiles
    them, ``train`` and ``fuse`` likewise): the sequential per-request
    baseline the bucketed engine is compared against. On the card each is
    one CUDA graph captured over ``params`` (:func:`generator_executable`;
    the sizes share one memory pool, so a call may overwrite another size's
    last output), called with that same dict."""
    dev = resolve_device(device)
    plans = compile_plan_buckets(cfg, sizes, train=train,
                                 epilogues=generator_epilogues(cfg), fuse=fuse)
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    fns = {}
    for n, plan in plans.items():
        fns[n] = generator_executable(params, cfg, plan, n, dev, pool=pool)
        fns[n](params, torch.zeros((n, cfg.z_dim), device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return fns
