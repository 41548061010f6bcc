"""A serving replica: one warmed set of per-(model, bucket) executables.
Mirrors ``repro/serve/replica.py``.

The :class:`~repro_torch.serve.gan_engine.GanEngine` owns admission,
bucketing and fairness; a :class:`Replica` owns **execution** -- its own
plans, its own executables and its own recompile counter. The
:class:`~repro_torch.serve.supervisor.ReplicaSupervisor` routes packed
buckets across a set of replicas, which turns the synchronous engine loop
into a unit that survives a replica's hang, crash or poisoned output.

Two properties make the replica the isolation boundary:

* **Executables are per replica.** On the card each replica captures its
  own CUDA graph per (model, bucket) (:func:`~repro_torch.serve.gan_engine.
  generator_executable`) in a memory pool of its own, over the parameters
  it was registered with (replicas of one model may share the parameter
  tensors; a graph called with any other parameters raises). A replica's
  output is copied to the host before its next replay, and no other
  replica's replay writes into its pool. ``recompiles`` counts the
  executables it built: flat after warm-up.
* **Dispatch has one narrow seam.** Every call -- real dispatches and
  health probes alike -- passes through the injectable ``dispatch_hook``
  on the host before the graph replays. The serving chaos harness
  (:mod:`repro_torch.serve.fault_injection`) lives entirely on that seam.

``shard=True`` runs each executable through
:func:`~repro_torch.distributed.sharding.shard_plan_apply` over ``mesh``
(else the ambient ``DeviceMesh`` when the executable is built): the batch
split over the data-parallel ranks, every rank serving the whole output. On
the card each (model, bucket) stays one CUDA graph with the collectives
inside, so the mesh's groups must be NCCL (checked at construction, with
one collective run before any capture). Departure from the reference: no
``dtype=`` (the port serves fp32). ``train`` and ``fuse`` (default
``"auto"``, the autotune cache's pair race) compile the plans as the
engine's do.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import check_capturable, get_concrete_mesh
from repro_torch.kernels.plan import check_fuse, compile_plan_buckets
from repro_torch.models.gan import generator_epilogues
from repro_torch.obs import trace as obs
from repro_torch.serve.gan_engine import generator_executable


@dataclasses.dataclass
class _ReplicaModel:
    cfg: object
    params: dict
    plans: dict = dataclasses.field(default_factory=dict)   # bucket -> plan
    apply: dict = dataclasses.field(default_factory=dict)   # bucket -> fn


class Replica:
    """One serving replica: warmed per-(model, bucket) executables behind a
    narrow injectable dispatch seam.

    ``dispatch_hook(replica, index, model, bucket, probe=...)`` -- when set
    -- is called before every dispatch (``index`` counts this replica's
    real dispatches from 1) and every probe (``probe=True``, ``index``
    counts probes). It may raise (the supervisor treats any exception from
    a dispatch as a replica failure) or return a callable that transforms
    the host copy of the output (how the chaos harness poisons a plane).

    **Baselines** -- the per-(model, bucket) warmed call walls the
    supervisor derives dispatch timeouts from -- are the host wall
    (``time.perf_counter``) of one call that ends in a synchronise, after
    a first call: a real device measurement, not scheduler state.
    ``device`` is the CUDA card unless given.
    """

    def __init__(self, replica_id: str, *, device=None, train: bool = False,
                 fuse="auto", shard: bool = False, mesh=None, dispatch_hook=None):
        check_fuse(fuse)
        self.replica_id = str(replica_id)
        self.device = resolve_device(device)
        self.train = train
        self.fuse = fuse
        self.shard = shard
        self.mesh = mesh
        if shard and self.device.type == "cuda":
            check_capturable(mesh if mesh is not None else get_concrete_mesh(),
                             self.device)
        self.dispatch_hook = dispatch_hook
        self.registry: dict[str, _ReplicaModel] = {}
        self.recompiles = 0        # executables built
        self.dispatches = 0        # real dispatches through the seam
        self.probe_count = 0       # probes through the seam
        self.baseline_s: dict = {}  # (model, bucket) -> warmed call wall
        self.pool = None           # this replica's CUDA graph memory pool

    # ----------------------------------------------------------- registry

    def register(self, cfg, params: dict, *, name: str | None = None) -> str:
        name = name or cfg.name
        if name in self.registry:
            raise ValueError(
                f"model {name!r} already registered on replica "
                f"{self.replica_id!r}"
            )
        if params["proj"]["w"].device != self.device:
            raise ValueError(
                f"params live on {params['proj']['w'].device}, replica "
                f"{self.replica_id!r} runs on {self.device}"
            )
        self.registry[name] = _ReplicaModel(cfg=cfg, params=params)
        return name

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, buckets) -> None:
        """Build every (model, bucket) executable (on the card: capture its
        graph), call it once, and measure one more synced call
        (``baseline_s``), the wall the supervisor's timeouts derive from."""
        for name, slot in self.registry.items():
            for bucket in buckets:
                fn = self._executable(name, bucket)
                z0 = torch.zeros((bucket, slot.cfg.z_dim), device=self.device)
                fn(slot.params, z0)
                self._sync()
                t0 = time.perf_counter()
                fn(slot.params, z0)
                self._sync()
                self.baseline_s[(name, bucket)] = time.perf_counter() - t0

    def _executable(self, name: str, bucket: int):
        """The whole-generator callable for one (model, bucket), built
        lazily (an un-warmed replica still serves; its recompile counter
        shows the inline build, exactly like the engine's)."""
        slot = self.registry[name]
        fn = slot.apply.get(bucket)
        if fn is None:
            if bucket not in slot.plans:
                slot.plans.update(compile_plan_buckets(
                    slot.cfg, [bucket], train=self.train,
                    epilogues=generator_epilogues(slot.cfg), fuse=self.fuse,
                ))
            if self.device.type == "cuda" and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            fn = generator_executable(slot.params, slot.cfg, slot.plans[bucket],
                                      bucket, self.device, pool=self.pool,
                                      shard=self.shard, mesh=self.mesh)
            slot.apply[bucket] = fn
            self.recompiles += 1
        return fn

    # ----------------------------------------------------------- dispatch

    def execute(self, name: str, z, bucket: int) -> torch.Tensor:
        """Run one packed bucket. ``z`` is the already-padded ``(bucket,
        z_dim)`` latent batch; returns the output's host copy (a CPU
        tensor). The dispatch seam fires first -- any exception it raises is
        this replica failing the dispatch -- and its optional transform is
        applied to the host copy (never to what other replicas see)."""
        self.dispatches += 1
        with (obs.span("replica.execute", replica=self.replica_id, model=name,
                       bucket=bucket) if obs.enabled() else obs.NOOP_SPAN):
            transform = None
            if self.dispatch_hook is not None:
                transform = self.dispatch_hook(
                    self, self.dispatches, name, bucket, probe=False
                )
            slot = self.registry[name]
            out = self._executable(name, bucket)(
                slot.params, torch.as_tensor(z)).cpu()
            if transform is not None:
                out = transform(out)
            return out

    def probe(self) -> bool:
        """Health probe: the smallest-bucket executable of the first
        registered model on zero latents, through the dispatch seam.
        Returns whether the output came back finite; raises if the replica
        (or the fault occupying it) refuses the call. The supervisor treats
        False and an exception alike: probe failed."""
        if not self.registry:
            raise RuntimeError(
                f"replica {self.replica_id!r} has no registered models"
            )
        name, slot = next(iter(self.registry.items()))
        bucket = min(slot.apply) if slot.apply else 1
        self.probe_count += 1
        with (obs.span("replica.probe", replica=self.replica_id, model=name,
                       bucket=bucket) if obs.enabled() else obs.NOOP_SPAN):
            transform = None
            if self.dispatch_hook is not None:
                transform = self.dispatch_hook(
                    self, self.probe_count, name, bucket, probe=True
                )
            z0 = torch.zeros((bucket, slot.cfg.z_dim), device=self.device)
            out = self._executable(name, bucket)(slot.params, z0).cpu()
            if transform is not None:
                out = transform(out)
            return bool(torch.isfinite(out).all())

    def describe(self) -> str:
        return (
            f"replica {self.replica_id}: {len(self.registry)} models, "
            f"{sum(len(m.apply) for m in self.registry.values())} "
            f"executables, {self.dispatches} dispatches, "
            f"{self.probe_count} probes, {self.recompiles} compiles"
        )
