"""Fault tolerance and elasticity: the failure model and its host-side
helpers. Mirrors ``repro/distributed/fault_tolerance.py``.

The pieces that live elsewhere in the port:

  checkpoint/restart   train/checkpoint.py -- step-atomic npz, resume by
                       step, a scan past corrupt files; global rank 0
                       writes, every rank restores
  stateless data       data/pipeline.py -- a batch is f(seed, step), the
                       same global batch on every rank
  NaN/anomaly guard    train/trainer.py + train/gan_trainer.py -- skip and
                       count bad steps (the state untouched)
  gradient compression optim/compression.py -- int8 with error feedback
                       carried in the checkpointed optimizer state
  production loop      train/gan_trainer.py -- the plan-aware trainer that
                       wires all of the above together
  data parallelism     distributed/sharding.py -- ``shard_plan_apply`` and
                       the collectives of distributed/collectives.py
  fault injection      train/fault_injection.py -- every failure below made
                       deterministically injectable;
                       tests/test_torch_fault_injection.py is the machine
                       check of this module
  serving counterpart  serve/supervisor.py -- the same failure model applied
                       to inference: a replica's crash, hang, transient
                       failure or poisoned output behind health-checked
                       dispatch, with serve/fault_injection.py as the
                       injection twin and tests/test_torch_replica_serving.py
                       as the machine check

Failure model and responses
---------------------------

1. **Device or host crash (hard failure).** A ``torchrun`` job fails as a
   unit and the scheduler relaunches the same command. Because data is a
   pure function of the step and the checkpoint is step-atomic, the
   relaunched job resumes bit-exact from the last checkpoint. Mean lost
   work is ckpt_every/2 steps; at 1000 nodes pick ckpt_every so that
   (MTBF_cluster / step_time) >> ckpt_every.

2. **Elastic re-scale (lose or gain a pod).** The production mesh is
   (pod, data, model). Losing a pod halves the global batch but changes no
   parameter placement (the pod axis carries data parallelism only), so:
   re-mesh with pod=1, reload the same checkpoint (its npz arrays do not
   depend on the mesh), and continue with :func:`elastic_batch_schedule` to
   keep the effective batch through gradient accumulation.

3. **Stragglers.** Two mitigations: (a) deterministic shard ownership
   (:func:`shard_owner`) lets any fast worker recompute a slow peer's shard
   for the *next* step (work stealing at the data layer, no tensor state
   moves); (b) the launcher stamps a deadline a step, and hosts that miss it
   are reported to the scheduler for replacement rather than stalling the
   collective. Serving side: (a) becomes the supervisor's **batch requeue**
   (a failed bucket goes back to the head of the queue and dispatches again
   on a healthy replica) and (b) the per-(model, bucket) **dispatch
   timeout** derived from the warmed call walls; a dispatch past its
   deadline is discarded and the replica goes SUSPECT (serve/supervisor.py).

4. **Silent data corruption.** The anomaly guard skips non-finite steps;
   keeping several checkpoints (``keep_last``) lets a corrupted but finite
   run be rolled back. Serving side: the supervisor's output finiteness
   guard; a NaN/Inf output fails the dispatch, the batch is retried, and a
   poisoned output is never served.
"""
from __future__ import annotations

import math


def elastic_batch_schedule(global_batch: int, pods_alive: int, pods_total: int):
    """``(per-step microbatch, grad-accumulation steps)`` after losing pods.

    Keeps the effective batch constant: the microbatch shrinks with the
    alive fraction and accumulation makes up the difference.
    """
    frac = pods_alive / pods_total
    micro = max(1, int(global_batch * frac))
    accum = math.ceil(global_batch / micro)
    return micro, accum


def shard_owner(step: int, shard: int, hosts: int) -> int:
    """Deterministic rotating shard ownership: any host can compute any
    shard, and ownership rotates so a straggler's shard lands on a
    different host next step."""
    return (shard + step) % hosts
