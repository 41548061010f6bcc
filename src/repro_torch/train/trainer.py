"""Fault-tolerant training loop. Mirrors ``repro/train/trainer.py``.

The contract:

* step-atomic checkpoints every ``ckpt_every`` steps, at the end and on
  SIGTERM (:mod:`repro_torch.train.checkpoint`);
* on start, resume from the newest checkpoint that loads: a crashed or
  preempted job relaunches with the same command line and continues;
* data is a pure function of the step (``data.batch(step)``): no loader
  state, so a resumed run repeats the uninterrupted one bit for bit;
* a step whose loss is not finite is skipped, with the params and the
  optimizer state untouched, and counted in ``skipped_steps``. The
  reference's docstring makes this promise, but its code keeps the update
  of the skipped step; the port keeps the promise.

**One executable a step.** On the card the step is one CUDA graph
(:mod:`repro_torch.graphs`), the counterpart of the reference's
``jax.jit(train_step, donate_argnums=(0, 1))``, captured at the first step.
The state is donated: the ``(params, opt_state)`` a step returns are the
graph's static buffers, which the next step overwrites in place, so a
caller who keeps an older state clones it; a state that is not those
buffers (a fresh one, one a resume placed) is copied in. The host reads
the step's scalars after the replay, and only a step with a finite loss
copies the graph's new state into the buffers. On the CPU the step runs
eagerly and returns new tensors.

**Deterministic algorithms.** The step runs (and is captured) under
``torch.use_deterministic_algorithms(True)``: on CUDA, the backward of the
embedding gather and of the targets' gather would otherwise add with
atomics, in an order that differs from run to run. On the card, cuBLAS then
needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before its
first call (:mod:`repro_torch.launch.train` sets it); without it the first
step raises.

**Under a mesh** (:func:`~repro_torch.distributed.sharding.use_mesh`)
every rank runs the same step on the same global batch. Unplaced, each holds
the whole state; the MoE's expert-parallel region sums its gradients over
the ranks, so the step has no gradient all-reduce of its own. A placed state
(``init_train_state(..., mesh=)``) is split over the ranks and its step runs
placed. The step's collectives are captured in its graph, so on the card
the mesh's groups must be NCCL (checked, and each warmed by one collective,
before the capture). Every rank gathers a placed state for a checkpoint and
only global rank 0 writes it; every rank restores, and a placed state is
placed again.
"""
from __future__ import annotations

import contextlib
import math
import signal
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    check_capturable,
    full_tree,
    get_concrete_mesh,
    is_placed,
    is_writer,
)
from repro_torch.graphs import CudaGraph
from repro_torch.timing import StepTimer
from repro_torch.train.checkpoint import (
    gc_checkpoints,
    place_like,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.tree import tree_leaves


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    settings restored after. Uninitialised memory is not filled: the step
    writes every tensor it reads, and a fill would add a kernel to each
    allocation."""
    from torch.utils import deterministic

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        deterministic.fill_uninitialized_memory = prev[2]


def _mesh_of(params):
    """The mesh of a placed state, else the ambient ``DeviceMesh``."""
    leaf = tree_leaves(params)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else get_concrete_mesh()


def _locals(tree) -> list:
    """The leaves of ``tree``, a placed one as its local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)]


class Trainer:
    """Runs ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` (:func:`~repro_torch.train.train_step.make_train_step`) over
    ``data.batch(step)`` under the contract of the module docstring. The
    step runs on the device of the params it is given."""

    def __init__(self, model, train_step, data, *, ckpt_dir=None, ckpt_every=100,
                 keep_last=3, log_every=10, log_fn=print):
        self.model = model
        self.train_step = train_step
        self.data = data
        self.ckpt_dir = str(ckpt_dir) if ckpt_dir is not None else None
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.log_every = log_every
        self.log = log_fn
        self.skipped_steps = 0
        self.resumed_step = None
        self.timer = StepTimer()
        self._stop = False
        self._graph = None   # the step's CUDA graph, captured at the first step

    # ---------------------------------------------------------- the step

    def step_eager(self, params, opt_state, batch):
        """One step without a graph: ``train_step`` under deterministic
        algorithms, new tensors out, the inputs untouched."""
        with deterministic_algorithms():
            return self.train_step(params, opt_state, batch)

    def _step_fn(self, params, opt_state, batch):
        """One step behind the NaN guard: ``(params, opt_state, metrics)``,
        the metrics as Python floats. On the card it replays the step's
        graph (captured at the first call) and returns the static buffers,
        into which the new state was copied only if the loss is finite; on
        the CPU it returns the new state, or the given one."""
        on_card = tree_leaves(params)[0].device.type == "cuda"
        if on_card:
            if self._graph is None:
                # the mesh's collectives go into the graph
                check_capturable(_mesh_of(params), tree_leaves(params)[0].device)
                with deterministic_algorithms():
                    self._graph = CudaGraph(self.train_step, params, opt_state, batch)
            new_params, new_opt, metrics = self._graph(params, opt_state, batch)
            params, opt_state = self._graph.inputs[0], self._graph.inputs[1]
        else:
            new_params, new_opt, metrics = self.step_eager(params, opt_state, batch)
        vals = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
        if not math.isfinite(vals["loss"]):   # the old state, whole
            return params, opt_state, vals
        if on_card:   # commit the graph's new state
            torch._foreach_copy_(_locals([params, opt_state]), _locals([new_params, new_opt]))
            return params, opt_state, vals
        return new_params, new_opt, vals

    # ---------------------------------------------------------- the loop

    def _install_sigterm(self):
        def handler(signum, frame):
            self._stop = True  # checkpoint + exit at the next step boundary

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not in the main thread

    def _save(self, step, params, opt_state) -> None:
        if is_placed(params):   # gathered whole on every rank (a collective)
            params, opt_state = full_tree(params), full_tree(opt_state)
        if not is_writer():   # every rank holds the same whole state
            return
        save_checkpoint(self.ckpt_dir, step, params, opt_state)
        gc_checkpoints(self.ckpt_dir, self.keep_last)

    def run(self, params, opt_state, *, steps, start_step=0):
        """Train to ``steps`` total steps, resuming first: ``(params,
        opt_state, history)``, ``history`` the loss of each step that was
        not skipped. SIGTERM checkpoints and returns; a crash loses at most
        the steps since the last checkpoint."""
        self._stop = False
        prev_handler = self._install_sigterm()
        try:
            step = start_step
            if self.ckpt_dir:
                got, p, o, _ = restore_checkpoint(self.ckpt_dir, log_fn=self.log)
                if got is not None and got > start_step:
                    self.log(f"[trainer] resuming from step {got}")
                    params, opt_state = place_like(p, params), place_like(o, opt_state)
                    step = self.resumed_step = got
            history = []
            t0 = time.time()
            self.timer = StepTimer()
            while step < steps and not self._stop:
                batch = self.data.batch(step)
                params, opt_state, metrics = self._step_fn(params, opt_state, batch)
                self.timer.tick()
                loss = metrics["loss"]
                if not math.isfinite(loss):
                    self.skipped_steps += 1
                    self.log(f"[trainer] step {step}: non-finite loss; skipped, "
                             f"state untouched")
                    step += 1
                    continue
                history.append(loss)
                if step % self.log_every == 0:
                    self.log(f"[trainer] step {step} loss {loss:.4f} "
                             f"gnorm {metrics['grad_norm']:.3f} "
                             f"lr {metrics['lr']:.2e} ({time.time() - t0:.1f}s)")
                if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                    self._save(step + 1, params, opt_state)
                step += 1
            if self.ckpt_dir and (self._stop or step >= steps):
                self._save(step, params, opt_state)
                if self._stop:
                    self.log(f"[trainer] SIGTERM: checkpointed step {step}, exiting")
            return params, opt_state, history
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    @property
    def stopped(self) -> bool:
        """True when the last run exited on SIGTERM rather than completion."""
        return self._stop
