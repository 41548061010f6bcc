"""Deterministic fault-injection harness for the training stack. Mirrors
``repro/train/fault_injection.py``.

Every entry of the trainer's failure model is injectable on demand, so the
responses are machine-checked instead of trusted:

  failure                                 injection here
  ------------------------------------    ------------------------------------
  chip/host crash (hard failure)          ``FaultPlan.kill_at_step`` -- raise
                                          :class:`SimulatedCrash` at a step
                                          boundary; the relaunch must resume
                                          bit-exact from the last checkpoint
  crash DURING a checkpoint save          ``FaultPlan.kill_mid_save_at_step``
                                          -- crash between the temp-file write
                                          and the atomic ``os.replace``
                                          publish, leaving genuine ``*.tmp``
                                          residue
  preemption (SIGTERM)                    ``FaultPlan.sigterm_at_step`` -- a
                                          real ``os.kill(getpid(), SIGTERM)``;
                                          the trainer must checkpoint and
                                          return cleanly
  silent data corruption / bad node       :class:`NaNInjectionData` -- a batch
                                          of NaNs at chosen steps; the NaN
                                          guard must skip with the state
                                          bitwise untouched
  checkpoint bit rot / torn files         :func:`corrupt_checkpoint` /
                                          :func:`write_stray_tmp` -- restore
                                          must fall back to the newest valid
                                          checkpoint

Faults fire at exact step indices, so a chaos run is as reproducible as a
clean one. The injector plugs into the trainer's one seam
(``hooks.on_step_start``) and into ``train/checkpoint.py``'s publish
(``_REPLACE``); nothing on the production path imports this module.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch


class SimulatedCrash(RuntimeError):
    """An injected hard failure (the in-process stand-in for SIGKILL)."""


# ------------------------------------------------------------- mid-save kill

def arm_crash_before_publish():
    """Arm a ONE-SHOT crash inside the next checkpoint save, after the temp
    file is fully written but before the atomic publish — i.e. the process
    dies holding a complete ``*.tmp`` and no new ``step_*.npz``.

    Returns a ``disarm()`` callable (idempotent; the trap also disarms
    itself when it fires, so the relaunched run's saves work normally).
    """
    from repro_torch.train import checkpoint as ckpt

    orig = ckpt._REPLACE

    def boom(src, dst):
        ckpt._REPLACE = orig   # one-shot: the relaunch must save cleanly
        raise SimulatedCrash(f"killed mid-save before publishing {dst}")

    ckpt._REPLACE = boom

    def disarm():
        ckpt._REPLACE = orig

    return disarm


# ------------------------------------------------------- checkpoint damage

def checkpoint_path(ckpt_dir, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def corrupt_checkpoint(ckpt_dir, step: int, mode: str = "truncate") -> str:
    """Damage one on-disk checkpoint in place.

    ``truncate`` cuts the file to half its bytes (torn write / bit rot on a
    non-atomic filesystem), ``garbage`` overwrites the zip header with junk,
    ``empty`` leaves a zero-byte file. All three must be *skipped* by
    :func:`repro_torch.train.checkpoint.restore_checkpoint`'s fallback scan.
    """
    path = checkpoint_path(ckpt_dir, step)
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garbage":
        with open(path, "r+b") as f:
            f.write(b"\xff" * min(1024, size))
    elif mode == "empty":
        with open(path, "r+b") as f:
            f.truncate(0)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path


def write_stray_tmp(ckpt_dir, payload: bytes = b"half-written npz") -> str:
    """Plant the residue a mid-save kill leaves: a partial ``*.tmp`` file.
    The step scan must ignore it and gc must sweep it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "tmpchaos00.tmp")
    with open(path, "wb") as f:
        f.write(payload)
    return path


# ----------------------------------------------------------- NaN injection

class NaNInjectionData:
    """Wrap a deterministic data source so chosen trainer steps see a batch
    of NaNs (a bad node emitting garbage: the losses go non-finite and the
    NaN guard must skip).

    ``steps`` are TRAINER step indices; ``accum`` maps them onto the flat
    microbatch indices the trainer actually requests (``step * accum + j``).
    """

    def __init__(self, data, steps, accum: int = 1):
        self.data = data
        self.steps = frozenset(int(s) for s in steps)
        self.accum = int(accum)

    def batch(self, index: int):
        b = self.data.batch(index)
        if index // self.accum in self.steps:
            return torch.full_like(b, float("nan"))
        return b


# ------------------------------------------------------------ the injector

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which failures fire at which trainer steps (all optional)."""

    kill_at_step: int | None = None
    sigterm_at_step: int | None = None
    kill_mid_save_at_step: int | None = None   # the save at END of this step
    nan_at_steps: tuple = ()


class FaultInjector:
    """Drives a :class:`FaultPlan` through the trainer's ``hooks`` seam.

    Usage::

        plan = FaultPlan(kill_at_step=5)
        inj = FaultInjector(plan)
        trainer = GanTrainer(cfg, tcfg, inj.wrap_data(data, accum),
                             ckpt_dir=d, hooks=inj)
        try:
            trainer.run(state, steps=10)
        except SimulatedCrash:
            ...  # relaunch exactly like the scheduler would

    ``fired`` records what actually triggered, so tests can assert the
    fault landed where the plan said.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list = []
        self._disarm = None

    def wrap_data(self, data, accum: int = 1):
        if not self.plan.nan_at_steps:
            return data
        return NaNInjectionData(data, self.plan.nan_at_steps, accum)

    def on_step_start(self, step: int) -> None:
        p = self.plan
        if p.kill_mid_save_at_step is not None \
                and step == p.kill_mid_save_at_step and self._disarm is None:
            self._disarm = arm_crash_before_publish()
            self.fired.append(("arm_mid_save", step))
        if p.sigterm_at_step is not None and step == p.sigterm_at_step:
            self.fired.append(("sigterm", step))
            os.kill(os.getpid(), signal.SIGTERM)
        if p.kill_at_step is not None and step == p.kill_at_step:
            self.fired.append(("kill", step))
            raise SimulatedCrash(f"injected kill at step {step}")

    def cleanup(self) -> None:
        """Disarm any armed-but-unfired traps (call from test teardown)."""
        if self._disarm is not None:
            self._disarm()
            self._disarm = None


# -------------------------------------------------------------- utilities

def trajectories_equal(a, b) -> bool:
    """Bit-exact comparison of two trainer histories over their overlapping
    step range (each a list of ``{"step", "g_loss", "d_loss", ...}`` rows).
    Floats are compared for exact equality — the resume contract is
    *bit-exact*, not approximate."""
    by_step_a = {r["step"]: r for r in a}
    by_step_b = {r["step"]: r for r in b}
    common = sorted(set(by_step_a) & set(by_step_b))
    if not common:
        return False
    for s in common:
        ra, rb = by_step_a[s], by_step_b[s]
        for k in ("g_loss", "d_loss"):
            if np.float32(ra[k]) != np.float32(rb[k]):
                return False
    return True
