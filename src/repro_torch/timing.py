"""Device time of a callable on the CUDA card, and step walls of a
training loop. Mirrors ``time_fn`` (re-done on CUDA events) and
``StepTimer`` of ``repro/timing.py``.

PyTorch returns before the card finishes, so a host clock without a
synchronise measures the enqueue. :func:`time_cuda` warms up, records an
event before and after a run of many calls, synchronises, and returns the
elapsed device time per call. It measures only the card: given a tensor
that is not on a CUDA device it raises. :class:`StepTimer` is a host
clock: its caller ends each step in a synchronise (the trainer reads the
step's losses back).
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs.trace import percentiles


def time_cuda(fn, *args, iters: int = 20, warmup: int = 3, **kwargs) -> float:
    """Milliseconds per call of ``fn(*args, **kwargs)`` on the card."""
    tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise ValueError("time_cuda measures the card: pass CUDA tensors")
    for _ in range(warmup):
        fn(*args, **kwargs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class StepTimer:
    """Per-step wall times of a training loop. ``tick()`` after each step
    returns that step's seconds and keeps it; the summaries skip the first
    ``skip`` steps (warm-up)."""

    def __init__(self) -> None:
        self.steps: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.steps.append(dt)
        return dt

    def _tail(self, skip: int) -> list[float]:
        return self.steps[skip:] or self.steps

    def mean(self, skip: int = 1) -> float:
        return percentiles(self._tail(skip))["mean"]

    def median(self, skip: int = 1) -> float:
        return percentiles(self._tail(skip))["p50"]

    def percentiles(self, skip: int = 1) -> dict:
        """``{p50, p95, p99, mean, max}`` of the steady-state step walls."""
        return percentiles(self._tail(skip))
