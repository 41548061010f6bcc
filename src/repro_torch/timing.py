"""Device time of a callable on the CUDA card. Mirrors ``time_fn`` of
``repro/timing.py``, re-done on CUDA events.

PyTorch returns before the card finishes, so a host clock without a
synchronise measures the enqueue. :func:`time_cuda` warms up, records an
event before and after a run of many calls, synchronises, and returns the
elapsed device time per call. It measures only the card: given a tensor
that is not on a CUDA device it raises.
"""
from __future__ import annotations

import torch


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
