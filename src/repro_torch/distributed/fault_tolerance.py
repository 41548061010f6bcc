"""The port's copy of ``elastic_batch_schedule`` from
``repro/distributed/fault_tolerance.py`` (the rest of that module's
failure model waits for the distributed slice)."""
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
