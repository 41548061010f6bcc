"""Batch-bucket policy for the GAN serving engine. Mirrors ``repro/serve/batching.py``.

The compile-once plan machinery keys every executable on its batch size
(``LayerPlan.batch`` is part of the plan signature), so a serving engine
that admitted requests at their natural sizes would compile — and retrace —
one generator per distinct size it ever saw. The bucket policy turns that
open set into a small closed one: admitted work is padded up to the nearest
**bucket** (powers of two by default), so the engine's steady state runs a
fixed set of precompiled executables and zero retraces, at the cost of a
bounded pad-waste fraction (tracked by :mod:`repro_torch.serve.metrics`).

Three decisions live here, deliberately separated from the engine loop so
they are unit-testable with plain lists:

* ``bucket_for(n)`` — the executable a batch of ``n`` real samples runs in
  (smallest bucket >= n).
* ``pack(sizes)`` — greedy FIFO packing of whole queued requests into one
  bucket: requests are never split or reordered, so per-request outputs
  stay contiguous and fairness is preserved.
* ``should_flush(sizes, oldest_wait_s)`` — dispatch now or keep
  accumulating: flush when the head of the queue already fills the largest
  bucket, or when the oldest request has waited ``max_wait_s`` (so light
  traffic still gets bounded latency instead of waiting for a full batch).

Backpressure is the fourth knob: ``max_queue`` bounds the number of queued
*samples* (not requests); the engine rejects at admission beyond it, which
keeps worst-case queueing latency proportional to ``max_queue`` instead of
unbounded under overload.
"""
from __future__ import annotations

import dataclasses


class QueueFull(RuntimeError):
    """Raised by the engine at admission when the queue bound is exceeded."""


def pow2_buckets(max_batch: int) -> tuple:
    """(1, 2, 4, ..., max_batch); ``max_batch`` must be a power of two."""
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(f"max_batch must be a power of two, got {max_batch}")
    out = []
    b = 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Immutable bucketed-admission policy (see module docstring)."""

    buckets: tuple = pow2_buckets(16)
    max_wait_s: float = 0.01   # deadline: oldest request waits at most this
    max_queue: int = 256       # backpressure bound, in queued samples

    def __post_init__(self):
        b = tuple(int(x) for x in self.buckets)
        if not b or any(x < 1 for x in b):
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        if len(set(b)) != len(b) or tuple(sorted(b)) != b:
            raise ValueError(
                f"buckets must be strictly increasing, got {self.buckets}"
            )
        object.__setattr__(self, "buckets", b)
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.max_queue < b[-1]:
            raise ValueError(
                f"max_queue ({self.max_queue}) must hold at least one full "
                f"max bucket ({b[-1]})"
            )

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that holds ``n`` samples."""
        if n < 1:
            raise ValueError(f"batch must be positive, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds the largest bucket {self.max_bucket}"
        )

    def pack(self, sizes) -> tuple:
        """Greedy FIFO packing: how many whole head-of-queue requests fit in
        one dispatch, and the bucket they run in.

        Returns ``(count, bucket)`` — take ``sizes[:count]`` (never split,
        never reordered) into a batch of ``sum(sizes[:count])`` real samples
        padded up to ``bucket``. ``(0, 0)`` for an empty queue.
        """
        total = 0
        count = 0
        for n in sizes:
            if total + n > self.max_bucket:
                break
            total += n
            count += 1
        if count == 0:
            return 0, 0
        return count, self.bucket_for(total)

    def should_flush(self, sizes, oldest_wait_s: float) -> bool:
        """Dispatch now? True when the queue head fills the largest bucket
        (adding the next queued request would overflow it, or there is no
        next) — or when the oldest request has hit the max-wait deadline."""
        count, _ = self.pack(sizes)
        if count == 0:
            return False
        if count == len(sizes) and sum(sizes) >= self.max_bucket:
            return True          # exactly full
        if count < len(sizes):
            return True          # next request would overflow: batch is full
        return oldest_wait_s >= self.max_wait_s
