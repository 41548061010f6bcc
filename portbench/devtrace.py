"""The device side of a traced run: ``torch.profiler`` over a steady
sub-window of the measured window, reduced in memory (nothing is written to
disk) to the device's busy time, the kernels' time by name and the idle gaps
between device operations, each gap split over what the host was doing.

Timestamps are moved onto the host's monotonic clock, the clock of the
program's spans, by a marker recorded when the profiler starts.
"""
from __future__ import annotations

import re
import time
from pathlib import Path

import torch

KERNEL_NAMES = Path(__file__).resolve().parent / "kernel_names"
_MARK = "portbench.mark"


def kernel_patterns(family: str) -> list:
    """The regexes of every ``kernel_names/<family>/*.txt`` file, one a
    line (blank lines and ``#`` comments skipped)."""
    out = []
    for f in sorted((KERNEL_NAMES / family).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(re.compile(line))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list (the
    last parenthesised group, where the name ends in one)."""
    name = name.removeprefix("void ")
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] or name
    return name


class Profile:
    """One profiled sub-window. ``start``/``stop`` bracket it; ``ops``
    holds ``(name, start_s, end_s)`` of every device operation in it, on the
    monotonic clock, once :meth:`collect` has read the profiler's events
    (after the window: reading them takes seconds)."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self.start_s = 0.0       # the host's cost of starting the profiler
        self.ops: list = []

    @property
    def running(self) -> bool:
        return self._prof is not None and self.t1 is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        t = time.monotonic()
        self._prof = profile(activities=acts)
        self._prof.start()
        self.t0 = time.monotonic()
        with torch.profiler.record_function(_MARK):
            pass
        self.start_s = self.t0 - t

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self._prof.stop()

    def collect(self) -> None:
        events = self._prof.events()
        mark = next(e for e in events if e.name == _MARK)
        offset = self.t0 - mark.time_range.start * 1e-6
        self.ops = sorted(
            ((e.name, e.time_range.start * 1e-6 + offset, e.time_range.end * 1e-6 + offset)
             for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda op: op[1])
        self._prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        sub-window."""
        merged = []
        for _, a, b in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, patterns: list) -> float:
        """Device seconds of the operations whose name a pattern matches,
        clipped to the sub-window as :meth:`busy_intervals` is."""
        return sum(max(0.0, min(b, self.t1) - max(a, self.t0)) for name, a, b in self.ops
                   if any(p.search(name) for p in patterns))

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for name, a, b in self.ops:
            s = short_name(name)
            by[s] = by.get(s, 0.0) + (b - a)
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_by_host(self, host: list, k: int = 10) -> list:
        """The device's idle time in the sub-window split over the host
        intervals ``host`` (``(name, start_s, end_s)``, not nested) that
        overlap it; idle time no interval covers is ``host.other``."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        host = sorted((h for h in host if h[2] > self.t0 and h[1] < self.t1),
                      key=lambda h: h[1])
        by, j = {}, 0
        for g0, g1 in gaps:
            covered = 0.0
            while j < len(host) and host[j][2] <= g0:
                j += 1
            i = j
            while i < len(host) and host[i][1] < g1:
                name, a, b = host[i]
                o = min(b, g1) - max(a, g0)
                if o > 0:
                    by[name] = by.get(name, 0.0) + o
                    covered += o
                i += 1
            by["host.other"] = by.get("host.other", 0.0) + max(0.0, (g1 - g0) - covered)
        return sorted(([n, s] for n, s in by.items() if s > 0), key=lambda x: -x[1])[:k]


def idle_percent(ctx) -> float | None:
    """The device's idle share of a run's profiled sub-window, in percent;
    None where no device operation was traced."""
    p = ctx.profile
    if p is None or p.t1 is None:
        return None
    busy = p.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / p.window_s)
