"""What the drivers share: the run's context that metric readers read, and
the tracing of a traced run (the program's spans and a profiled
sub-window)."""
from __future__ import annotations

import dataclasses
import gc

import torch

from portbench import devtrace, work


@dataclasses.dataclass
class Ctx:
    """What a run gives its metric readers.

    ``kind`` is the driver's loop (``serve`` or ``train``); ``latencies_s``
    every scheduled request's latency from its due time (infinite where it
    was never served); ``samples`` the rows a training window trained;
    ``spans`` the program's spans of the window (traced runs);
    ``serve_counts`` the engine's row counters; ``profile`` the profiled
    sub-window (:class:`~portbench.devtrace.Profile`) and ``profiled`` the
    real rows of each dispatch in it (serve) or its steps (train)."""

    kind: str
    gan: work.Gan
    setup_s: float
    window_s: float
    peak_bytes: int
    attempted: int
    failed: int
    batch: int = 0
    steps: int = 0
    samples: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    serve_counts: dict = dataclasses.field(default_factory=dict)
    profile: devtrace.Profile | None = None
    profiled: object = None

    @staticmethod
    def patterns(family: str) -> list:
        return devtrace.kernel_patterns(family)

    def span_walls(self, name: str) -> list:
        return [s["dur"] for s in self.spans if s["name"] == name]


@dataclasses.dataclass
class Outcome:
    """A run: the readers' context, the numbers compared (before the limits
    are applied), and what a traced run's line adds."""

    ctx: Ctx
    numbers: dict
    busy_s: float | None = None
    breakdown: dict | None = None
    diagnostics: dict = dataclasses.field(default_factory=dict)


def gan_config(cfg: dict):
    """The program's generator configuration, from the configuration file."""
    from repro_torch.models.gan import GANConfig

    return GANConfig(cfg["name"], cfg["z_dim"],
                     tuple(tuple(row) for row in cfg["layers"]),
                     kernel=cfg["kernel"], padding=cfg["padding"])


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in the set-up and not in the window."""
    p = devtrace.Profile()
    p.start()
    (torch.ones(8, device=device) * 2).sum().item()
    p.stop()
    p.collect()


def finish_profile(profile) -> None:
    """End a profiled sub-window that ran to the window's close, and read
    its events."""
    if profile is None or profile.t0 is None:
        return
    if profile.running:
        profile.stop()
    profile.collect()


def open_window(trace: bool):
    """Collect and freeze what set-up made (the schedule, the requests),
    so that no full collection scans it in the window; a traced run gets
    a fresh tracer for the program's spans, which :func:`start_profile`
    turns on."""
    from repro_torch.obs import trace as obs

    gc.collect()
    gc.freeze()
    if trace:
        obs.set_tracer(obs.Tracer(max_events=1_000_000))


def start_profile(profile) -> None:
    """Start the profiled sub-window and the program's spans with it. The
    spans stay off before it: the program's tracing costs the serving loop
    time a request, and that loop runs near its edge (PERF.md)."""
    from repro_torch.obs import trace as obs

    profile.start()
    obs.enable()


def close_window(trace: bool) -> list:
    """The window's spans (traced runs), tracing off again."""
    from repro_torch.obs import trace as obs

    gc.unfreeze()
    if not trace:
        return []
    obs.disable()
    return list(obs.get_tracer().spans)


LEAF_SPANS = ("serve.pack", "serve.dispatch", "serve.slice", "train.batch",
              "train.step_fn")


def host_intervals(spans: list, extra: list) -> list:
    """``(name, start, end)`` of the host's leaf activities: the program's
    innermost spans and the harness's own intervals ``extra``."""
    out = [(s["name"], s["ts"], s["ts"] + s["dur"]) for s in spans
           if s["name"] in LEAF_SPANS]
    return out + list(extra)


def breakdown(profile, host: list) -> dict | None:
    if profile is None or profile.t1 is None:
        return None
    return {"device_ops": profile.top_ops(), "idle_gaps": profile.idle_by_host(host)}


def peak_bytes(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
