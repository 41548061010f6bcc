"""The open-loop serving driver: one generator behind the program's
``GanEngine``, fed an open-loop schedule through ``GanEngine.replay``.

Set-up draws the weights, builds and warms the engine (every bucket's plan
and CUDA graph), makes the schedule and its latents. The window is the
replay: each request is submitted when its arrival is due, batched under the
mix's bucket policy, and answered with its rows on the host. A request's
latency runs from when it was due to when its rows are on the host; a
request that is refused (the engine's backpressure) or fails has none
(infinite), and counts as a failed operation. A request that was admitted
and never resolved is lost, and makes the run incorrect.

The client keeps the rows of the requests it will check and drops the rest
as they arrive, as a client that consumes its answers would, so that a
window's answers do not pile up in host memory.
"""
from __future__ import annotations

import time

import torch

from portbench import devtrace, inputs, work
from portbench.drivers import common
from portbench.reference import gan as ref


def _request_class():
    from repro_torch.serve.gan_engine import GenRequest

    class Request(GenRequest):
        """A request whose rows are kept only where ``keep`` is set; the
        shape of the rows is kept always."""

        keep = False
        rows_shape = None

        @property
        def output(self):
            return self.__dict__.get("_output")

        @output.setter
        def output(self, value):
            if value is not None:
                self.rows_shape = tuple(value.shape)
                if not self.keep:
                    value = None
            self.__dict__["_output"] = value

    return Request


class _Clock:
    """``time.monotonic`` that remembers its first reading after
    :meth:`arm`: the replay's own start, from which arrivals are due. In a
    traced run it starts ``profile`` and the program's spans at its first
    reading ``profile_from`` seconds after that start: the engine reads its
    clock between batches (a dispatch's span never holds a reading), so the
    profiled sub-window holds whole dispatches, whether or not the loop
    ever sleeps."""

    def __init__(self, profile=None, profile_from: float = 0.0):
        self.t0 = None
        self._armed = False
        self.profile, self.profile_from = profile, profile_from

    def arm(self) -> None:
        self._armed = True

    def __call__(self) -> float:
        t = time.monotonic()
        if self._armed:
            self.t0, self._armed = t, False
        elif (self.profile is not None and self.profile.t0 is None
              and self.t0 is not None and t - self.t0 >= self.profile_from):
            common.start_profile(self.profile)
        return t


class _Sleeper:
    """The replay's idle sleep in a traced run, each sleep recorded."""

    def __init__(self):
        self.sleeps: list = []

    def __call__(self, dt: float) -> None:
        t = time.monotonic()
        time.sleep(dt)
        self.sleeps.append(("replay.sleep", t, time.monotonic()))


def build(cell, profile=None):
    """Set-up: the weights, and the engine registered and warmed at every
    bucket. Returns ``(engine, clock, gan)``; ``profile`` is started by the
    clock (:class:`_Clock`) at the mix's ``profile_from`` share of the
    window."""
    from repro_torch.serve.batching import BucketPolicy, pow2_buckets
    from repro_torch.serve.gan_engine import GanEngine

    dev = torch.device(cell.device)
    mix = cell.mix
    gp, _ = inputs.weights(cell.cfg, cell.seed, dev)
    policy = BucketPolicy(buckets=pow2_buckets(mix["max_bucket"]),
                          max_wait_s=mix["max_wait_s"], max_queue=mix["max_queue"])
    clock = _Clock(profile, mix["profile_from"] * cell.seconds)
    engine = GanEngine(policy, device=dev, fuse=mix["fuse"], clock=clock)
    engine.register(common.gan_config(cell.cfg), gp)
    engine.warmup()
    return engine, clock, work.Gan(cell.cfg)


def schedule(cell, mix: dict, gan) -> tuple:
    """``(requests, arrivals_s)`` of ``mix`` over the cell's seconds."""
    sizes, arrivals = inputs.open_loop(mix, cell.seed, cell.seconds)
    keep = set(inputs.check_sample(sizes, mix["check_requests"], cell.seed))
    Request = _request_class()
    reqs = []
    for i, z in enumerate(inputs.latents(sizes, gan.z_dim, cell.seed)):
        r = Request(cell.cfg["name"], z)
        r.keep = i in keep
        reqs.append(r)
    return reqs, arrivals


def latencies(reqs: list, arrivals: list, t0: float) -> list:
    """Each request's latency from its due time; infinite where unserved."""
    return [r.t_done - (t0 + a) if r.done else float("inf")
            for r, a in zip(reqs, arrivals)]


def run(cell) -> common.Outcome:
    dev = torch.device(cell.device)
    cfg, mix = cell.cfg, cell.mix
    profile = devtrace.Profile() if cell.trace else None
    engine, clock, gan = build(cell, profile)
    reqs, arrivals = schedule(cell, mix, gan)
    sleeper = None
    if cell.trace:
        common.warm_profiler(dev)
        sleeper = _Sleeper()

    common.open_window(cell.trace)
    setup_s = time.monotonic() - cell.t_start
    clock.arm()
    engine.replay(reqs, arrivals, sleep=sleeper or time.sleep)
    t_end = time.monotonic()
    common.finish_profile(profile)
    spans = common.close_window(cell.trace)
    peak = common.peak_bytes(dev)

    t0 = clock.t0
    lat = latencies(reqs, arrivals, t0)
    late = sorted(r.t_submit - (t0 + a) for r, a in zip(reqs, arrivals) if r.done)
    m = engine.metrics
    counts = {"samples": m.samples, "padded": m.padded, "batches": m.batches}
    lost = sum(1 for r in reqs if not (r.done or r.rejected or r.failed or r.expired))
    refused = sum(1 for r in reqs if r.rejected or r.failed or r.expired)
    out_shape = (gan.out_hw, gan.out_hw, gan.out_c)
    bad_shape = sum(1 for r in reqs if r.done and r.rows_shape != (r.n,) + out_shape)
    engine = None
    common.release(dev)

    profiled = []
    if profile is not None and profile.t1 is not None:
        profiled = [s["args"]["n_real"] for s in spans if s["name"] == "serve.dispatch"
                    and s["ts"] >= profile.t0 and s["ts"] + s["dur"] <= profile.t1]
    ctx = common.Ctx(kind="serve", gan=gan, setup_s=setup_s, window_s=t_end - t0,
                     peak_bytes=peak, attempted=len(reqs), failed=refused + lost,
                     samples=counts["samples"], latencies_s=lat, spans=spans,
                     serve_counts=counts, profile=profile, profiled=profiled)
    checked = [r for r in reqs if r.keep and r.done]
    numbers = {"served_gap": served_gap(cfg, cell.seed, checked, dev, mix["check_block"]),
               "lost_requests": lost, "bad_shapes": bad_shape}
    host = common.host_intervals(spans, sleeper.sleeps if sleeper else [])
    return common.Outcome(
        ctx=ctx, numbers=numbers,
        busy_s=profile.busy_s() if profile is not None and profile.t1 else None,
        breakdown=common.breakdown(profile, host),
        diagnostics={"checked_requests": len(checked), "batches": counts["batches"],
                     "profile_start_ms": 1e3 * profile.start_s if profile else 0.0,
                     "admit_lag_p95_ms": 1e3 * late[int(0.95 * (len(late) - 1))] if late else 0.0})


def served_gap(cfg: dict, seed: int, reqs: list, device, block: int) -> float:
    """The widest gap of the served rows from the reference's, each
    request's gap over its largest reference value (a row that is not a
    number reads infinite): the reference is given
    the benchmark's weights (drawn again from the seed) and each request's
    latents, in blocks of at most ``block`` rows."""
    gp, _ = inputs.weights(cfg, seed, device)
    worst, i = 0.0, 0
    with torch.no_grad():
        while i < len(reqs):
            group, rows = [], 0
            while i < len(reqs) and (not group or rows + reqs[i].n <= block):
                group.append(reqs[i])
                rows += reqs[i].n
                i += 1
            z = torch.cat([torch.as_tensor(r.z) for r in group]).to(device)
            want = ref.generator(gp, cfg, z)
            at = 0
            for r in group:
                w = want[at: at + r.n]
                got = torch.as_tensor(r.output).to(device)
                gap = float((got - w).abs().max() / w.abs().max().clamp(min=1e-30))
                worst = max(worst, gap if gap == gap else float("inf"))
                at += r.n
    return worst
