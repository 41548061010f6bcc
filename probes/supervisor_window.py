#!/usr/bin/env python3
"""Serve chip_smoke's clean two-replica supervised window (phase 21: full-width
DCGAN, buckets 1/2/4/8, 2000 requests/s open loop for ``SERVE_WINDOW_S``
seconds) several times in one process, before and after chip_smoke's phase
28 (the placed LM runs), and report what each window's dispatches cost.

    python3 probes/supervisor_window.py [--windows N] [--no-placement] [--no-collect]

Per window it prints one JSON line: the card and its power limit, the
slowest and 99.9th-percentile dispatch wall (one replica call, synced, host
clock), the dispatch deadline the supervisor derived at warm-up, the
timeouts, retries and health probes the supervisor counted, and the longest
pause of Python's garbage collector (``gc.callbacks``) with the generation
it collected. Unless ``--no-collect``, each window starts after two timed
full collections, as chip_smoke's windows do: the first frees the earlier
windows' supervisors (their replicas' CUDA graphs), the second is the cost
of a full pass with nothing to free. A clean window has no timeout, retry or
probe.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window(torch, cs, params, cfg, tag: str, collect: bool) -> dict:
    import numpy as np

    from repro_torch.serve import BucketPolicy, Replica, ReplicaSupervisor

    replicas = [Replica(f"r{i}") for i in range(2)]
    sup = ReplicaSupervisor(replicas, BucketPolicy(buckets=(1, 2, 4, 8),
                                                   max_wait_s=0.002, max_queue=256))
    sup.register(cfg, params)
    sup.warmup()
    walls = []
    for r in replicas:
        execute = r.execute

        def timed(name, z, bucket, execute=execute):
            t0 = time.perf_counter()
            out = execute(name, z, bucket)
            walls.append((time.perf_counter() - t0, bucket))
            return out

        r.execute = timed
    pauses, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            pauses.append((time.perf_counter() - started.pop("t"), info["generation"]))

    reqs, arrivals, _ = cs._obs_requests(cfg, cs.OBS_RATE)
    collects = []
    if collect:   # as chip_smoke's windows do: earlier garbage freed first
        for _ in range(2):
            t0 = time.perf_counter()
            gc.collect()
            collects.append((time.perf_counter() - t0) * 1e3)
    gc.callbacks.append(on_gc)
    try:
        sup.replay(reqs, arrivals)
    finally:
        gc.callbacks.remove(on_gc)
    m = sup.metrics
    w = np.array([x for x, _ in walls])
    worst = max(walls)
    gc_worst = max(pauses) if pauses else (0.0, None)
    return {"tag": tag, "device": cs._smi(), "batches": m.batches,
            "dispatch_ms_max": worst[0] * 1e3, "dispatch_max_bucket": worst[1],
            "dispatch_ms_p999": float(np.percentile(w, 99.9)) * 1e3,
            "dispatch_ms_median": float(np.median(w)) * 1e3,
            "deadline_ms": {b: sup.timeout_for("dcgan", b) * 1e3 for b in (1, 2, 4, 8)},
            "timeouts": m.timeouts, "retries": m.retries,
            "probes": sum(r.probe_count for r in replicas),
            "gc_collections": len(pauses), "gc_pause_ms_max": gc_worst[0] * 1e3,
            "gc_pause_generation": gc_worst[1],
            "gc_tracked_objects": len(gc.get_objects()),
            "collect_before_ms": collects}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=3,
                    help="windows before and after phase 28 (default 3)")
    ap.add_argument("--no-placement", action="store_true",
                    help="run no phase 28 between the two groups of windows")
    ap.add_argument("--no-collect", action="store_true",
                    help="start each window without a full collection")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    os.chdir(ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.models import gan

    cs.phase_device(torch)
    cs.phase_build()
    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    rows = [window(torch, cs, params, cfg, f"before {i}", not args.no_collect)
            for i in range(args.windows)]
    for row in rows:
        print(json.dumps(row), flush=True)
    if not args.no_placement:
        t0 = time.perf_counter()
        cs.phase_placement(torch)
        print(json.dumps({"phase 28 s": time.perf_counter() - t0}), flush=True)
    for i in range(args.windows):
        row = window(torch, cs, params, cfg, f"after {i}", not args.no_collect)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
