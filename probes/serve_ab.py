#!/usr/bin/env python3
"""Serve chip_smoke's open-loop window (phase 6's trace: full-width DCGAN,
per layer, buckets 1/2/4/8) through ``GanEngine`` in each of several
checkouts, in turns, so two commits compare on one card.

    python3 probes/serve_ab.py [--rate R] PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each directory is a checkout of the repository (for example one unpacked
with ``git archive`` into a directory that ``.gitignore`` lists). Each run
is its own process with its own kernels: a freshly warmed engine (one CUDA
graph per bucket, tracing off), then one window of ``SERVE_WINDOW_S``
seconds at ``R`` requests/s (default 2000) drawn from the same seed as
phase 6. Prints one JSON line per run (served samples/s, done and rejected
requests, batches, latency percentiles, the replay's wall, the card and
its power limit), then a table of the runs.
"""
import json
import os
import subprocess
import sys
import time


def one(tree: str, rate: float) -> dict:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import gan
    from repro_torch.serve import GenRequest

    cs.log = lambda *a: None
    dev = cs.phase_device(torch)
    cs.phase_build()
    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    eng = cs._warm_engine(cfg, params)
    rng = np.random.default_rng(int(rate))
    count = int(rate * cs.SERVE_WINDOW_S)
    sizes = rng.integers(1, 5, size=count)
    zs = rng.standard_normal((int(sizes.sum()), cfg.z_dim)).astype(np.float32)
    ends = np.cumsum(sizes)
    reqs = [GenRequest("dcgan", zs[e - n : e]) for n, e in zip(sizes, ends)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=count)).tolist()
    t0 = time.perf_counter()
    eng.replay(reqs, arrivals)
    wall_s = time.perf_counter() - t0
    s = eng.metrics.summary()
    return {"device": dev["nvidia_smi"], "rate": rate,
            "samples_per_s": s["samples_per_s"], "done": s["requests"],
            "rejected": s["rejected"], "batches": s["batches"],
            "latency_ms": {k: v * 1e3 for k, v in s["latency_s"].items()},
            "wall_s": wall_s}


def main() -> int:
    args = sys.argv[1:]
    rate = 2000.0
    if args[:1] == ["--rate"]:
        rate, args = float(args[1]), args[2:]
    if args[:1] == ["--one"]:
        print(json.dumps({"tree": args[1], **one(args[1], rate)}))
        return 0
    runs = []
    for tree in args:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--rate",
                              str(rate), "--one", tree],
                             capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(f"{'tree':<28} {'samples/s':>10} {'done':>6} {'rejected':>8} "
          f"{'batches':>7} {'p50 ms':>8} {'p95 ms':>8} {'p99 ms':>8}")
    for r in runs:
        lat = r["latency_ms"]
        print(f"{r['tree']:<28} {r['samples_per_s']:>10.1f} {r['done']:>6} "
              f"{r['rejected']:>8} {r['batches']:>7} {lat['p50']:>8.3f} "
              f"{lat['p95']:>8.3f} {lat['p99']:>8.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
