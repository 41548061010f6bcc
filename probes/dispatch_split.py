#!/usr/bin/env python3
"""Split one served batch's ``serve.dispatch`` on the card into its parts,
at the serving loop's cadence and back to back.

    python3 probes/dispatch_split.py

A warmed per-layer ``GanEngine`` on full-width DCGAN (buckets 1/2/4/8, one
CUDA graph each, as chip_smoke's phase 21 serves it). For each bucket,
``CALLS`` dispatches as ``GanEngine._execute`` makes them, each part timed
on the host clock: the latents copied into the graph's static input (host
to device, from pageable memory), the replay's launch, the launch
counters' update, the synchronise (the device's work), and the host copy
of the output (device to host, into pageable memory); then the same
dispatches through the executable's own call (``fn(params, z)``, the
synchronise, the host copy) whole. Once back to back,
and once with ``GAP_S`` of host sleep between dispatches, as the serving
loop leaves the card idle between batches. ``nvidia-smi`` samples the SM
clock and power every 100 ms beside each mode. Prints one JSON line per
(bucket, mode) with the medians in µs, and the card and its power limit.
"""
import json
import os
import subprocess
import sys
import time

CALLS = 300
GAP_S = 0.001


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import gan

    cs.log = lambda *a: None
    dev = cs.phase_device(torch)
    cs.phase_build()
    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    eng = cs._warm_engine(cfg, params)
    rng = np.random.default_rng(0)
    for bucket in eng.policy.buckets:
        fn = eng._executable(cfg.name, bucket)
        graph = fn.graph
        for mode, gap in (("back_to_back", 0.0), ("gap", GAP_S)):
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            parts = {k: [] for k in ("h2d", "launch", "counters", "sync", "d2h",
                                     "whole")}
            for _ in range(CALLS):
                z = rng.standard_normal((bucket, cfg.z_dim)).astype(np.float32)
                if gap:
                    time.sleep(gap)
                t0 = time.perf_counter()
                graph._static[0].copy_(torch.from_numpy(z))
                t1 = time.perf_counter()
                graph.graph.replay()
                t2 = time.perf_counter()
                graph._counters.add(graph.launches)
                t3 = time.perf_counter()
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                graph.outputs.cpu()
                t5 = time.perf_counter()
                for k, a, b in (("h2d", t0, t1), ("launch", t1, t2),
                                ("counters", t2, t3), ("sync", t3, t4),
                                ("d2h", t4, t5), ("whole", t0, t5)):
                    parts[k].append((b - a) * 1e6)
            engine_path = []   # the same dispatch through the executable's call
            for _ in range(CALLS):
                z = rng.standard_normal((bucket, cfg.z_dim)).astype(np.float32)
                if gap:
                    time.sleep(gap)
                t0 = time.perf_counter()
                out = fn(params, torch.from_numpy(z))
                eng._sync()
                out.cpu()
                engine_path.append((time.perf_counter() - t0) * 1e6)
            smi.terminate()
            samples = [line.split(",") for line in smi.communicate()[0].splitlines()
                       if line.strip()]
            print(json.dumps({
                "device": dev["nvidia_smi"], "bucket": bucket, "mode": mode,
                "calls": CALLS, "us_median": {k: float(np.median(v))
                                              for k, v in parts.items()},
                "us_p90": {k: float(np.percentile(v, 90)) for k, v in parts.items()},
                "engine_path_us_median": float(np.median(engine_path)),
                "sm_mhz": [int(float(s[0])) for s in samples],
                "power_w": [float(s[1]) for s in samples]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
