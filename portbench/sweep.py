"""Find the rate a serving cell's system sustains: one engine, set up once,
replays the cell's mix at each rate in turn, and a table says for each the
samples served a second, the latency percentiles from the due time, the
requests refused, how far the queue grew (the median latency of the last
quarter of requests over the first quarter's) and how long the replay ran
past its last arrival.

    python3 portbench/sweep.py --workload dcgan.serve.poisson --seed 7 \\
        --seconds 5 --rates 500 1000 2000 [--out build/portbench/sweep.json]

A rate is sustained where nothing is refused and the queue does not grow.
The cell's ``rate_rps`` is set at four fifths of the highest such rate.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import bench, run
    from portbench.drivers import common, serve_open

    if not torch.cuda.is_available():
        print("portbench: the sweep needs a CUDA card", file=sys.stderr)
        return 2
    run._environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.load_cell(args.workload, trace=False)
    cell.seed, cell.seconds, cell.device = args.seed, args.seconds, "cuda"
    engine, clock, gan = serve_open.build(cell)
    print(f"set-up {time.monotonic() - T_START:.2f} s; {torch.cuda.get_device_name(0)}")
    rows = []
    for rate in args.rates:
        mix = dict(cell.mix, rate_rps=rate, check_requests=0)
        reqs, arrivals = serve_open.schedule(cell, mix, gan)
        engine.metrics.reset()
        common.open_window(False)
        clock.arm()
        engine.replay(reqs, arrivals)
        t_end = time.monotonic()
        common.close_window(False)
        lat = serve_open.latencies(reqs, arrivals, clock.t0)
        q = max(1, len(lat) // 4)
        served = [x for x in lat if x != float("inf")]
        row = {"rate_rps": rate, "requests": len(reqs),
               "samples_per_s": engine.metrics.samples / (t_end - clock.t0),
               "p50_ms": 1e3 * bench.nearest_rank(lat, 0.5),
               "p95_ms": 1e3 * bench.nearest_rank(lat, 0.95),
               "refused": len(lat) - len(served),
               "growth": (statistics.median(lat[-q:]) / statistics.median(lat[:q])
                          if served else float("inf")),
               "drain_ms": 1e3 * (t_end - clock.t0 - arrivals[-1]),
               "batches": engine.metrics.batches,
               "mean_batch": engine.metrics.samples / max(1, engine.metrics.batches)}
        rows.append(row)
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "seed": args.seed,
                                              "seconds": args.seconds, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
