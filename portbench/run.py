"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and metrics are found by name
(``portbench/bench.py``). The program under test is ``repro_torch`` in the
checkout's ``src/``. The last line of standard output is the result, one
JSON object; the last lines of standard error are each compared number
beside its limit. Exits 2 without a result when the card, the cell's
number of cards or the program is missing, and 3 when a JAX module was
loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def _environment() -> None:
    """The program's autotune cache at a fixed path under ``TMPDIR`` (else
    under the checkout's ``build/``), removed first, so that every run
    resolves the cold plans."""
    base = os.environ.get("TMPDIR")
    tmp = (Path(base) if base else ROOT / "build") / "portbench"
    tmp.mkdir(parents=True, exist_ok=True)
    cache = tmp / "autotune.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import bench

    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"the program is missing: no {ROOT / 'src' / 'repro_torch'}", 2)
    cell = bench.load_cell(args.workload, trace=bool(args.trace))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"{cell.name} needs {cell.chips} CUDA card(s), found {have}", 2)
    _environment()
    sys.path.insert(0, str(ROOT / "src"))
    # the configurations are fp32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False

    cell.seed, cell.seconds = args.seed, args.seconds
    cell.device, cell.t_start = "cuda", T_START
    outcome = bench.run(cell)
    metrics = bench.read_metrics(cell, outcome)
    correct, checks = bench.judge(cell, outcome.numbers)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(bench.FORBIDDEN))
    if loaded:
        return _fail(f"modules of JAX or the JAX package were loaded: {loaded}", 3)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.ctx.peak_bytes}
    line = {"correct": correct, "attempted": outcome.ctx.attempted,
            "failed": outcome.ctx.failed, "metrics": metrics, "device": device}
    if cell.trace:
        if outcome.busy_s is None:
            return _fail("the traced run profiled no device operation", 4)
        device["busy_s"] = outcome.busy_s
        device["window_s"] = outcome.ctx.profile.window_s
        if outcome.breakdown is not None:
            line["breakdown"] = outcome.breakdown
    line["diagnostics"] = outcome.diagnostics
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
