"""Read the numbers the energy cell compares when the program is replaced
by its controls, at the cell's own size: the reference's checked steps in
TF32, and with half of every batch left out, each compared as the
program's steps are (``drivers/train_energy.py``). These are the upper
readings behind ``limits/ebgan.train.b64.json`` (PERF.md gives them); a
state left unchanged reads 1 by the measure and needs no run.

    python3 portbench/controls_energy.py --seeds 1 2 3 [--workload ebgan.train.b64] \\
        [--device cuda] [--out build/portbench/controls_energy.json]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train_control(cell, seed: int, device) -> dict:
    from portbench.drivers import train_energy

    want = train_energy.reference_run(cell.cfg, seed, device)
    out = {}
    for name, kw in (("tf32", {"tf32": True}), ("half_batch", {"half_batch": True})):
        got = dict(train_energy.reference_run(cell.cfg, seed, device, **kw), skipped=0)
        out[name] = train_energy.compare(cell.cfg, seed, device, got, want)
    out["margin_active"] = [s[2] for s in want["stats"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ebgan.train.b64")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.load_cell(args.workload, trace=False)
    device = torch.device(args.device)
    rows = []
    for seed in args.seeds:
        row = {"seed": seed, **train_control(cell, seed, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
