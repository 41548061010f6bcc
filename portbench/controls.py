"""Read the numbers a cell compares when the program is replaced by its
control, and by the faults a training cell can have, at the cell's own
size: the readings the cells' limits are set from (PERF.md gives them).

* Serving cells: the reference computed in TF32 in the program's place, on
  the rows of the requests a run of that seed checks.
* Training cells: the reference's checked steps in TF32, and with half of
  every batch left out, each compared as the program's steps are. A step
  that returns its state unchanged reads 1 by the measure and needs no run.

    python3 portbench/controls.py --workload dcgan.train.b128 --seeds 1 2 3 \\
        [--device cuda] [--out build/portbench/controls.json]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_control(cell, seed: int, device) -> dict:
    import torch

    from portbench import inputs, work
    from portbench.drivers import serve_open
    from portbench.reference import gan as ref

    gan = work.Gan(cell.cfg)
    sizes, _ = inputs.open_loop(cell.mix, seed, cell.seconds)
    zs = inputs.latents(sizes, gan.z_dim, seed)
    picked = inputs.check_sample(sizes, cell.mix["check_requests"], seed)
    gp, _ = inputs.weights(cell.cfg, seed, device)

    class Rows:
        def __init__(self, z):
            self.z, self.n = z, z.shape[0]
            with torch.no_grad():
                self.output = ref.generator(gp, cell.cfg, torch.as_tensor(z).to(device),
                                            tf32=True).cpu()

    reqs = [Rows(zs[i]) for i in picked]
    return {"tf32": {"served_gap": serve_open.served_gap(
        cell.cfg, seed, reqs, device, cell.mix["check_block"])}}


def train_control(cell, seed: int, device) -> dict:
    from portbench.drivers import train

    want = train.reference_run(cell.cfg, seed, device)
    out = {}
    for name, kw in (("tf32", {"tf32": True}), ("half_batch", {"half_batch": True})):
        got = dict(train.reference_run(cell.cfg, seed, device, **kw), skipped=0)
        out[name] = train.compare(cell.cfg, seed, device, got, want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.load_cell(args.workload, trace=False)
    cell.seconds = args.seconds
    device = torch.device(args.device)
    fn = serve_control if cell.mix["driver"] == "serve_open" else train_control
    rows = []
    for seed in args.seeds:
        row = {"seed": seed, **fn(cell, seed, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
