#!/usr/bin/env python3
"""Profile one full-width DCGAN training step on the card in each of several
checkouts, in turns, so two commits compare on one card.

    python3 probes/step_profile.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each directory is a checkout of the repository (for example one unpacked
with ``git archive`` into a directory that ``.gitignore`` lists). Each runs
in its own process with its own kernels: deterministic algorithms on, as
``chip_smoke.py``'s training phase sets them, five warm-up steps of
``GanTrainer`` (``GanTrainerConfig()`` defaults, global batch 8), then three
profiled steps. Prints one JSON line per run (device µs a step, wall µs,
the top kernels by device time), then a table of each kernel's µs across
the runs.
"""
import json
import os
import subprocess
import sys

TOP = 40


def one(tree: str) -> dict:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from repro_torch.data import SyntheticImages
    from repro_torch.models import gan
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cs.log = lambda *a: None
    cs.phase_device(torch)
    cs.phase_build()
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    cfg, tcfg = gan.DCGAN, GanTrainerConfig()
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                           tcfg.global_batch)
    tr = GanTrainer(cfg, tcfg, data, log_fn=lambda *a: None)
    state, _ = tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=5)
    reals, zs = tr._batches(5)
    prof = cs._profile_step(torch, tr._step_fn, state, reals, zs, calls=3, top=TOP)
    return {"device": torch.cuda.get_device_name(0), "device_us": prof["device_us"],
            "wall_us": prof["wall_us"], "top": prof["top"]}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps({"tree": sys.argv[2], **one(sys.argv[2])}))
        return 0
    runs = []
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: runs[-1][k] for k in ("tree", "device", "device_us",
                                                    "wall_us")}), flush=True)
    names = {}
    for i, run in enumerate(runs):
        for name, us in run["top"]:
            names.setdefault(name[:70], [None] * len(runs))[i] = us
    for name, row in sorted(names.items(), key=lambda kv: -max(v or 0 for v in kv[1])):
        print(f"{name:70s} " + " ".join("       -" if v is None else f"{v:8.1f}"
                                         for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
