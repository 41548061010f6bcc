"""The benchmark's cells at a reduced width, for the CPU tests: the same
layer stacks and geometry at a sixteenth of the channels, a few requests
or a small batch, and a window of a second."""
import copy
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import bench  # noqa: E402

# the cells plan cold: never read a persistent autotune cache
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="portbench-autotune-"), "autotune.json")

SEED = 2 ** 31 + 11

# EB-GAN's generator as the survey's Table 4 lists it: no cell runs it yet,
# and the tests hold the reference and the arithmetic to its depth
EBGAN_LAYERS = [[4, 2048, 1024], [8, 1024, 512], [16, 512, 256], [32, 256, 128],
                [64, 128, 64], [128, 64, 64]]


def reduced(cfg: dict, scale: int = 16) -> dict:
    """``cfg`` at 1/``scale`` of every width but the output's channels."""
    c = copy.deepcopy(cfg)
    last = len(cfg["layers"]) - 1
    c["layers"] = [[n, max(ci // scale, 2), co if i == last else max(co // scale, 2)]
                   for i, (n, ci, co) in enumerate(cfg["layers"])]
    c["discriminator_width"] = max(cfg["discriminator_width"] // scale, 2)
    c["train"]["global_batch"] = 4 if cfg["layers"][-1][0] < 64 else 2
    return c


def cell(name: str, *, trace: bool = False, seed: int = SEED, seconds: float = 1.0):
    """The cell ``name`` on the CPU at a reduced width, ready to run."""
    c = bench.load_cell(name, trace=trace)
    c.cfg = reduced(c.cfg)
    if c.mix["driver"] == "serve_open":
        c.mix = dict(c.mix, rate_rps=12.0, check_requests=6)
    c.seed, c.seconds, c.device, c.t_start = seed, seconds, "cpu", time.monotonic()
    return c
