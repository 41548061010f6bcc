"""The energy cell at a reduced width, for the CPU tests: the same layer
stacks and geometry at a sixteenth of the channels (the RGB head's three
output channels kept), a batch of two and a window of a second."""
import copy
import time

import portbench_cpu_cells as cpu
from portbench import bench

NAME = "ebgan.train.b64"


def reduced(cfg: dict, scale: int = 16) -> dict:
    """``cfg`` at 1/``scale`` of every width (at least two channels), the
    RGB head's output kept, batch 2."""
    c = copy.deepcopy(cfg)
    c["layers"] = [[n, max(ci // scale, 2), max(co // scale, 2)] for n, ci, co in cfg["layers"]]
    c["encoder_widths"] = [max(w // scale, 2) for w in cfg["encoder_widths"]]
    c["train"]["global_batch"] = 2
    return c


def cell(*, trace: bool = False, seed: int = cpu.SEED, seconds: float = 1.0):
    """The energy cell on the CPU at a reduced width, ready to run."""
    c = bench.load_cell(NAME, trace=trace)
    c.cfg = reduced(c.cfg)
    c.seed, c.seconds, c.device, c.t_start = seed, seconds, "cpu", time.monotonic()
    return c
