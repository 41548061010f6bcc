"""Useful FLOPs of the training step (work.Gan.train_step_flops) times
the window's steps, over the window's wall, as a share of the fp32 peak,
in percent."""
from portbench import work


def read(ctx):
    if ctx.kind != "train" or ctx.window_s <= 0:
        return None
    flops = ctx.gan.train_step_flops(ctx.batch) * ctx.steps
    return 100.0 * flops / ctx.window_s / work.PEAK_FLOPS
