"""The mean wall of the program's train.batch span: drawing a step's
images and latents (data/pipeline.py), over the profiled sub-window (the
spans are on only there)."""
import statistics


def read(ctx):
    walls = ctx.span_walls("train.batch")
    return 1e3 * statistics.fmean(walls) if walls else None
