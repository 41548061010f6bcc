"""Useful generator FLOPs of the real rows served (the projection and
the transpose convs' useful taps) over the summed serve.dispatch walls of the
profiled sub-window (the spans are on only there), as a share of the fp32
peak, in percent."""
from portbench import work


def read(ctx):
    spans = [s for s in ctx.spans if s["name"] == "serve.dispatch"]
    wall = sum(s["dur"] for s in spans)
    if not wall:
        return None
    rows = sum(s["args"]["n_real"] for s in spans)
    return 100.0 * ctx.gan.generator_flops() * rows / wall / work.PEAK_FLOPS
