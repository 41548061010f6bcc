"""Padded rows over dispatched rows, by the engine's own counters
(ServeMetrics), in percent."""


def read(ctx):
    c = ctx.serve_counts
    if not c.get("padded"):
        return None
    return 100.0 * (c["padded"] - c["samples"]) / c["padded"]
