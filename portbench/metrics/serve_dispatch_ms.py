"""The mean wall of the program's serve.dispatch span: the graph's
replay, the sync and the copy of the rows to the host, over the profiled
sub-window (the spans are on only there)."""
import statistics


def read(ctx):
    walls = ctx.span_walls("serve.dispatch")
    return 1e3 * statistics.fmean(walls) if walls else None
