"""The mean wall of the program's serve.copy_out span in the profiled
sub-window: the batch's output copied to the host after the sync."""
import statistics

from portbench.host_spans import in_window


def read(ctx):
    walls = [s["dur"] for s in in_window(ctx, "serve.copy_out")]
    return 1e3 * statistics.fmean(walls) if walls else None
