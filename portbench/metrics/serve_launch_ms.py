"""The mean wall of the program's serve.launch span in the profiled
sub-window: the latents into the graph's static input, the replay's
launch and the launch counters, on the host."""
import statistics

from portbench.host_spans import in_window


def read(ctx):
    walls = [s["dur"] for s in in_window(ctx, "serve.launch")]
    return 1e3 * statistics.fmean(walls) if walls else None
