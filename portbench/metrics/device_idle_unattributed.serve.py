"""The share of the device's idle time in the profiled sub-window that no
program span covers, in percent: each idle instant goes to the innermost
span open then (its self time), and what no span covers is unattributed.
The harness's own intervals (its sleeps) attribute nothing."""
from portbench.host_spans import idle_split


def read(ctx):
    if ctx.kind != "serve":
        return None
    split = idle_split(ctx)
    if split is None:
        return None
    idle = sum(split.values())
    return 100.0 * split.get("host.other", 0.0) / idle if idle > 0 else 0.0
