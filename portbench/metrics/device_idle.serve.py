"""1 - the union of the device's operations over the profiled
sub-window's wall, in percent."""
from portbench.devtrace import idle_percent


def read(ctx):
    return idle_percent(ctx) if ctx.kind == "serve" else None
