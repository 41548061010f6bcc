"""The device's idle time under the trainer's spans in the profiled
sub-window (each idle instant to the innermost span open then), per step
that started there, in ms."""
from portbench.host_spans import idle_split


def read(ctx):
    if ctx.kind != "train" or not ctx.profiled:
        return None
    split = idle_split(ctx)
    if split is None:
        return None
    under = sum(s for name, s in split.items() if name != "host.other")
    return 1e3 * under / ctx.profiled
