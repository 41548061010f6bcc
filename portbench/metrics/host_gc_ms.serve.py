"""Python's collector pauses in the profiled sub-window, by the program's
host.gc spans: ms of collector time per second of the sub-window; 0.0
where the program's collector hook was installed (its host.gc.hook span)
but no collector pass ran, None where no hook was."""
from portbench.host_spans import in_window


def read(ctx):
    p = ctx.profile
    if ctx.kind != "serve" or p is None or p.t1 is None:
        return None
    if not any(s["name"] == "host.gc.hook" for s in ctx.spans):
        return None
    gc_s = sum(s["dur"] for s in in_window(ctx, "host.gc"))
    return 1e3 * gc_s / p.window_s
