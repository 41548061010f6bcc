"""The mean lag of a request's admission behind its due time in the
profiled sub-window, by the program's serve.admit spans (the replay
loop's submits: their summed and counted lags), in ms."""
from portbench.host_spans import in_window


def read(ctx):
    spans = in_window(ctx, "serve.admit")
    n = sum(s["args"]["n"] for s in spans)
    if not n:
        return None
    return 1e3 * sum(s["args"]["lag_s"] for s in spans) / n
