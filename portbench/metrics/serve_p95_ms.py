"""The 95th percentile of every scheduled request's latency, from its
due time to its rows on the host (an unserved request ranks last)."""
from portbench.bench import nearest_rank


def read(ctx):
    if ctx.kind != "serve":
        return None
    return 1e3 * nearest_rank(ctx.latencies_s, 0.95)
