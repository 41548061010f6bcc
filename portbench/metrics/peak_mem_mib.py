"""The allocator's peak over the run up to the window's close, graph
pools included (torch.cuda.max_memory_allocated)."""


def read(ctx):
    if ctx.peak_bytes <= 0:
        return None
    return ctx.peak_bytes / 2 ** 20
