"""Samples of every step the window trained, over the window's wall."""


def read(ctx):
    if ctx.kind != "train" or ctx.window_s <= 0:
        return None
    return ctx.samples / ctx.window_s
