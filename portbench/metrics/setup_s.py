"""Set-up: from process start to the window's start (imports, CUDA,
kernels, weights, warm-up and graph capture of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
