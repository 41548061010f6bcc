"""The backward transpose-conv kernels' share of their roofline in the
profiled training steps: every layer's dx and dw once a step, over the
device time of the kernels named in kernel_names/tconv_bwd/."""


def read(ctx):
    if ctx.kind != "train" or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("tconv_bwd"))
    if t <= 0:
        return None
    return 100.0 * ctx.profiled * ctx.gan.tconv_bwd_least_s(ctx.batch) / t
