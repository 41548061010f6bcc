"""The forward transpose-conv kernels' share of their roofline in the
profiled sub-window: the least time of the real rows' forward work over
the device time of the kernels named in kernel_names/tconv_fwd/."""


def read(ctx):
    if ctx.kind != "serve" or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("tconv_fwd"))
    if t <= 0:
        return None
    return 100.0 * sum(ctx.gan.tconv_fwd_least_s(n) for n in ctx.profiled) / t
