"""The forward transpose-conv kernels' share of their roofline in the
profiled training steps: two generator forwards a step (the discriminator's
fakes and the generator's), over the device time of the kernels named in
kernel_names/tconv_fwd/."""


def read(ctx):
    if ctx.kind != "train" or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("tconv_fwd"))
    if t <= 0:
        return None
    return 100.0 * 2 * ctx.profiled * ctx.gan.tconv_fwd_least_s(ctx.batch) / t
