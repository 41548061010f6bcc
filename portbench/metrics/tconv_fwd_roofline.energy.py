"""The forward transpose-conv kernels' share of their roofline in the
profiled steps of the energy objective: a step's useful forward work (the
generator twice, the auto-encoder's decoder on the real and fake rows and
again on the fake rows; work_energy.EnergyGan.tconv_fwd_least_s), over the
device time of the kernels named in kernel_names/tconv_fwd/."""
from portbench.work_energy import EnergyGan


def read(ctx):
    if not isinstance(ctx.gan, EnergyGan) or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("tconv_fwd"))
    if t <= 0:
        return None
    return 100.0 * ctx.profiled * ctx.gan.tconv_fwd_least_s(ctx.batch) / t
