"""The auto-encoder's encoder convs' share of their roofline in the
profiled steps of the energy objective: a step's useful forward, dW and dx
work (work_energy.EnergyGan.d_conv_least_s), over the device time of the
library's conv kernels named in kernel_names/d_conv/."""
from portbench.work_energy import EnergyGan


def read(ctx):
    if not isinstance(ctx.gan, EnergyGan) or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("d_conv"))
    if t <= 0:
        return None
    return 100.0 * ctx.profiled * ctx.gan.d_conv_least_s(ctx.batch) / t
