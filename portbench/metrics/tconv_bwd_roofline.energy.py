"""The backward transpose-conv kernels' share of their roofline in the
profiled steps of the energy objective: a step's useful backward work (the
generator's dx and dw, the decoder's dx and dw on the real and fake rows,
its dx alone on the fake rows; work_energy.EnergyGan.tconv_bwd_least_s),
over the device time of the kernels named in kernel_names/tconv_bwd/. A dw
computed where no weight needs one shows as a lower share."""
from portbench.work_energy import EnergyGan


def read(ctx):
    if not isinstance(ctx.gan, EnergyGan) or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("tconv_bwd"))
    if t <= 0:
        return None
    return 100.0 * ctx.profiled * ctx.gan.tconv_bwd_least_s(ctx.batch) / t
