"""The RGB head's kernels' share of their roofline in the profiled steps of
the energy objective: two forwards, dx and dW a step
(work_energy.EnergyGan.rgb_head_least_s, bound by bytes), over the device
time of the kernels named in kernel_names/rgb_head/."""
from portbench.work_energy import EnergyGan


def read(ctx):
    if not isinstance(ctx.gan, EnergyGan) or ctx.profile is None or not ctx.profiled:
        return None
    t = ctx.profile.kernel_seconds(ctx.patterns("rgb_head"))
    if t <= 0:
        return None
    return 100.0 * ctx.profiled * ctx.gan.rgb_head_least_s(ctx.batch) / t
