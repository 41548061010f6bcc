"""The benchmark's frozen arithmetic: the useful work of a GAN generator,
its discriminator and a training step, counted from layer shapes alone, and
the peaks that a roofline or mfu share is taken against.

The transpose-conv counts are a copy of the port's segregation algebra
(``output_size``, ``phase_extent``, ``subkernel_shape`` and the segregated
multiply count of ``flop_count``), frozen here so that a change to the program
never changes the yardstick. Only useful taps count: a phase's sub-kernel
over the never-upsampled input, never the zeros of the upsampled map.
Bytes count each input, weight and output of a call once, in fp32.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DTYPE_BYTES = 4


def output_size(n_in: int, n_k: int, padding: int) -> int:
    """Output extent of the paper's transpose convolution: ``2N - n + 2P``."""
    m = 2 * n_in - n_k + 2 * padding
    if m <= 0:
        raise ValueError(f"non-positive output size for N={n_in}, n={n_k}, P={padding}")
    return m


def phase_extent(m: int, parity: int) -> int:
    return (m - parity + 1) // 2


def subkernel_shape(n_k: int, r: int, s: int) -> tuple:
    ceil, floor = (n_k + 1) // 2, n_k // 2
    return (ceil if r == 0 else floor), (ceil if s == 0 else floor)


def tconv_macs(n_in: int, n_k: int, cin: int, cout: int, padding: int) -> int:
    """Useful multiply-adds of one sample's stride-2 transpose conv: each
    output parity's sub-kernel over its plane."""
    m = output_size(n_in, n_k, padding)
    total = 0
    for pr in (0, 1):
        for pc in (0, 1):
            rows, cols = subkernel_shape(n_k, (pr + padding) % 2, (pc + padding) % 2)
            total += phase_extent(m, pr) * phase_extent(m, pc) * rows * cols * cin * cout
    return total


def least_time(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


class Gan:
    """A GAN configuration's shapes: ``layers`` rows ``(n_in, cin, cout)``,
    square ``kernel``, ``padding``, ``z_dim``, the discriminator's width."""

    def __init__(self, cfg: dict):
        self.z_dim = int(cfg["z_dim"])
        self.kernel = int(cfg["kernel"])
        self.padding = int(cfg["padding"])
        self.layers = [tuple(int(v) for v in row) for row in cfg["layers"]]
        self.d_width = int(cfg["discriminator_width"])
        n0, c0, _ = self.layers[0]
        self.proj_out = n0 * n0 * c0
        n_last, _, c_last = self.layers[-1]
        self.out_hw = output_size(n_last, self.kernel, self.padding)
        self.out_c = c_last

    # ------------------------------------------------------ generator

    def layer_out(self, i: int) -> int:
        return output_size(self.layers[i][0], self.kernel, self.padding)

    def tconv_flops(self) -> int:
        """Useful transpose-conv FLOPs of one sample's generator forward."""
        return sum(2 * tconv_macs(n, self.kernel, ci, co, self.padding)
                   for n, ci, co in self.layers)

    def generator_flops(self) -> int:
        """One sample's forward: the projection and the transpose convs."""
        return 2 * self.z_dim * self.proj_out + self.tconv_flops()

    def tconv_fwd_least_s(self, batch: int) -> float:
        """Least time of every transpose-conv layer's forward at ``batch``
        real rows: input, weights, bias and output moved once."""
        total = 0.0
        for i, (n, ci, co) in enumerate(self.layers):
            m = self.layer_out(i)
            flops = batch * 2 * tconv_macs(n, self.kernel, ci, co, self.padding)
            nbytes = DTYPE_BYTES * (batch * n * n * ci + self.kernel ** 2 * ci * co
                                    + co + batch * m * m * co)
            total += least_time(flops, nbytes)
        return total

    def tconv_bwd_least_s(self, batch: int) -> float:
        """Least time of every layer's backward at ``batch``: dx and dw (and
        the bias gradient) from the output gradient and the saved output,
        the gradient of the activation folded in; reads g, y, x and the
        weights once, writes dx, dw and db once."""
        total = 0.0
        for i, (n, ci, co) in enumerate(self.layers):
            m = self.layer_out(i)
            flops = batch * 2 * 2 * tconv_macs(n, self.kernel, ci, co, self.padding)
            nbytes = DTYPE_BYTES * (2 * batch * m * m * co + 2 * batch * n * n * ci
                                    + 2 * self.kernel ** 2 * ci * co + co)
            total += least_time(flops, nbytes)
        return total

    def memory_savings_bytes(self) -> int:
        """Bytes of the upsampled maps the segregated forward never builds
        (the paper's Table 4: each layer's whole padded buffer, fp32)."""
        total = 0
        for n, ci, _ in self.layers:
            up = 2 * n - 1 + 2 * self.padding
            total += up * up * ci * DTYPE_BYTES
        return total

    # -------------------------------------------------- discriminator

    def d_convs(self) -> list:
        """FLOPs of each discriminator conv for one sample (three stride-2
        4x4 convs, padding 1, widths w, 2w, 4w)."""
        chans = [self.out_c, self.d_width, 2 * self.d_width, 4 * self.d_width]
        out, hw = [], self.out_hw
        for i in range(3):
            hw //= 2
            out.append(2 * hw * hw * 16 * chans[i] * chans[i + 1])
        return out

    def d_head(self) -> int:
        hw = self.out_hw // 8
        return 2 * hw * hw * 4 * self.d_width

    # ------------------------------------------------------- training

    def train_step_flops(self, batch: int) -> int:
        """Useful FLOPs of one GAN training step at ``batch``: the
        discriminator's phase (the generator forward without gradient, the
        discriminator on real and fake rows, its weight gradients and the
        input gradients of its inner layers) and the generator's (forward,
        the discriminator forward on fakes and its input gradients down to
        the image, the generator's dx and dw and the projection's weight
        gradient). The optimizer's elementwise work is not counted."""
        convs, head = self.d_convs(), self.d_head()
        d_fwd = sum(convs) + head
        g_fwd = self.generator_flops()
        d_phase = batch * g_fwd + 2 * batch * (d_fwd + sum(convs) + head
                                                + sum(convs[1:]) + head)
        g_phase = (batch * (g_fwd + d_fwd + sum(convs) + head)
                   + batch * (2 * self.tconv_flops() + 2 * self.z_dim * self.proj_out))
        return d_phase + g_phase
