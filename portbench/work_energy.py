"""The energy objective's frozen arithmetic: the useful work of an EB-GAN
training step (``configs/ebgan.json``), counted from layer shapes alone
with ``portbench/work.py``'s functions, frozen here likewise so that a
change to the program never changes the yardstick.

A step at batch ``B`` (``train/gan_trainer.py``'s energy objective):

* the discriminator's phase: the generator forward without gradient; the
  auto-encoder forward on the real and fake rows (2B); its weight
  gradients there, and the input gradients of every layer whose input
  depends on a weight (all but the first encoder conv);
* the generator's phase: the generator forward; the auto-encoder forward
  on the fake rows (B) and its input gradients down to the image (no
  weight gradient: the discriminator's weights need none there); the
  generator's dx and dw, the RGB head's dx and dW, the projection's dW.

Only useful taps count (a transpose conv's sub-kernels over its
never-upsampled input; a conv's 16 taps, padding included), and bytes
count each input, weight and output of a call once, fp32. Elementwise
work (activations, the energy, the hinge), the pulling-away term's Gram
matrix (quadratic in the batch) and the optimizer are not counted.
"""
from __future__ import annotations

from portbench import work


def conv_macs(n_out: int, cin: int, cout: int, k: int = 4) -> int:
    """Multiply-adds of one sample's stride-2 ``k x k`` conv to an
    ``n_out`` square."""
    return n_out * n_out * k * k * cin * cout


class EnergyGan:
    """An EB-GAN configuration's shapes: the generator (``layers``, the RGB
    head's channels), and the auto-encoder (``encoder_widths``; the
    decoder mirrors it)."""

    def __init__(self, cfg: dict):
        self.z_dim = int(cfg["z_dim"])
        self.kernel = int(cfg["kernel"])
        self.padding = int(cfg["padding"])
        self.layers = [tuple(int(v) for v in row) for row in cfg["layers"]]
        self.head = int(cfg["rgb_head"])
        n0, c0, _ = self.layers[0]
        self.proj_out = n0 * n0 * c0
        n_last, _, self.c_last = self.layers[-1]
        self.out_hw = work.output_size(n_last, self.kernel, self.padding)
        self.out_c = self.head
        widths = [int(w) for w in cfg["encoder_widths"]]
        chans = [self.head] + widths
        # (output side, cin, cout) of each encoder conv
        self.enc = [(self.out_hw >> (i + 1), chans[i], chans[i + 1])
                    for i in range(len(widths))]
        back = chans[::-1]
        code_hw = self.out_hw >> len(widths)
        # (input side, cin, cout) of each decoder transpose conv
        self.dec = [(code_hw << i, back[i], back[i + 1]) for i in range(len(widths))]

    # ------------------------------------------------- transpose convs

    def _tconv(self, rows) -> list:
        return [2 * work.tconv_macs(n, self.kernel, ci, co, self.padding)
                for n, ci, co in rows]

    def tconv_flops(self) -> int:
        """Useful transpose-conv FLOPs of one sample's generator forward."""
        return sum(self._tconv(self.layers))

    def decoder_flops(self) -> int:
        """Useful transpose-conv FLOPs of one sample's decoder forward."""
        return sum(self._tconv(self.dec))

    def _tconv_least(self, rows, batch: int, kind: str) -> float:
        """Least time of each layer of ``rows`` at ``batch``: ``fwd``
        (input, weights, bias, output once), ``dx`` (g and the saved y read,
        the weights, dx written), ``dxdw`` (g, y, x and the weights read,
        dx, dw and db written)."""
        total = 0.0
        for n, ci, co in rows:
            m = work.output_size(n, self.kernel, self.padding)
            macs = batch * work.tconv_macs(n, self.kernel, ci, co, self.padding)
            x, y, w = batch * n * n * ci, batch * m * m * co, self.kernel ** 2 * ci * co
            if kind == "fwd":
                flops, elems = 2 * macs, x + w + co + y
            elif kind == "dx":
                flops, elems = 2 * macs, 2 * y + w + x
            else:
                flops, elems = 4 * macs, 2 * y + 2 * x + 2 * w + co
            total += work.least_time(flops, work.DTYPE_BYTES * elems)
        return total

    def tconv_fwd_least_s(self, batch: int) -> float:
        """A step's forward transpose convs: the generator twice at
        ``batch``, the decoder at ``2 batch`` and at ``batch`` rows."""
        return (2 * self._tconv_least(self.layers, batch, "fwd")
                + self._tconv_least(self.dec, 2 * batch, "fwd")
                + self._tconv_least(self.dec, batch, "fwd"))

    def tconv_bwd_least_s(self, batch: int) -> float:
        """A step's backward transpose convs: the generator's dx and dw at
        ``batch``, the decoder's dx and dw at ``2 batch``, its dx alone at
        ``batch``."""
        return (self._tconv_least(self.layers, batch, "dxdw")
                + self._tconv_least(self.dec, 2 * batch, "dxdw")
                + self._tconv_least(self.dec, batch, "dx"))

    def memory_savings_bytes(self) -> int:
        """Bytes of the generator's upsampled maps the segregated forward
        never builds (the paper's Table 4, fp32)."""
        return sum((2 * n - 1 + 2 * self.padding) ** 2 * ci * work.DTYPE_BYTES
                   for n, ci, _ in self.layers)

    # --------------------------------------------------- encoder convs

    def encoder_flops(self) -> int:
        """FLOPs of one sample's encoder forward."""
        return sum(2 * conv_macs(n, ci, co) for n, ci, co in self.enc)

    def _conv_least(self, batch: int, first: bool = True) -> float:
        """Least time of the encoder's convs at ``batch``, forward, dW or
        dx alike: each does the same multiply-adds and moves the input (or
        its gradient), the weights (or theirs) and the output (or its
        gradient) once. ``first=False`` leaves out the first conv."""
        total = 0.0
        for i, (n, ci, co) in enumerate(self.enc):
            if i == 0 and not first:
                continue
            x, y, w = batch * (2 * n) ** 2 * ci, batch * n * n * co, 16 * ci * co
            total += work.least_time(batch * 2 * conv_macs(n, ci, co),
                                     work.DTYPE_BYTES * (x + y + w))
        return total

    def d_conv_least_s(self, batch: int) -> float:
        """A step's encoder convs: forward at ``2 batch`` and ``batch``
        rows, dW at ``2 batch``, dx at ``2 batch`` (but the first conv's,
        whose input is an image) and at ``batch`` (every conv's)."""
        return (2 * self._conv_least(2 * batch) + self._conv_least(batch)
                + self._conv_least(2 * batch, first=False) + self._conv_least(batch))

    # --------------------------------------------------------- RGB head

    def head_flops(self) -> int:
        """FLOPs of one sample's RGB head forward."""
        return 2 * self.out_hw ** 2 * self.c_last * self.head

    def rgb_head_least_s(self, batch: int) -> float:
        """A step's RGB head: two forwards (x, W and b read, y written),
        dx (g, y and W read, dx written) and dW with db (x, g and y read)."""
        px = batch * self.out_hw ** 2
        x, y, w = px * self.c_last, px * self.head, self.c_last * self.head
        fwd = work.least_time(batch * self.head_flops(),
                              work.DTYPE_BYTES * (x + w + self.head + y))
        dx = work.least_time(batch * self.head_flops(), work.DTYPE_BYTES * (2 * y + w + x))
        dw = work.least_time(batch * self.head_flops(),
                             work.DTYPE_BYTES * (x + 2 * y + w + self.head))
        return 2 * fwd + dx + dw

    # ------------------------------------------------------- the step

    def generator_flops(self) -> int:
        """One sample's generator forward: projection, transpose convs and
        the RGB head."""
        return 2 * self.z_dim * self.proj_out + self.tconv_flops() + self.head_flops()

    def train_step_flops(self, batch: int) -> int:
        """Useful FLOPs of one training step at ``batch`` (the module
        docstring's list), linear in the batch."""
        g_fwd, dec, enc = self.generator_flops(), self.decoder_flops(), self.encoder_flops()
        enc_first = 2 * conv_macs(*self.enc[0])
        g_bwd = (2 * self.tconv_flops() + 2 * self.z_dim * self.proj_out
                 + 2 * self.head_flops())
        d_phase = batch * g_fwd + 2 * batch * (enc + dec + 2 * dec + enc + enc - enc_first)
        g_phase = batch * (g_fwd + enc + dec + g_bwd + dec + enc)
        return d_phase + g_phase
