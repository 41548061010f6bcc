"""A generator's RGB head ``tanh(x @ W + b)`` over each pixel of its last
NHWC map: CUDA kernels, their wrappers, plain PyTorch versions and the
autograd function that joins them. No TPU kernel of the reference
corresponds: its Table-4 generators end in their last transpose conv, and
the published EB-GAN (``models/gan.py::EBGAN_PUBLISHED``) ends in this head.

The head is on the served path, so a pixel's bits must not depend on the
batch it is computed in; a batched cuBLAS call does not promise that. The
kernels (``csrc/rgb_head.cu``) give each output one fp32 ``fmaf`` chain in a
fixed order (k ascending forward, c ascending in dx), with a tile of 128
pixels fixed at compile time: the batch sets only the grid. Tanh is applied
to the forward's accumulator, and its derivative ``1 - y^2`` as the
backward reads ``g``. dW and db are summed per block over a run of tiles
set by the pixel count alone, then over the blocks in order: a fixed order,
no atomics.

The generator (``models/gan.py::rgb_head``) calls :class:`RgbHead` on the
card and :func:`head_rows` on the CPU. The wrappers :func:`rgb_head_fwd`,
:func:`rgb_head_dx` and :func:`rgb_head_dw` launch their kernel for a CUDA
tensor and run their plain version for a CPU tensor; each counts its
launches in ``.launches`` (dW's sum of the partials in
``.reduce_launches``), and a CUDA graph's replay adds the launches it
captured (:mod:`repro_torch.graphs`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

PIXEL_TILE = 128    # pixels a block (csrc/rgb_head.cu), which the launchers check
MAX_K = 64          # input channels the kernels take
MAX_C = 4           # output channels the kernels take
DW_BLOCKS = 4 * 132  # dW's partial sums: at most four blocks an H100 SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_split(pixels: int) -> tuple:
    """``(blocks, tiles a block)`` of dW's partial pass: at most
    :data:`DW_BLOCKS` blocks, each a run of whole tiles; a function of the
    pixel count alone, so the sums' order is too."""
    tiles = _cdiv(pixels, PIXEL_TILE)
    per = _cdiv(tiles, min(tiles, DW_BLOCKS))
    return _cdiv(tiles, per), per


def head_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function: ``tanh(x @ w + b)`` over the last axis."""
    return torch.tanh(x @ w + b)


def head_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`head_plain` as one matmul call a sample: the CPU's head. Each
    sample goes through the same call whatever the batch, so its bits do not
    depend on the batch."""
    return torch.cat([head_plain(x[i : i + 1], w, b) for i in range(x.shape[0])])


def tanh_grad(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``g * (1 - y^2)``: the gradient at the head's pre-activation."""
    return g * (1.0 - y * y)


def head_dx_plain(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dx kernel's function: ``(g * (1 - y^2)) @ w^T``."""
    return tanh_grad(g, y) @ w.t()


def head_dw_plain(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor) -> tuple:
    """The dW kernels' function: ``(x^T @ gm, sum gm)`` over every pixel,
    ``gm = g * (1 - y^2)``."""
    gm = tanh_grad(g, y).reshape(-1, g.shape[-1])
    return x.reshape(-1, x.shape[-1]).t() @ gm, gm.sum(0)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rgb_head")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, types in (("rgb_head_f32", [P] * 4 + [L, I, I, I, I, P]),
                        ("rgb_head_dx_f32", [P] * 4 + [L, I, I, I, P]),
                        ("rgb_head_dw_f32", [P] * 6 + [L, I, I, I, I, I, I, P])):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _check(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the RGB head's kernels take float32, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError("the RGB head's operands lie on different devices")


def _check_widths(k: int, c: int) -> None:
    if not (1 <= k <= MAX_K and 1 <= c <= MAX_C):
        raise ValueError(f"the RGB head's kernels take 1-{MAX_K} input and 1-{MAX_C} "
                         f"output channels, got {k} and {c}")


def _vec(x: torch.Tensor, k: int) -> int:
    """16-byte copies of x's tile: rows a multiple of 4 floats, x aligned.
    The copy width never changes a sum."""
    return int(k % 4 == 0 and x.data_ptr() % 16 == 0)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rgb_head_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``tanh(x @ w + b)``, ``x`` (..., K), ``w`` (K, C), ``b`` (C,), as one
    launch of ``rgb_head_kernel`` for CUDA tensors (or raises), or
    :func:`head_plain` for CPU tensors."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0] or b.shape != (w.shape[1],):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not make a head")
    if x.device.type == "cpu":
        return head_plain(x, w, b)
    _check(x, w, b)
    (k, c), pixels = w.shape, x.numel() // w.shape[0]
    _check_widths(k, c)
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    y = torch.empty(x.shape[:-1] + (c,), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _launch("rgb_head", _lib().rgb_head_f32, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                y.data_ptr(), pixels, k, c, PIXEL_TILE, _vec(x, k), _stream(x))
    rgb_head_fwd.launches += 1
    return y


def rgb_head_dx(g: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gradient of the head in ``x`` from its output ``y`` and the
    gradient ``g`` at ``y``: one launch of ``rgb_head_dx_kernel`` for CUDA
    tensors (or raises), :func:`head_dx_plain` for CPU tensors."""
    if g.device.type == "cpu":
        return head_dx_plain(g, y, w)
    _check(g, y, w)
    (k, c), pixels = w.shape, g.numel() // w.shape[1]
    _check_widths(k, c)
    g, y, w = g.contiguous(), y.contiguous(), w.contiguous()
    dx = torch.empty(g.shape[:-1] + (k,), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        _launch("rgb_head_dx", _lib().rgb_head_dx_f32, g.data_ptr(), y.data_ptr(),
                w.data_ptr(), dx.data_ptr(), pixels, k, c, PIXEL_TILE, _stream(g))
    rgb_head_dx.launches += 1
    return dx


def rgb_head_dw(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor) -> tuple:
    """``(dW, db)`` of the head from its input ``x``, output ``y`` and the
    gradient ``g`` at ``y``: the partial pass and their sum, two launches,
    for CUDA tensors (or raises); :func:`head_dw_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return head_dw_plain(x, g, y)
    _check(x, g, y)
    k, c = x.shape[-1], g.shape[-1]
    pixels = x.numel() // k
    if g.numel() != pixels * c:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ in pixels")
    _check_widths(k, c)
    x, g, y = x.contiguous(), g.contiguous(), y.contiguous()
    blocks, tiles = dw_split(pixels)
    opts = dict(device=x.device, dtype=torch.float32)
    part = torch.empty((blocks, k * c + c), **opts)
    dw, db = torch.empty((k, c), **opts), torch.empty((c,), **opts)
    with torch.cuda.device(x.device):
        _launch("rgb_head_dw", _lib().rgb_head_dw_f32, x.data_ptr(), g.data_ptr(),
                y.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(), pixels, k, c,
                PIXEL_TILE, blocks, tiles, _vec(x, k), _stream(x))
    rgb_head_dw.launches += 1
    rgb_head_dw.reduce_launches += 1
    return dw, db


rgb_head_fwd.launches = 0
rgb_head_dx.launches = 0
rgb_head_dw.launches = 0
rgb_head_dw.reduce_launches = 0


class RgbHead(torch.autograd.Function):
    """``tanh(x @ w + b)`` through the three wrappers: the forward keeps its
    output ``y`` (tanh's derivative is a function of it), and the backward
    computes dx only where ``x`` needs a gradient, dW and db only where
    ``w`` or ``b`` does."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = rgb_head_fwd(x, w, b)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        dx = rgb_head_dx(g, y, w) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = rgb_head_dw(x, g, y)
        return dx, dw, db
