"""The GAN generators' latent projection ``relu(z @ W)``: CUDA kernels,
their wrappers, plain PyTorch versions and the autograd function that joins
them. No TPU kernel of the reference corresponds: it leaves the projection
to XLA (``repro/models/gan.py::generator_apply``).

A served image must not depend on the bucket its request was packed into,
and a batched cuBLAS call gives a row other bits than its one-row call,
while one call a row costs a launch a row (and, in the backward, a whole
``z[i]^T @ g_i`` a row for autograd to sum). The kernels (``csrc/gan_project.cu``)
give each output one thread and one fp32 ``fmaf`` chain in a fixed order (k
ascending forward, b ascending in dW, j ascending in dz), with tile sizes
fixed at compile time: the batch sets only the grid's row count, so a row's
bits do not depend on the batch, and one launch serves the whole batch.
Relu is applied to the forward's accumulator, and its derivative as the
backward reads g: neither is a pass of its own.

The generator (``models/gan.py::project``) calls :class:`ProjectReLU` on
the card and :func:`project_rows` and ``torch.relu`` on the CPU, the
per-row path the CPU has always run. The wrappers
:func:`project_relu_fwd`, :func:`project_relu_dw` and
:func:`project_relu_dz` launch their kernel for a CUDA tensor and run their
plain version for a CPU tensor; each counts its launches in ``.launches``,
and a CUDA graph's replay adds the launches it captured
(:mod:`repro_torch.graphs`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# The kernels' tiles (csrc/gan_project.cu), which the launchers check
ROW_TILE = 32     # forward: rows of z a block (4 warps x 8 rows)
COL_TILE = 128    # columns of W a block (32 threads x 4 adjacent columns)
DW_ROW_TILE = 32  # dW: rows of W a block (4 warps x 8 rows)
DZ_TILE = 16      # dz: samples and rows of W a block, one output a thread


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def forward_grid(batch: int, n: int) -> tuple:
    """The forward's grid ``(column blocks, row blocks)``: only its second
    axis reads the batch."""
    return (_cdiv(n, COL_TILE), _cdiv(batch, ROW_TILE))


def dw_grid(k: int, n: int) -> tuple:
    """dW's grid ``(column blocks, W-row blocks)``."""
    return (_cdiv(n, COL_TILE), _cdiv(k, DW_ROW_TILE))


def dz_grid(batch: int, k: int) -> tuple:
    """dz's grid ``(W-row blocks, sample blocks)``."""
    return (_cdiv(k, DZ_TILE), _cdiv(batch, DZ_TILE))


def project_rows(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``z @ w`` as one matmul call a row: the CPU's projection. Each row
    goes through the same call whatever the batch, so its bits do not
    depend on the batch."""
    return torch.cat([z[i : i + 1] @ w for i in range(z.shape[0])])


def relu_grad_mask(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` where ``y > 0``, else 0 (``y <= 0 ? 0 : g``: PyTorch's
    ``threshold_backward``, which passes a NaN ``y``'s gradient)."""
    return torch.where(y <= 0, torch.zeros_like(g), g)


def project_relu_plain(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function: ``relu(z @ w)``."""
    return torch.relu(z @ w)


def project_dw_plain(z: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The dW kernel's function: ``z^T @ (g * [y > 0])``."""
    return z.t() @ relu_grad_mask(y, g)


def project_dz_plain(w: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The dz kernel's function: ``(g * [y > 0]) @ w^T``."""
    return relu_grad_mask(y, g) @ w.t()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("gan_project")
    for name, ptrs, ints in (("project_relu_f32", 3, 6), ("project_dw_f32", 4, 6),
                             ("project_dz_f32", 4, 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the projection kernels take float32, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError("the projection's operands lie on different devices")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def project_relu_fwd(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``relu(z @ w)``, ``z`` (B, K) and ``w`` (K, N), as one launch of
    ``project_relu_kernel`` for CUDA tensors (or raises), or
    :func:`project_relu_plain` for CPU tensors."""
    if z.dim() != 2 or w.dim() != 2 or z.shape[1] != w.shape[0]:
        raise ValueError(f"z {tuple(z.shape)} and w {tuple(w.shape)} do not multiply")
    if z.device.type == "cpu":
        return project_relu_plain(z, w)
    _check(z, w)
    z, w = z.contiguous(), w.contiguous()
    (b, k), n = z.shape, w.shape[1]
    y = torch.empty((b, n), device=z.device, dtype=torch.float32)
    with torch.cuda.device(z.device):
        _launch("project_relu", _lib().project_relu_f32, z.data_ptr(), w.data_ptr(),
                y.data_ptr(), b, k, n, ROW_TILE, COL_TILE,
                int(n % 4 == 0 and _aligned(w, y)), _stream(z))
    project_relu_fwd.launches += 1
    return y


def project_relu_dw(z: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``relu(z @ w)`` in ``w`` given its output ``y`` and
    the gradient ``g`` at ``y``: one launch of ``project_dw_kernel`` for
    CUDA tensors (or raises), :func:`project_dw_plain` for CPU tensors."""
    if z.device.type == "cpu":
        return project_dw_plain(z, y, g)
    _check(z, y, g)
    z, y, g = z.contiguous(), y.contiguous(), g.contiguous()
    (b, k), n = z.shape, y.shape[1]
    dw = torch.empty((k, n), device=z.device, dtype=torch.float32)
    with torch.cuda.device(z.device):
        _launch("project_dw", _lib().project_dw_f32, z.data_ptr(), y.data_ptr(),
                g.data_ptr(), dw.data_ptr(), b, k, n, DW_ROW_TILE, COL_TILE,
                int(n % 4 == 0 and _aligned(y, g, dw)), _stream(z))
    project_relu_dw.launches += 1
    return dw


def project_relu_dz(w: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``relu(z @ w)`` in ``z``: one launch of
    ``project_dz_kernel`` for CUDA tensors (or raises),
    :func:`project_dz_plain` for CPU tensors."""
    if w.device.type == "cpu":
        return project_dz_plain(w, y, g)
    _check(w, y, g)
    w, y, g = w.contiguous(), y.contiguous(), g.contiguous()
    (k, n), b = w.shape, y.shape[0]
    dz = torch.empty((b, k), device=w.device, dtype=torch.float32)
    with torch.cuda.device(w.device):
        _launch("project_dz", _lib().project_dz_f32, w.data_ptr(), y.data_ptr(),
                g.data_ptr(), dz.data_ptr(), b, k, n, DZ_TILE, _stream(w))
    project_relu_dz.launches += 1
    return dz


project_relu_fwd.launches = 0
project_relu_dw.launches = 0
project_relu_dz.launches = 0


class ProjectReLU(torch.autograd.Function):
    """``relu(z @ w)`` through the three wrappers: the forward keeps its
    output ``y`` (relu keeps the same), and the backward computes dW, and dz
    only where ``z`` needs a gradient."""

    @staticmethod
    def forward(ctx, z, w):
        y = project_relu_fwd(z, w)
        ctx.save_for_backward(z, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        z, w, y = ctx.saved_tensors
        dz = project_relu_dz(w, y, g) if ctx.needs_input_grad[0] else None
        dw = project_relu_dw(z, y, g) if ctx.needs_input_grad[1] else None
        return dz, dw

