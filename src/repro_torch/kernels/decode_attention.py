"""Flash-decode GQA attention: one decoded token attends over a KV cache.
Mirrors ``repro/kernels/decode_attention.py`` (``decode_attention_pallas``).

For each batch row ``b``, KV head ``h`` and grouped query ``g``:
``s_t = (q[b,h,g] . k[b,t,h]) * hd^-0.5`` in fp32, positions ``t >=
kv_len[b]`` masked to ``NEG_INF`` (-1e30, a finite number, as in the
reference), a softmax over ``t`` in fp32, and ``out = sum_t p_t v[b,t,h]``
in fp32. ``q (B, KV, G, hd)``, ``k, v (B, S, KV, hd)`` share one dtype
(fp32 or bf16); ``kv_len (B,)`` is int32; the output is ``(B, KV, G, hd)``
fp32. Scores, probabilities and sums stay fp32 throughout, on the CPU and
on the card alike (the reference LM's jnp oracle rounds them to bf16 in a
bf16 model; its Pallas kernel, which this replaces, does not).

:func:`decode_attention` launches the CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors and runs
:func:`decode_attention_ref` for CPU tensors; it never falls back from one
to the other. It counts the first pass's launches in ``.launches`` and the
second pass (the combine of more than one split) apart, in
``.reduce_launches``. It does not synchronise to read ``kv_len``: a caller
keeps it in ``[1, S]`` (the kernel clamps it to ``[0, S]`` to stay inside
the cache; a row with ``kv_len`` 0 gives zeros there, and the mean of ``v``
in the plain version, as in the reference).

The kernel's launch geometry, its lane layout included, is computed here
(:func:`decode_geometry`) as a function of ``S``, ``hd``, ``G`` and the
dtype alone, never of the batch, and passed to the kernel, which derives
none of it: the CPU tests emulate the layout the kernel runs, and a row's
bits do not depend on the other rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SPLIT_LEN = 256      # cache positions a block of the first pass walks
WARPS = 4            # the kernel's WARPS: 128 threads a block
UNROLL = 4           # the kernel's UNROLL: positions a lane loads before using any
MAX_G = 8            # grouped queries a KV head the kernel takes
SMEM_LIMIT = 48 * 1024   # shared memory a block may take without opting in
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """Launch geometry of the decode kernel for one cache shape."""

    s_len: int
    hd: int
    g: int
    vec: int                 # elements a lane loads at once: 16 bytes
    lanes: int               # lanes a cache position: a power of two >= hd / vec
    positions_per_warp: int  # 32 // lanes
    step: int                # positions the block covers per unrolled slot
    chunk: int               # positions the block covers per loop step
    split_len: int
    n_splits: int            # ceil(S / split_len): a function of S alone
    max_g: int               # the kernel instance: G rounded up to 1, 2, 4 or 8
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def decode_geometry(s_len: int, hd: int, g: int, dtype: torch.dtype) -> DecodeGeometry:
    """The kernel's geometry, or ``ValueError`` for a shape it does not
    take: ``hd`` a multiple of 16 bytes of the dtype and at most 512 bytes
    (one warp a row), ``1 <= G <= 8``."""
    if dtype not in _DTYPES:
        raise TypeError(f"the decode kernel takes float32 or bfloat16, got {dtype}")
    elem = torch.finfo(dtype).bits // 8
    vec = 16 // elem
    if hd % vec or hd * elem > 512:
        raise ValueError(f"the decode kernel takes a head_dim that is a multiple "
                         f"of {vec} and at most {512 // elem}, got {hd}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"the decode kernel takes 1 to {MAX_G} grouped queries, got {g}")
    lanes = 1
    while lanes * vec < hd:
        lanes *= 2
    ppw = 32 // lanes
    step = WARPS * ppw
    max_g = 1
    while max_g < g:
        max_g *= 2
    split_len = SPLIT_LEN
    floats = g * hd + g * max(split_len, WARPS * hd) + 2 * g
    return DecodeGeometry(
        s_len=s_len, hd=hd, g=g, vec=vec, lanes=lanes, positions_per_warp=ppw,
        step=step, chunk=step * UNROLL, split_len=split_len,
        n_splits=_cdiv(s_len, split_len), max_g=max_g, smem_bytes=4 * floats)


def decode_attention_ref(q, k, v, kv_len) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on fp32 upcasts: einsum,
    mask, softmax and weighted sum."""
    hd, s_len = q.shape[-1], k.shape[1]
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) * hd ** -0.5
    pos = torch.arange(s_len, device=q.device)
    mask = pos < kv_len.to(q.device)[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkh->bkgh", p, v.float())


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_split.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.decode_attention_combine.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    for fn in (lib.decode_attention_split, lib.decode_attention_combine):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_shapes(q, k, v, kv_len) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, KV, G, hd) and k, v (B, S, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, _, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, hd) or tuple(kv_len.shape) != (b,):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and kv_len "
                         f"{tuple(kv_len.shape)} disagree")


def decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """One decoded token's GQA attention over the cache, ``(B, KV, G, hd)``
    fp32. A CUDA tensor launches the kernel (and, for a cache of more than
    one split, the combine pass) or raises; a CPU tensor runs
    :func:`decode_attention_ref`."""
    _check_shapes(q, k, v, kv_len)
    tensors = (q, k, v, kv_len)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_ref(q, k, v, kv_len)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"expected q, k, v and kv_len on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the decode kernel takes contiguous q, k, v and kv_len")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the decode kernel reads k and v in 16-byte loads: "
                         "their storage must be 16-byte aligned")
    b, kvh, g, hd = q.shape
    s_len = k.shape[1]
    geo = decode_geometry(s_len, hd, g, q.dtype)
    out = torch.empty((b, kvh, g, hd), device=dev, dtype=torch.float32)
    part_acc = part_ml = None
    if geo.n_splits > 1:
        part_acc = torch.empty((b, kvh, geo.n_splits, g, hd), device=dev,
                               dtype=torch.float32)
        part_ml = torch.empty((b, kvh, geo.n_splits, g, 2), device=dev,
                              dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        err = _lib().decode_attention_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            ptr(part_acc), ptr(part_ml), out.data_ptr(), b, s_len, kvh, g, hd,
            geo.lanes, geo.positions_per_warp, geo.step, geo.chunk,
            geo.split_len, geo.n_splits, hd ** -0.5, geo.max_g,
            _DTYPES[q.dtype], geo.smem_bytes, stream)
        _check(err, "decode_attention")
        decode_attention.launches += 1
        if geo.n_splits > 1:
            err = _lib().decode_attention_combine(
                part_acc.data_ptr(), part_ml.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), b, s_len, kvh, g, hd, geo.split_len,
                geo.n_splits, stream)
            _check(err, "decode_attention combine")
            decode_attention.reduce_launches += 1
    return out


decode_attention.launches = 0
decode_attention.reduce_launches = 0
