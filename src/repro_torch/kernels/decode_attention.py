"""Flash-decode GQA attention: one decoded token attends over a KV cache.
Mirrors ``repro/kernels/decode_attention.py`` (``decode_attention_pallas``).

For each batch row ``b``, KV head ``h`` and grouped query ``g``:
``s_t = (q[b,h,g] . k[b,t,h]) * hd^-0.5`` in fp32, positions ``t >=
kv_len[b]`` masked to ``NEG_INF`` (-1e30, a finite number, as in the
reference), a softmax over ``t`` in fp32, and ``out = sum_t p_t v[b,t,h]``
in fp32. ``q (B, KV, G, hd)``, ``k, v (B, S, KV, hd)`` share one dtype
(fp32 or bf16); ``kv_len (B,)`` is int32; the output is ``(B, KV, G, hd)``
fp32; with ``return_lse=True`` also ``lse (B, KV, G)`` fp32, the log of the
softmax's denominator ``m + log(sum_t e^(s_t - m))`` over the valid
positions (``-inf``, with ``out`` 0, for a row with ``kv_len`` 0): what a
rank holding one slice of a sequence-sharded cache contributes to the
log-sum-exp combine across the slices. Scores, probabilities and sums stay
fp32 throughout, on the CPU and on the card alike (the reference LM's jnp
oracle rounds them to bf16 in a bf16 model; its Pallas kernel, which this
replaces, does not).

:func:`decode_attention` launches the CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors and runs
:func:`decode_attention_ref` for CPU tensors; it never falls back from one
to the other. It counts the first pass's launches in ``.launches`` and the
second pass (the combine of more than one split) apart, in
``.reduce_launches``; a CUDA graph's replay adds the launches it captured
(:mod:`repro_torch.graphs`). It does not synchronise to read ``kv_len``: a caller
keeps it in ``[0, S]`` (the kernel clamps it to that range to stay inside
the cache; a row with ``kv_len`` 0 gives zeros there, and the mean of ``v``
in the plain version without ``return_lse``, as in the reference).

The kernel walks each split of the cache in tiles of K and V staged
together through a cp.async ring; each warp takes a quarter of every tile
and carries the online softmax's (m, l, acc) across tiles, and the warps
merge in order at the end of the split. bf16 scores and P.V run on tensor
cores (``mma.sync``; P enters as a bf16 hi and lo pair, 16 bits, never as
one bf16), fp32 ones on FMAs. Its launch
geometry -- tile, ring depth, split length and count, shared memory -- is
computed here (:func:`decode_geometry`) as a function of ``S``, ``hd``,
``G`` and the dtype alone, never of the batch, and passed to the kernel,
which checks it and derives none of it: the CPU tests emulate the layout
the kernel runs, and a row's bits do not depend on the other rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
WARPS = 4            # the kernel's WARPS: 128 threads a block
THREADS = 32 * WARPS
STAGES = 2           # the kernel's STAGES: depth of the K/V tile ring
TILE_BYTES = 17408   # staged bytes of K (and of V) a tile may take: 64 rows of 272
MAX_TILE = 128       # positions a tile, at most (a power of two)
MIN_TILE = {2: 64, 4: 32}   # ... at least, by element bytes: a bf16 warp's 16 for P.V's mma
MIN_SPLIT_TILES = 4  # tiles a split of the sequence: at least ...
MAX_SPLIT_TILES = 16  # ... and at most
MAX_G = 8            # grouped queries a KV head the kernel takes
SMEM_LIMIT = 232_448     # bytes of shared memory one block may take on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """Launch geometry of the decode kernel for one cache shape."""

    s_len: int
    hd: int
    g: int
    elem: int                # bytes of an element: 2 (bf16) or 4 (fp32)
    tile: int                # positions a ring stage holds, of K and of V
    split_len: int           # positions a block walks: 4 to 16 tiles, by S
    n_splits: int            # ceil(S / split_len): a function of S alone
    pitch: int               # bytes of a staged K or V row: hd * elem + 16
    chunks: int              # 16-byte copies a row
    n_dv: int                # 4-byte groups of a V row; lane l takes l, l + 32, ...
    max_g: int               # fp32 instance: G rounded up to 1, 2, 4 or 8; bf16: 8
    smem_bytes: int

    @property
    def threads(self) -> int:
        return THREADS

    @property
    def warp_positions(self) -> int:
        """Positions of each tile a warp takes (and carries over alone)."""
        return self.tile // WARPS

    def split_ints(self, batch: int, kv_heads: int) -> list:
        """The integer arguments of decode_attention_split before the
        scale, in order."""
        return [batch, self.s_len, kv_heads, self.g, self.hd, self.tile,
                self.split_len, self.n_splits, self.pitch, self.n_dv]


@functools.lru_cache(maxsize=None)
def decode_geometry(s_len: int, hd: int, g: int, dtype: torch.dtype) -> DecodeGeometry:
    """The kernel's geometry, or ``ValueError`` for a shape it does not
    take: ``hd`` a multiple of 16 bytes (16 elements for bf16, whose scores
    take 16-deep tensor-core steps) and at most 512 bytes, ``1 <= G <= 8``.

    A tile is the largest power of two of positions, MIN_TILE to MAX_TILE,
    whose staged K rows take at most TILE_BYTES (hd and the dtype alone). A
    split is the largest power-of-two multiple of the tile, from
    MIN_SPLIT_TILES to MAX_SPLIT_TILES tiles, that keeps at least four
    splits in S (S alone): long caches walk long splits, a short one still
    spreads over the card. Never the batch. The bf16 instances take their
    query rows as the mma's rows, so any G <= 8 runs as max_g 8; the fp32
    ones round G up.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"the decode kernel takes float32 or bfloat16, got {dtype}")
    elem = torch.finfo(dtype).bits // 8
    step = 16 if elem == 2 else 4
    if hd % step or hd * elem > 512:
        raise ValueError(f"the decode kernel takes a head_dim that is a multiple "
                         f"of {step} and at most {512 // elem}, got {hd}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"the decode kernel takes 1 to {MAX_G} grouped queries, got {g}")
    row = hd * elem
    pitch = row + 16
    tile = MAX_TILE
    while tile > MIN_TILE[elem] and tile * pitch > TILE_BYTES:
        tile //= 2
    max_g = 1 if elem == 4 else MAX_G
    while max_g < g:
        max_g *= 2
    split_len = MIN_SPLIT_TILES * tile
    while 2 * split_len <= min(s_len // 4, MAX_SPLIT_TILES * tile):
        split_len *= 2
    n_dv = row // 4
    smem = STAGES * 2 * tile * pitch + 4 * (max_g * tile + g * hd + 3 * WARPS * max_g)
    return DecodeGeometry(
        s_len=s_len, hd=hd, g=g, elem=elem, tile=tile,
        split_len=split_len, n_splits=_cdiv(s_len, split_len), pitch=pitch,
        chunks=row // 16, n_dv=n_dv, max_g=max_g, smem_bytes=smem)


def decode_attention_ref(q, k, v, kv_len, *, return_lse: bool = False):
    """The kernel's function in plain PyTorch, on fp32 upcasts: einsum,
    mask, softmax and weighted sum (and, with ``return_lse``, the
    log-sum-exp of the masked scores; a row with ``kv_len`` 0 then gives
    ``out`` 0 and ``lse`` ``-inf``, as the kernel does)."""
    hd, s_len = q.shape[-1], k.shape[1]
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) * hd ** -0.5
    pos = torch.arange(s_len, device=q.device)
    kv_len = kv_len.to(q.device)
    mask = pos < kv_len[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    if not return_lse:
        return out
    empty = (kv_len <= 0)[:, None, None]
    lse = torch.where(empty, -torch.inf, torch.logsumexp(s, dim=-1))
    return torch.where(empty[..., None], 0.0, out), lse


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_split.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.decode_attention_combine.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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


def decode_attention(q, k, v, kv_len, *, return_lse: bool = False):
    """One decoded token's GQA attention over the cache, ``(B, KV, G, hd)``
    fp32 (and ``lse (B, KV, G)`` fp32 with ``return_lse``). A CUDA tensor
    launches the kernel (and, for a cache of more than one split, the
    combine pass) or raises; a CPU tensor runs
    :func:`decode_attention_ref`, and so does a meta tensor, which holds no
    data (the dry run's shapes)."""
    _check_shapes(q, k, v, kv_len)
    tensors = (q, k, v, kv_len)
    if all(t.device.type == "cpu" for t in tensors) or all(
            t.device.type == "meta" for t in tensors):
        if return_lse:
            return decode_attention_ref(q, k, v, kv_len, return_lse=True)
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
    lse = (torch.empty((b, kvh, g), device=dev, dtype=torch.float32)
           if return_lse else None)
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
            ptr(part_acc), ptr(part_ml), out.data_ptr(), ptr(lse),
            *geo.split_ints(b, kvh),
            hd ** -0.5, geo.max_g, _DTYPES[q.dtype], geo.smem_bytes, stream)
        _check(err, "decode_attention")
        decode_attention.launches += 1
        if geo.n_splits > 1:
            err = _lib().decode_attention_combine(
                part_acc.data_ptr(), part_ml.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), ptr(lse), b, s_len, kvh, g, hd, geo.split_len,
                geo.n_splits, stream)
            _check(err, "decode_attention combine")
            decode_attention.reduce_launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.reduce_launches = 0
