"""The port's flash-decode attention against the reference on the CPU: the
plain version against the reference's Pallas kernel (interpret mode) and
its jnp oracle, and an emulator of the CUDA kernel's split and combine
index math. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.models.layers import _grouped_decode_attention
from repro_torch.kernels import decode_attention as da

CU = Path(da.__file__).parent / "csrc" / "decode_attention.cu"


def _case(seed, B, S, KV, G, hd, kv_len=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    if kv_len is None:
        kv_len = rng.integers(1, S + 1, size=(B,))
    return q, k, v, np.asarray(kv_len, np.int32)


def _oracle(q, k, v, kv_len):
    # _grouped_decode_attention takes q as (B, 1, KV, G, hd)
    o = _grouped_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                                  jnp.asarray(v), kv_len=jnp.asarray(kv_len))
    return np.asarray(o[:, 0])


def _plain(q, k, v, kv_len):
    return da.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, kv_len))).numpy()


# the four cases of tests/test_decode_kernel.py::test_matches_oracle
@pytest.mark.parametrize("B,S,KV,G,hd,bs", [
    (2, 512, 2, 4, 64, 128),
    (1, 1024, 8, 4, 128, 512),
    (3, 256, 1, 8, 32, 64),
    (2, 128, 4, 1, 16, 128),   # MHA (G=1)
])
def test_plain_matches_pallas_kernel_and_oracle(B, S, KV, G, hd, bs):
    """rtol 2e-4 / atol 2e-5: the reference's own tolerance between its
    kernel and its oracle (fp32 sums in other orders)."""
    q, k, v, kv_len = _case(B * S + hd, B, S, KV, G, hd)
    got = _plain(q, k, v, kv_len)
    pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        block_s=bs))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, kv_len), rtol=2e-4, atol=2e-5)


def test_bf16_cache():
    """bf16 q, k, v against the fp32 oracle at the reference's bf16
    tolerance (0.05): the inputs' rounding, not the sums, sets it."""
    q, k, v, kv_len = _case(5, 2, 256, 2, 2, 64)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = da.decode_attention(*bf, torch.from_numpy(kv_len))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, kv_len), rtol=0.05,
                               atol=0.05)
    pallas = decode_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(kv_len),
        block_s=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("name,B,S,KV,G,hd,kv_len", [
    ("full_length", 1, 256, 2, 2, 32, [256]),
    ("single_block", 2, 128, 2, 4, 64, None),
    ("S_not_a_multiple_of_512", 3, 1000, 2, 3, 64, [1, 999, 1000]),
    ("qwen2_group_of_7", 2, 700, 2, 7, 64, [700, 513]),
])
def test_plain_matches_oracle_at_other_lengths(name, B, S, KV, G, hd, kv_len):
    """The plain version only: the Pallas function asserts S % block_s == 0.
    Same tolerance as the reference's kernel test."""
    q, k, v, kl = _case(len(name), B, S, KV, G, hd, kv_len)
    np.testing.assert_allclose(_plain(q, k, v, kl), _oracle(q, k, v, kl),
                               rtol=2e-4, atol=2e-5)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, v, kv_len = (torch.from_numpy(a) for a in _case(1, 2, 64, 2, 2, 16))
    before = (da.decode_attention.launches, da.decode_attention.reduce_launches)
    assert torch.equal(da.decode_attention(q, k, v, kv_len),
                       da.decode_attention_ref(q, k, v, kv_len))
    assert (da.decode_attention.launches, da.decode_attention.reduce_launches) == before
    with pytest.raises(ValueError, match="disagree"):
        da.decode_attention(q, k[:, :, :1], v[:, :, :1], kv_len)


# ------------------------------------------------- the CUDA kernel's index math

def _emulate(q, k, v, kv_len):
    """The CUDA kernel's two passes on the CPU, loop for loop: the blocks of
    the first pass (which positions each lane group visits, which slice of
    hd each lane reads, which splits return at once) and the combine (which
    splits it reads). Returns the output and, per (b, h), the splits the
    first pass wrote. Asserts that each position of a split below kv_len is
    visited exactly once and each element of hd read by exactly one lane."""
    B, KV, G, hd = q.shape
    S = k.shape[1]
    geo = da.decode_geometry(S, hd, G, torch.float32 if q.dtype == np.float32
                             else torch.bfloat16)
    live = [sub * geo.vec for sub in range(geo.lanes) if sub * geo.vec < hd]
    cover = sorted(d for d0 in live for d in range(d0, d0 + geo.vec))
    assert cover == list(range(hd))
    out = np.zeros((B, KV, G, hd), np.float32)
    written = {}
    for b in range(B):
        ln = min(max(int(kv_len[b]), 0), S)
        for h in range(KV):
            parts = {}
            for split in range(geo.n_splits):
                start = split * geo.split_len
                if start >= ln and split > 0:
                    continue                  # the block returns, writes nothing
                n = max(0, min(geo.split_len, ln - start))
                seen = []
                for base in range(0, n, geo.chunk):
                    for u in range(da.UNROLL):
                        for warp in range(da.WARPS):
                            for grp in range(geo.positions_per_warp):
                                t = (base + u * geo.step + warp * geo.positions_per_warp
                                     + grp)
                                if t < n:
                                    seen.append(t)
                assert sorted(seen) == list(range(n))
                kk = k[b, start + np.asarray(seen, int), h].astype(np.float32)
                vv = v[b, start + np.asarray(seen, int), h].astype(np.float32)
                s = sum(q[b, h][:, None, d0:d0 + geo.vec] * kk[None, :, d0:d0 + geo.vec]
                        for d0 in live).sum(-1) * np.float32(hd ** -0.5)
                m = s.max(-1) if n else np.full((G,), da.NEG_INF, np.float32)
                p = np.exp(s - m[:, None])
                parts[split] = (m, p.sum(-1), p @ vv)
            written[(b, h)] = sorted(parts)
            used = max(1, -(-ln // geo.split_len))
            if geo.n_splits == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / np.maximum(l, 1e-30)[:, None]
                continue
            assert all(s in parts for s in range(used))   # the combine reads only these
            # M and the denominator: lane-strided over the splits, each split
            # read by exactly one of a warp's 32 lanes, then across the lanes
            lane_splits = [list(range(lane, used, 32)) for lane in range(32)]
            assert sorted(sum(lane_splits, [])) == list(range(used))
            M = np.max([parts[s][0] for ss in lane_splits for s in ss], axis=0)
            L = sum(parts[s][1] * np.exp(parts[s][0] - M) for ss in lane_splits for s in ss)
            acc = sum(parts[s][2] * np.exp(parts[s][0] - M)[:, None] for s in range(used))
            out[b, h] = acc / np.maximum(L, 1e-30)[:, None]
    return out, written


@pytest.mark.parametrize("B,S,KV,G,hd,kv_len", [
    (3, 1000, 2, 3, 64, [1, 600, 1000]),   # 4 splits; splits wholly past kv_len
    (2, 700, 2, 7, 64, [256, 257]),        # Qwen2's G = 7; a split boundary
    (2, 512, 1, 8, 128, [512, 300]),       # Yi's G = 8 at hd 128
    (1, 200, 4, 1, 128, [200]),            # MHA, one split (no combine pass)
    (2, 96, 2, 2, 96, [5, 96]),            # hd/vec not a power of two: idle lanes
    (2, 9000, 1, 2, 64, [8197, 9000]),     # 33 and 36 splits: a combine lane takes two
])
def test_kernel_index_math_emulated(B, S, KV, G, hd, kv_len):
    """The emulated kernel visits exactly the positions below kv_len, never
    reads a split it skipped, and agrees with the plain version within
    1e-4 * max|ref| + 1e-5 (fp32 sums in another order)."""
    q, k, v, kl = _case(S + G, B, S, KV, G, hd, kv_len)
    got, written = _emulate(q, k, v, kl)
    want = _plain(q, k, v, kl)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5
    geo = da.decode_geometry(S, hd, G, torch.float32)
    for (b, _), splits in written.items():
        used = max(1, -(-int(kl[b]) // geo.split_len))
        assert splits == list(range(used))


def test_splits_past_kv_len_are_skipped():
    """A split wholly past kv_len is skipped, not weighed: its block returns
    at once and the combine reads only the splits below kv_len. (Masked as
    the reference masks, such a split would hold m = -1e30 and l = its
    length, harmless only while exp(-1e30 - M) underflows.) At kv_len 1 and
    2 of a 4-split cache only split 0 is written, and the result is the
    plain version's."""
    q, k, v, kl = _case(3, 2, 1024, 2, 4, 64, [1, 2])
    got, written = _emulate(q, k, v, kl)
    assert all(s == [0] for s in written.values())
    np.testing.assert_allclose(got, _plain(q, k, v, kl), rtol=1e-5, atol=1e-6)
    # position 0 alone: the output is v[:, 0]
    np.testing.assert_allclose(got[0], np.repeat(v[0, 0][:, None], 4, 1), rtol=1e-6,
                               atol=1e-6)


def test_split_count_is_a_function_of_the_cache_length_alone():
    """A row's bits do not depend on the batch: the geometry takes no batch
    size, and the emulated row 0 is bitwise the same alone and beside other
    rows of other lengths."""
    geo = da.decode_geometry(4096, 128, 4, torch.bfloat16)
    assert geo.n_splits == 4096 // da.SPLIT_LEN
    q, k, v, kl = _case(9, 3, 600, 2, 4, 64, [450, 7, 600])
    alone, _ = _emulate(q[:1], k[:1], v[:1], kl[:1])
    batched, _ = _emulate(q, k, v, kl)
    assert np.array_equal(alone[0], batched[0])
    one = _plain(q[:1], k[:1], v[:1], kl[:1])
    assert np.abs(one[0] - batched[0]).max() <= 1e-4 * np.abs(one).max() + 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 7, 8])
def test_geometry_fits_a_block(dtype, hd, g):
    """Every shape the kernel takes: lanes a power of two covering hd, and
    shared memory within what a block may take without opting in."""
    elem = 4 if dtype == torch.float32 else 2
    if hd * elem > 512:
        with pytest.raises(ValueError, match="head_dim"):
            da.decode_geometry(1024, hd, g, dtype)
        return
    geo = da.decode_geometry(1024, hd, g, dtype)
    assert geo.lanes & (geo.lanes - 1) == 0 and geo.lanes <= 32
    assert (geo.lanes // 2) * geo.vec < hd <= geo.lanes * geo.vec
    assert geo.max_g >= g and geo.max_g in (1, 2, 4, 8)
    assert geo.smem_bytes <= da.SMEM_LIMIT


def test_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="grouped queries"):
        da.decode_geometry(1024, 128, 9, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_geometry(1024, 100, 4, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.decode_geometry(1024, 128, 4, torch.float16)


def test_python_constants_match_the_kernel_source():
    src = CU.read_text()
    for name in ("WARPS", "UNROLL"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(da, name), name
    assert "decode_attention_pallas" in src   # names the TPU kernel it replaces
