"""The port's flash-decode attention against the reference on the CPU: the
plain version against the reference's Pallas kernel (interpret mode) and
its jnp oracle, and an emulator of the CUDA kernel's index math (copies,
tile walk, the bf16 scores' mma fragments, the fp32 scores' quarters, each
warp's online rescale and P.V, the warps' merge, split and combine). The kernel itself runs only on the card
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

def _stage_cover(geo):
    """The (position, 16-byte piece) of a tile that each thread's copies
    fill, as stage() steps them from (tid // chunks, tid % chunks) by
    (THREADS // chunks, THREADS % chunks) with one carry. Asserts that every
    piece of the tile is filled exactly once."""
    ch, dt, dc = geo.chunks, da.THREADS // geo.chunks, da.THREADS % geo.chunks
    got = []
    for tid in range(da.THREADS):
        t, c = tid // ch, tid % ch
        while t < geo.tile:
            if c >= ch:
                c, t = c - ch, t + 1
                if t >= geo.tile:
                    break
            got.append((t, c))
            t, c = t + dt, c + dc
    assert sorted(got) == [(t, c) for t in range(geo.tile) for c in range(ch)]


def _a_fragment(q, lane, s):
    """The two 32-bit A registers of mma.m16n8k16 a lane holds for k step
    s: row g = lane / 4, d pairs (2 (lane % 4), +1) and (+8, +9); rows past
    G are zero. Returns {(row, d): value}."""
    g, d = lane >> 2, 16 * s + 2 * (lane & 3)
    if g >= q.shape[0]:
        return {}
    return {(g, dd): q[g, dd] for dd in (d, d + 1, d + 8, d + 9)}


def _b_fragment(kt, lane, blk, s):
    """The two 32-bit B registers a lane reads from the staged K tile for
    position block blk and k step s: K row 8 blk + lane / 4, d pairs
    (2 (lane % 4), +1) and (+8, +9). Returns {(d, position): value}."""
    t, d = 8 * blk + (lane >> 2), 16 * s + 2 * (lane & 3)
    return {(dd, t): kt[t, dd] for dd in (d, d + 1, d + 8, d + 9)}


def _mma_scores(q, kt, n_tiles_of_8):
    """Scores of a tile as the warps' mma.sync fragments give them: for
    each block of 8 positions and k step, the 16 x 16 A and 16 x 8 B
    operands assembled from every lane's registers (each element exactly
    once), multiplied, and each lane's C registers 0 and 1 read as (row
    lane / 4, positions 8 blk + 2 (lane % 4) and +1)."""
    G, hd = q.shape
    S = np.full((G, 8 * n_tiles_of_8), np.nan)
    for blk in range(n_tiles_of_8):
        c = np.zeros((16, 8))
        for s in range(hd // 16):
            a = np.zeros((16, 16))
            b = np.zeros((16, 8))
            seen_a, seen_b = set(), set()
            for lane in range(32):
                for (g, d), val in _a_fragment(q, lane, s).items():
                    assert (g, d) not in seen_a
                    seen_a.add((g, d))
                    a[g, d - 16 * s] = val
                for (d, t), val in _b_fragment(kt, lane, blk, s).items():
                    assert (d, t) not in seen_b
                    seen_b.add((d, t))
                    b[d - 16 * s, t - 8 * blk] = val
            assert len(seen_a) == 16 * G and len(seen_b) == 128
            c += a @ b
        for lane in range(32):
            g, t = lane >> 2, 2 * (lane & 3)
            if g < G:
                S[g, 8 * blk + t: 8 * blk + t + 2] = c[g, t: t + 2]
            assert not c[8:].any()          # the padded rows stay zero
    return S


def _split_bf16(p):
    """p as the kernel splits it for P.V: hi = bf16(p), lo = bf16(p - hi)."""
    t = torch.from_numpy(np.ascontiguousarray(p, np.float32))
    hi = t.to(torch.bfloat16).float()
    lo = (t - hi).to(torch.bfloat16).float()
    return hi.double().numpy(), lo.double().numpy()


def _ldmatrix_v(vt, t0, d0, lane):
    """The four registers ldmatrix.x4.trans gives a lane over the staged V
    rows ``vt`` [position][d]: lane L addresses row t0 + 8 (L / 8 % 2) + L %
    8 at column d0 + 8 (L / 16) for block L / 8; register i of lane T then
    holds block i's elements (rows 2 (T % 4) and +1, column T / 4). Returns
    {(register, half): (position, d)}."""
    rows = {}   # block -> (first position, first column), from the addresses
    for lane_ in range(32):
        blk = lane_ >> 3
        rows.setdefault(blk, set()).add(
            (t0 + 8 * (blk & 1) + (lane_ & 7), d0 + 8 * (lane_ >> 4)))
    got = {}
    for i in range(4):
        pos = sorted({r for r, _ in rows[i]})
        (col,) = {c for _, c in rows[i]}
        assert pos == list(range(pos[0], pos[0] + 8))
        for half in range(2):
            got[(i, half)] = (pos[2 * (lane & 3) + half], col + (lane >> 2))
    return got


def _pv_mma(p, vt, hd):
    """P . V of a warp's 16-position k steps as the kernel's mmas take it:
    A from P's score fragments (row lane / 4, positions 2 (lane % 4) + (0,
    1) and + (8, 9) of each 16), B from ldmatrix_v for each pair of 8-wide
    n-tiles, every element of each operand exactly once; C read back as
    (row lane / 4, d 8 nt + 2 (lane % 4) and +1)."""
    G, tw = p.shape
    out = np.zeros((G, hd))
    for ks in range(tw // 16):
        a = np.zeros((16, 16))
        for lane in range(32):
            g, d = lane >> 2, 2 * (lane & 3)
            if g < G:
                a[g, [d, d + 1, d + 8, d + 9]] = p[g, 16 * ks + np.array([d, d + 1, d + 8, d + 9])]
        for i in range(0, hd // 8, 2):
            bmat = {0: np.full((16, 8), np.nan), 1: np.full((16, 8), np.nan)}
            for lane in range(32):
                for (reg, half), (t, dd) in _ldmatrix_v(vt, 16 * ks, 8 * i, lane).items():
                    k_ = 2 * (lane & 3) + half + 8 * (reg & 1)   # b0: k 0-7, b1: k 8-15
                    n_ = lane >> 2
                    tile = reg >> 1
                    assert t == 16 * ks + k_ and dd == 8 * (i + tile) + n_
                    assert np.isnan(bmat[tile][k_, n_])
                    bmat[tile][k_, n_] = vt[t, dd]
            for tile in (0, 1):
                c = a @ bmat[tile]
                assert not c[8:].any()
                out[:, 8 * (i + tile): 8 * (i + tile) + 8] += c[:G]
    return out


def _simt_scores(q, kt, tw):
    """Scores of the fp32 instance over a warp's ``tw`` positions: a pass of
    the warp takes 8 positions (lane % 8) x 4 quarters (lane / 8) of hd's
    float4s, the quarters summed by shuffles xor 8 then xor 16."""
    G, hd = q.shape
    S = np.zeros((G, tw))
    for blk in range(tw // 8):
        for tl in range(8):
            t = 8 * blk + tl
            parts = []
            for part in range(4):
                d = [4 * d4 + e for d4 in range(part, hd // 4, 4) for e in range(4)]
                parts.append(q[:, d] @ kt[t, d])
            S[:, t] = (parts[0] + parts[1]) + (parts[2] + parts[3])
    return S


def _emulate(q, k, v, kv_len, bf16=False):
    """The CUDA kernel's two launches on the CPU, loop for loop: the blocks
    of the first pass (the splits that return at once, each split's tiles
    and their copies zero-filled past kv_len), each warp's quarter of every
    tile (the scores of the bf16 fragments or of the fp32 quarters, the
    row maxima, the online rescale of the warp's own (m, l, acc), P.V), the
    warps' carries merged in warp order, and the combine (which splits it
    reads). Returns the output and, per (b, h), the splits the first pass
    wrote."""
    B, KV, G, hd = q.shape
    S = k.shape[1]
    geo = da.decode_geometry(S, hd, G, torch.bfloat16 if bf16 else torch.float32)
    _stage_cover(geo)
    TP, TW = geo.tile, geo.warp_positions
    assert TW % (16 if bf16 else 8) == 0 and TW * da.WARPS == TP
    if not bf16:   # P.V's lanes: every element of V's row, by one lane
        lanes = sorted(lane + 32 * j for lane in range(32) for j in range(4)
                       if lane + 32 * j < geo.n_dv)
        assert lanes == list(range(hd))
    out = np.zeros((B, KV, G, hd), np.float64)
    written = {}
    scale = np.float32(hd ** -0.5)
    for b in range(B):
        ln = min(max(int(kv_len[b]), 0), S)
        for h in range(KV):
            parts = {}
            for split in range(geo.n_splits):
                start = split * geo.split_len
                if start >= ln and split > 0:
                    continue                  # the block returns, writes nothing
                n = max(0, min(geo.split_len, ln - start))
                m = np.full((da.WARPS, G), da.NEG_INF)
                l = np.zeros((da.WARPS, G))
                acc = np.zeros((da.WARPS, G, hd))
                for kt in range(-(-n // TP)):
                    for w in range(da.WARPS):
                        t0 = start + kt * TP + w * TW
                        valid = np.arange(TW) < n - kt * TP - w * TW
                        kk = np.zeros((TW, hd))
                        vv = np.zeros((TW, hd))
                        kk[valid] = k[b, t0 + np.flatnonzero(valid), h]   # zero-filled
                        vv[valid] = v[b, t0 + np.flatnonzero(valid), h]
                        sc = (_mma_scores(q[b, h].astype(np.float64), kk, TW // 8) if bf16
                              else _simt_scores(q[b, h].astype(np.float64), kk, TW))
                        sc = np.where(valid, sc * scale, -np.inf)
                        m_new = np.maximum(m[w], sc.max(-1))
                        corr = np.exp(m[w] - m_new)
                        p = np.exp(sc - m_new[:, None])
                        l[w] = l[w] * corr + p.sum(-1)
                        m[w] = m_new
                        if bf16:   # P = hi + lo through two mmas a k step
                            hi, lo = _split_bf16(p)
                            pv = _pv_mma(hi, vv, hd) + _pv_mma(lo, vv, hd)
                        else:
                            pv = p @ vv
                        acc[w] = acc[w] * corr[:, None] + pv
                # the warps merge in warp order
                M = m.max(0)
                f = np.exp(m - M)
                parts[split] = (M, (l * f).sum(0), (acc * f[..., None]).sum(0))
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


def _bf16(*arrays):
    """The arrays rounded to bf16, as fp32."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]


@pytest.mark.parametrize("B,S,KV,G,hd,kv_len,bf16", [
    (3, 1000, 2, 3, 64, [1, 600, 1000], False),   # 4 splits; splits wholly past kv_len
    (2, 700, 2, 7, 64, [256, 257], False),        # Qwen2's G = 7; a split boundary
    (2, 512, 1, 8, 128, [512, 300], False),       # Yi's G = 8 at hd 128
    (1, 200, 4, 1, 128, [200], False),            # MHA, one split (no combine pass)
    (2, 96, 2, 2, 96, [5, 96], False),            # hd 96: a lane's fourth V group idles
    (1, 17000, 1, 1, 128, [16900], False),        # 34 splits: a combine lane takes two
    (2, 600, 2, 4, 128, [192, 331], True),        # bf16: a tile edge, a ragged tile
    (2, 1200, 1, 7, 64, [1200, 640], True),       # bf16 Qwen2: 3 splits, a tile edge
])
def test_kernel_index_math_emulated(B, S, KV, G, hd, kv_len, bf16):
    """The emulated kernel visits exactly the positions below kv_len tile
    by tile, never reads a split it skipped, and agrees with the plain
    version within 1e-4 * max|ref| + 1e-5 (fp32 sums in another order)."""
    q, k, v, kl = _case(S + G, B, S, KV, G, hd, kv_len)
    if bf16:
        q, k, v = _bf16(q, k, v)
    got, written = _emulate(q, k, v, kl, bf16=bf16)
    want = _plain(q, k, v, kl)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5
    geo = da.decode_geometry(S, hd, G, torch.bfloat16 if bf16 else torch.float32)
    for (b, _), splits in written.items():
        used = max(1, -(-int(kl[b]) // geo.split_len))
        assert splits == list(range(used))


@pytest.mark.parametrize("G,hd", [(1, 16), (4, 128), (7, 64), (8, 256)])
def test_mma_fragment_mapping_emulated(G, hd):
    """The bf16 instance's fragment mappings. Scores: every lane's A
    registers (rows lane / 4 of Q, zero past G and for rows 8-15), B
    registers (K rows of the position block) and C registers (row lane / 4,
    positions 2 (lane % 4) and +1) give q . k for every (row, position) of
    a tile. P.V: P's score fragments as A and ldmatrix's transposed V blocks
    as B give p . v for every (row, d). Each element of every operand is
    taken once; and hi + lo keeps P within 2^-16 of itself, where one bf16
    would be 2^-8 off."""
    rng = np.random.default_rng(G * hd)
    q, kt = _bf16(rng.normal(size=(G, hd)).astype(np.float32),
                  rng.normal(size=(64, hd)).astype(np.float32))
    got = _mma_scores(q.astype(np.float64), kt.astype(np.float64), 8)
    np.testing.assert_allclose(got, q.astype(np.float64) @ kt.T.astype(np.float64),
                               rtol=1e-12, atol=1e-12)
    p = rng.uniform(size=(G, 32))
    vt = kt[:32].astype(np.float64)
    np.testing.assert_allclose(_pv_mma(p, vt, hd), p @ vt, rtol=1e-12, atol=1e-12)
    hi, lo = _split_bf16(p)
    assert np.abs(hi + lo - p).max() <= 2.0 ** -16 * p.max()
    assert np.abs(hi - p).max() > 2.0 ** -12 * p.max()


def test_splits_past_kv_len_are_skipped():
    """A split wholly past kv_len is skipped, not weighed: its block returns
    at once and the combine reads only the splits below kv_len. (Masked as
    the reference masks, such a split would hold m = -1e30 and l = its
    length, harmless only while exp(-1e30 - M) underflows.) At kv_len 1 and
    2 of a 4-split cache only split 0 is written, and the result is the
    plain version's."""
    s_len = 4 * da.decode_geometry(1, 64, 4, torch.float32).split_len
    assert da.decode_geometry(s_len, 64, 4, torch.float32).n_splits == 4
    q, k, v, kl = _case(3, 2, s_len, 2, 4, 64, [1, 2])
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
    assert (geo.tile, geo.split_len, geo.n_splits) == (64, 1024, 4)
    assert [da.decode_geometry(s, 128, 4, torch.bfloat16).split_len
            for s in (600, 1024, 2048, 32768)] == [256, 256, 512, 1024]
    assert da.decode_geometry(1024, 128, 4, torch.bfloat16).n_splits == 4
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
    assert geo.tile & (geo.tile - 1) == 0 and da.MIN_TILE[elem] <= geo.tile <= da.MAX_TILE
    assert geo.tile * geo.pitch <= da.TILE_BYTES or geo.tile == da.MIN_TILE[elem]
    assert geo.split_len % geo.tile == 0
    assert da.MIN_SPLIT_TILES * geo.tile <= geo.split_len <= da.MAX_SPLIT_TILES * geo.tile
    assert geo.split_len == da.MIN_SPLIT_TILES * geo.tile or geo.split_len <= 1024 // 4
    assert geo.chunks * 16 == hd * elem and geo.pitch == hd * elem + 16
    assert geo.n_dv * 4 == hd * elem and geo.n_dv <= 4 * 32   # 4 groups a lane at most
    assert geo.warp_positions % (16 if elem == 2 else 8) == 0   # mma k steps / passes
    assert geo.max_g >= g and geo.max_g in ((1, 2, 4, 8) if elem == 4 else (8,))
    assert geo.smem_bytes == (da.STAGES * 2 * geo.tile * geo.pitch
                              + 4 * (geo.max_g * geo.tile + g * hd
                                     + 3 * da.WARPS * geo.max_g))
    assert geo.smem_bytes <= da.SMEM_LIMIT
    if hd * elem <= 256:   # the LM heads: two blocks an SM, each with 1 KB reserved
        assert 2 * (geo.smem_bytes + 1024) <= 233_472


def test_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="grouped queries"):
        da.decode_geometry(1024, 128, 9, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_geometry(1024, 100, 4, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.decode_geometry(1024, 128, 4, torch.float16)


def test_python_constants_match_the_kernel_source():
    src = CU.read_text()
    for name in ("WARPS", "STAGES"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(da, name), name
    assert "constexpr int kMaxBlocks = 4;" in src and da.MAX_TILE == 32 * 4
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "pitch != hd * elem + 16 ||" in src and "n_dv != hd * elem / 4" in src
    assert "decode_attention_pallas" in src   # names the TPU kernel it replaces
