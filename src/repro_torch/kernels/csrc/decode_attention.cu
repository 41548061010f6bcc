// Flash-decode GQA attention for one decoded token, for sm_90a.
//
// Replaces the Pallas TPU kernel decode_attention_pallas (_kernel) of
// src/repro/kernels/decode_attention.py. The function, for each batch row b,
// KV head h and grouped query g (query head h*G + g):
//   s_t = (q[b,h,g] . k[b,t,h]) * hd^-0.5      dot product in fp32
//   p_t = exp(s_t - m) over t < kv_len[b],      m = max_t s_t
//   out[b,h,g] = (sum_t p_t v[b,t,h]) / max(sum_t p_t, 1e-30)
//   lse[b,h,g] = m + log(sum_t p_t), or -inf where kv_len[b] is 0 (optional)
// q (B, KV, G, hd), k and v (B, S, KV, hd) in fp32 or bf16, kv_len (B,) int32,
// out (B, KV, G, hd) fp32, lse (B, KV, G) fp32 when asked for (the weight
// of this cache's part in a log-sum-exp combine across ranks that each hold
// a slice of the sequence). Scores, probabilities and sums are fp32 (the
// bf16 instance's P.V takes P as two bf16 parts, see below).
//
// What bounds it on the H100: bytes. Each K and V row up to kv_len is read
// once and used for 2G flops an element; at G <= 8 that is far below the
// card's ridge, so the least time is the bytes of q, of the K and V rows up
// to kv_len and of the output over 3.35 TB/s (134 MB, 40 us, for Llama-3-8B
// at batch 8 and S = 4096).
//
// The two-pass design before this one (commit 44da5ae) read K in one pass
// and V in a second, each with its own loads in flight only a few
// positions deep and a shuffle tree a position (probes/decode_ablation.py:
// each pass alone ran at ~1.4 TB/s and the two added up; the softmax
// between them and the combine cost little). This design keeps the bytes
// in flight whatever the arithmetic does:
// - One pass with the TPU kernel's carries. A block (split, KV head, batch
//   row) walks its split in tiles of `tile` positions and carries (m, l,
//   acc) across tiles with an online rescale, as _kernel carries m_scr,
//   l_scr and acc_scr across its grid steps. K and V tiles of one position
//   range stage together through a 2-stage cp.async ring straight from the
//   cache (16-byte copies, zero-filled past kv_len by the source size: a
//   block never reads past kv_len): the next tile's bytes (34 KB at bf16
//   hd 128) are in flight while the current one computes. Three blocks an
//   SM keep ~100 KB in flight; a 3-stage ring fits two and ran slower.
// - Scores on tensor cores (bf16). Q (G <= 8 rows, padded to 16) is the A
//   operand of mma.sync.m16n8k16, held in registers for the whole split; a
//   K tile row is a column of B, read from shared memory in 32-bit pairs;
//   a warp's quarter of the tile is 2 to 4 blocks of 8 positions. A bf16 x
//   bf16 product is exact in fp32 and the tensor core sums in fp32, so only the
//   order of the sum differs from the plain version: |error| <= hd * 2^-23
//   * sum_d |q_d k_d| or so (about 1e-6 here), against a gate of 1e-4 *
//   max|ref|. The fp32 instance computes scores with fp32 FMAs (tensor cores
//   have no exact fp32 path): 8 positions x 4 quarters of hd a pass of a
//   warp, summed over the quarters by two shuffles.
// - Warps work alone between tiles. Each warp takes a quarter of every
//   tile and carries its own (m, l, acc) over its positions: scores, the
//   row maxima (shuffles among the lanes of a row), the rescale, P and P.V
//   need no block barrier, so a tile costs one __syncthreads (the ring's).
//   The four warps' carries merge in warp order after the split.
// - P.V keeps P's precision. P is never rounded to one bf16 (SDPA's
//   rounding of P costs 3e-4 at S 4096, near the gate). bf16: P's score
//   fragments are, register for register, the A operand of P.V's
//   mma.sync (FlashAttention-2's layout), entered twice, as hi = bf16(p)
//   and lo = bf16(p - hi): |p - hi - lo| <= 2^-18 p, so out moves by at
//   most 2^-18 max|v| beyond the fp32 sums' own error; V's B fragments come
//   from ldmatrix.trans of the staged tile. fp32: P goes to the warp's
//   shared memory, each lane owns 4-byte groups of V's row for every query
//   row, loads 4 positions' P as one broadcast float4 a row, and sums
//   p * v with FMAs.
// - Splits. The sequence is cut into splits of split_len positions, a
//   function of S, hd and the dtype alone (decode_geometry), never of B, so
//   a row's bits do not depend on which other rows are busy. A split wholly
//   past kv_len returns at once and writes nothing; with more than one split
//   a second launch (combine_kernel) merges the ceil(kv_len / split_len)
//   splits that hold a position, in split order (split 0 always runs, so a
//   row with kv_len 0 gives zeros, and lse -inf). No atomics anywhere.
// wgmma, TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;                // decode_attention.WARPS
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;               // decode_attention.STAGES
constexpr int kMaxBlocks = 4;           // 8-position blocks a warp a tile: tile <= 128
constexpr float NEG_INF = -1e30f;       // the reference's mask value, finite

struct Args {
  int S, KV, G, hd;
  int tile;        // positions a tile: a multiple of 32
  int split_len;   // positions a split: a multiple of tile
  int n_splits;    // ceil(S / split_len)
  int pitch;       // bytes of a staged K or V row: hd * elem + 16
  int n_dv;        // 4-byte groups of a V row: hd * elem / 4
  float scale;     // hd^-0.5, rounded to fp32
};

__device__ __forceinline__ int valid_len(const int* kv_len, int b, int S) {
  return min(max(kv_len[b], 0), S);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d = a * b + c on the tensor cores: A 16 x 16 bf16 (rows 8-15 zero here),
// B 16 x 8 bf16, C and D 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return sizeof(T) == 2; }

// Issue this thread's copies of tile `kt` of K and of V into ring slot
// `slot`. (t, c): this thread's first (position, 16-byte piece); dt, dc its
// step, fixed for the kernel, so the loop divides by nothing.
__device__ __forceinline__ void stage(char* slot, const char* kb, const char* vb,
                                      size_t row_bytes, int kt, int n, int tile,
                                      int pitch, int chunks, int t, int c, int dt,
                                      int dc) {
  char* ks = slot;
  char* vs = slot + tile * pitch;
  const int t0 = kt * tile;
  for (; t < tile; t += dt, c += dc) {
    if (c >= chunks) {
      c -= chunks;
      ++t;
      if (t >= tile) break;
    }
    const bool in = t0 + t < n;
    const size_t off = in ? static_cast<size_t>(t0 + t) * row_bytes + 16 * c : 0;
    cp_async16(ks + t * pitch + 16 * c, kb + off, in);
    cp_async16(vs + t * pitch + 16 * c, vb + off, in);
  }
}

// x rounded to bf16 (hi) and the bf16 of what that leaves (lo), each pair
// packed for an mma operand (first element in the low half).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The B fragments of two 8-wide n-tiles of V (d0..d0+15) over the 16
// positions t0..t0+15 of the staged tile at `vs`: ldmatrix's transpose of
// four 8 x 8 blocks, rows (positions) read 16 bytes at a time. Lane L gives
// the row address of block L / 8: positions t0 + 8 (L / 8 % 2) + L % 8,
// columns d0 + 8 (L / 16).
__device__ __forceinline__ void ldmatrix_v(const char* vs, int pitch, int t0, int d0, int lane,
                                           uint32_t (&b)[4]) {
  const char* row = vs + (t0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * pitch +
                    2 * (d0 + 8 * (lane >> 4));
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(a));
}

// The first pass. Instances: bf16 by HD, the head dimension rounded up to
// 64, 128 or 256 (its rows are the mma's, so any G <= 8 runs in one); fp32
// by MAXG, G rounded up to 1, 2, 4 or 8.
// (min 1 block an SM: without it ptxas held two instances to 80 registers
// and spilled)
template <typename T, int MAXG, int HD>
__global__ void __launch_bounds__(THREADS, 1)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             float* __restrict__ out, float* __restrict__ lse, const Args a) {
  constexpr bool BF16 = is_bf16<T>();
  constexpr int KSTEPS = HD / 16;          // bf16: 16-deep steps of a score
  constexpr int NT = HD / 8;               // bf16: 8-wide n-tiles of a V row
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = valid_len(kv_len, b, a.S);
  const int start = split * a.split_len;
  if (start >= len && split > 0) return;   // wholly past kv_len: skipped, see above
  const int n = max(0, min(a.split_len, len - start));
  const int n_tiles = (n + a.tile - 1) / a.tile;

  const int G = a.G, hd = a.hd, TP = a.tile, pitch = a.pitch;
  const int TW = TP / WARPS;                                  // positions a warp a tile
  char* ring = smem;                                          // [STAGES][K, V][TP][pitch]
  float* sp = reinterpret_cast<float*>(smem + STAGES * 2 * TP * pitch);   // [WARPS][MAXG][TW]
  float* qs = sp + MAXG * TP;                                 // [G][hd] (fp32 instance)
  float* cw = qs + G * hd;                                    // [WARPS][MAXG] rescales
  float* mw = cw + WARPS * MAXG;                              // [WARPS][MAXG] carries
  float* lw = mw + WARPS * MAXG;                              // [WARPS][MAXG]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_bytes = static_cast<size_t>(a.KV) * hd * sizeof(T);
  const size_t base = ((static_cast<size_t>(b) * a.S + start) * a.KV + h) * hd * sizeof(T);
  const char* kb = reinterpret_cast<const char*>(k) + base;
  const char* vb = reinterpret_cast<const char*>(v) + base;
  const int chunks = hd * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  const int ct = tid / chunks, cc = tid % chunks;             // once, before the loop
  const int dt = THREADS / chunks, dc = THREADS % chunks;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      stage(ring + st * 2 * TP * pitch, kb, vb, row_bytes, st, n, TP, pitch, chunks, ct, cc,
            dt, dc);
    cp_async_commit();
  }

  // Q: the A fragments of the bf16 instance in registers (row g = lane / 4,
  // d pairs 2 (lane % 4) and 8 + 2 (lane % 4) of each 16-wide k step; rows
  // past G are zero), or fp32 rows in shared memory.
  const T* qb = q + (static_cast<size_t>(b) * a.KV + h) * G * hd;
  const int g4 = lane >> 2, d4 = 2 * (lane & 3);   // the bf16 fragments' row and column
  uint32_t qa[BF16 ? KSTEPS : 1][2];
  if constexpr (BF16) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const bool on = g4 < G && 16 * s < hd;
      qa[s][0] = on ? *reinterpret_cast<const uint32_t*>(qb + g4 * hd + 16 * s + d4) : 0u;
      qa[s][1] = on ? *reinterpret_cast<const uint32_t*>(qb + g4 * hd + 16 * s + 8 + d4) : 0u;
    }
  } else {
    for (int i = tid; i < G * hd; i += THREADS) qs[i] = static_cast<float>(qb[i]);
  }

  // This warp's carries over its positions of every tile: (m, l) of each
  // query row (bf16: the row lane / 4 in m[0], l[0]; fp32: every row, the
  // same in every lane) and acc: bf16, the mma's C fragments of every
  // n-tile of V's row (row lane / 4, d 8 nt + 2 (lane % 4) and +1; the
  // padded rows' registers stay zero); fp32, each row over this lane's
  // 4-byte groups of V's row (lane, lane + 32, ...).
  float m[MAXG], l[MAXG];
  float acc[BF16 ? NT : MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (BF16 ? NT : MAXG); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float* pw = sp + warp * MAXG * TW;        // fp32: this warp's P [MAXG][TW]
  float* cwarp = cw + warp * MAXG;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();               // everyone's did; tile kt - 1 is consumed
    if (kt + STAGES - 1 < n_tiles)
      stage(ring + (kt + STAGES - 1) % STAGES * 2 * TP * pitch, kb, vb, row_bytes,
            kt + STAGES - 1, n, TP, pitch, chunks, ct, cc, dt, dc);
    cp_async_commit();
    const char* ks = ring + (kt % STAGES) * 2 * TP * pitch + warp * TW * pitch;
    const char* vs = ks + TP * pitch;
    const int nt = n - kt * TP - warp * TW;   // this warp's positions below kv_len

    // scores of this warp's TW positions, scaled, -inf at or past kv_len;
    // the online softmax over them; then acc = acc * corr + P . V
    if constexpr (BF16) {
      float sc[kMaxBlocks][2];
      float mt = -INFINITY;
#pragma unroll
      for (int blk = 0; blk < kMaxBlocks; ++blk) {
        if (8 * blk >= TW) break;
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        const char* kr = ks + (8 * blk + g4) * pitch + 2 * d4;
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) {
          if (16 * s < hd)
            mma_bf16(c4, qa[s][0], qa[s][1], *reinterpret_cast<const uint32_t*>(kr + 32 * s),
                     *reinterpret_cast<const uint32_t*>(kr + 32 * s + 16));
        }
        const int t = 8 * blk + d4;   // c4[0], c4[1]: row g4, positions t and t + 1
        sc[blk][0] = t < nt ? c4[0] * a.scale : -INFINITY;
        sc[blk][1] = t + 1 < nt ? c4[1] * a.scale : -INFINITY;
        mt = fmaxf(mt, fmaxf(sc[blk][0], sc[blk][1]));
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));   // the row's 4 lanes
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[0], mt);
      const float corr = expf(m[0] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int blk = 0; blk < kMaxBlocks; ++blk) {
        if (8 * blk >= TW) break;
        sc[blk][0] = expf(sc[blk][0] - m_new);
        sc[blk][1] = expf(sc[blk][1] - m_new);
        ps += sc[blk][0] + sc[blk][1];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[0] = l[0] * corr + ps;
      m[0] = m_new;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        acc[i][0] *= corr;
        acc[i][1] *= corr;
      }
      // P's C fragments are the A fragments of P . V (row g4, positions
      // 2 (lane % 4) and +1, then +8 and +9, of each 16): P = hi + lo in
      // two bf16 mmas, so P keeps 16 bits where one bf16 keeps 8
#pragma unroll
      for (int ksv = 0; ksv < kMaxBlocks / 2; ++ksv) {
        if (16 * ksv >= TW) break;
        uint32_t a0h, a0l, a2h, a2l;
        split_bf16(sc[2 * ksv][0], sc[2 * ksv][1], a0h, a0l);
        split_bf16(sc[2 * ksv + 1][0], sc[2 * ksv + 1][1], a2h, a2l);
#pragma unroll
        for (int i = 0; i < NT; i += 2) {
          if (8 * i >= hd) break;
          uint32_t bv[4];
          ldmatrix_v(vs, pitch, 16 * ksv, 8 * i, lane, bv);
          mma_bf16(acc[i], a0h, a2h, bv[0], bv[1]);
          mma_bf16(acc[i], a0l, a2l, bv[0], bv[1]);
          mma_bf16(acc[i + 1], a0h, a2h, bv[2], bv[3]);
          mma_bf16(acc[i + 1], a0l, a2l, bv[2], bv[3]);
        }
      }
    } else {
      const int tl = lane & 7, part = lane >> 3;
      float sc[kMaxBlocks][MAXG];
#pragma unroll
      for (int blk = 0; blk < kMaxBlocks; ++blk) {
        if (8 * blk >= TW) break;
        const int t = 8 * blk + tl;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) sc[blk][g] = 0.f;
        const float* kr = reinterpret_cast<const float*>(ks + t * pitch);
        for (int dq = part; dq < hd / 4; dq += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * dq);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + g * hd + 4 * dq);
              sc[blk][g] = fmaf(qv.x, kv.x, sc[blk][g]);
              sc[blk][g] = fmaf(qv.y, kv.y, sc[blk][g]);
              sc[blk][g] = fmaf(qv.z, kv.z, sc[blk][g]);
              sc[blk][g] = fmaf(qv.w, kv.w, sc[blk][g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {   // the 4 quarters of hd, in a fixed order
          sc[blk][g] += __shfl_xor_sync(0xffffffffu, sc[blk][g], 8);
          sc[blk][g] += __shfl_xor_sync(0xffffffffu, sc[blk][g], 16);
          sc[blk][g] = t < nt ? sc[blk][g] * a.scale : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float mt = -INFINITY;
#pragma unroll
        for (int blk = 0; blk < kMaxBlocks; ++blk)
          if (8 * blk < TW) mt = fmaxf(mt, sc[blk][g]);
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)   // the warp's 8 positions a block
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[g], mt);
        const float corr = expf(m[g] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int blk = 0; blk < kMaxBlocks; ++blk) {
          if (8 * blk >= TW) break;
          const float p = expf(sc[blk][g] - m_new);
          ps += p;
          if (g < G && part == 0) pw[g * TW + 8 * blk + tl] = p;
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l[g] = l[g] * corr + ps;
        m[g] = m_new;
        if (g < G && lane == 0) cwarp[g] = corr;
      }
      __syncwarp();
      // acc = acc * corr + P . V over this lane's groups of V's row, in fp32
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
          const float cr = cwarp[g];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][j] *= cr;
        }
      for (int t = 0; t < TW; t += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (lane + 32 * j >= a.n_dv) break;
          const float* vr = reinterpret_cast<const float*>(vs) + lane + 32 * j;
          const float v0 = vr[t * pitch / 4], v1 = vr[(t + 1) * pitch / 4];
          const float v2 = vr[(t + 2) * pitch / 4], v3 = vr[(t + 3) * pitch / 4];
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float4 p = *reinterpret_cast<const float4*>(pw + g * TW + t);
              acc[g][j] = fmaf(p.x, v0, acc[g][j]);
              acc[g][j] = fmaf(p.y, v1, acc[g][j]);
              acc[g][j] = fmaf(p.z, v2, acc[g][j]);
              acc[g][j] = fmaf(p.w, v3, acc[g][j]);
            }
          }
        }
      }
      __syncwarp();   // pw is read; the next tile may write it
    }
  }

  // the warps' carries meet in shared memory (the ring is free), merged in
  // warp order: M = max_w m_w, acc = sum_w acc_w e^(m_w - M), l likewise
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // [WARPS][G][hd]
  if constexpr (BF16) {
    if (g4 < G) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (8 * i < hd)
          *reinterpret_cast<float2*>(red + (warp * G + g4) * hd + 8 * i + d4) =
              make_float2(acc[i][0], acc[i][1]);
      if ((lane & 3) == 0) {
        mw[warp * MAXG + g4] = m[0];
        lw[warp * MAXG + g4] = l[0];
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < a.n_dv) red[(warp * G + g) * hd + lane + 32 * j] = acc[g][j];
        if (lane == 0) {
          mw[warp * MAXG + g] = m[g];
          lw[warp * MAXG + g] = l[g];
        }
      }
  }
  __syncthreads();

  const size_t head = static_cast<size_t>(b) * a.KV + h;
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float mx = mw[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, mw[w * MAXG + g]);
    float sum = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(mw[w * MAXG + g] - mx);
      sum = fmaf(red[(w * G + g) * hd + i % hd], f, sum);
      ls = fmaf(lw[w * MAXG + g], f, ls);
    }
    if (a.n_splits == 1) {
      out[head * G * hd + i] = sum / fmaxf(ls, 1e-30f);
      if (lse != nullptr && i % hd == 0) lse[head * G + g] = ls > 0.f ? mx + logf(ls) : -INFINITY;
    } else {
      part_acc[(head * a.n_splits + split) * G * hd + i] = sum;
      if (i % hd == 0) {
        float* ml = part_ml + ((head * a.n_splits + split) * G + g) * 2;
        ml[0] = mx;
        ml[1] = ls;
      }
    }
  }
}

// The second pass: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)
// over the splits i < ceil(kv_len / split_len), in split order. A block a
// (batch row, KV head, slice of THREADS output elements): one warp a query
// row finds M and the denominator over the splits (lane-strided, then a
// shuffle tree), then each thread sums its element over the splits with
// independent loads, 4 in flight.
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int* __restrict__ kv_len, float* __restrict__ out,
               float* __restrict__ lse, const Args a) {
  __shared__ float ms[8], ls[8];   // MAX_G query rows
  const int head = blockIdx.x;
  const int b = head / a.KV;
  const int len = valid_len(kv_len, b, a.S);
  const int used = max(1, (len + a.split_len - 1) / a.split_len);
  const int G = a.G, hd = a.hd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* ml = part_ml + static_cast<size_t>(head) * a.n_splits * G * 2;
  const float* pa = part_acc + static_cast<size_t>(head) * a.n_splits * G * hd;
  for (int g = warp; g < G; g += WARPS) {
    float m = NEG_INF;
    for (int s = lane; s < used; s += 32) m = fmaxf(m, ml[(s * G + g) * 2]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int s = lane; s < used; s += 32)
      l = fmaf(ml[(s * G + g) * 2 + 1], expf(ml[(s * G + g) * 2] - m), l);
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }
  __syncthreads();
  const int i = blockIdx.y * THREADS + tid;
  if (i >= G * hd) return;
  const int g = i / hd;
  const float m = ms[g];
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < used; ++s)
    acc = fmaf(pa[static_cast<size_t>(s) * G * hd + i], expf(ml[(s * G + g) * 2] - m), acc);
  out[static_cast<size_t>(head) * G * hd + i] = acc / fmaxf(ls[g], 1e-30f);
  if (lse != nullptr && i % hd == 0)
    lse[static_cast<size_t>(head) * G + g] = ls[g] > 0.f ? m + logf(ls[g]) : -INFINITY;
}

// The shared memory decode_attention.decode_geometry gives a block.
int smem_bytes_of(const Args& a, int max_g) {
  return STAGES * 2 * a.tile * a.pitch + 4 * (max_g * a.tile + a.G * a.hd + 3 * WARPS * max_g);
}

template <typename T, int MAXG, int HD>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* kv_len,
                         float* part_acc, float* part_ml, float* out, float* lse, int B,
                         const Args& a, int smem_bytes, cudaStream_t stream) {
  auto kernel = split_kernel<T, MAXG, HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.n_splits, a.KV, B);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, part_acc, part_ml, out, lse, a);
  return cudaGetLastError();
}

// The instances: bf16 by its head-dimension bucket (G <= 8 rides the
// mma's 16 rows), fp32 by max_g. decode_attention.decode_geometry gives
// max_g = 8 for bf16.
cudaError_t dispatch(bool bf16, int max_g, const void* q, const void* k, const void* v,
                     const int* kv_len, float* pa, float* pm, float* o, float* ls, int B,
                     const Args& a, int smem_bytes, cudaStream_t s) {
  if (bf16) {
    if (max_g != 8) return cudaErrorInvalidValue;
    if (a.hd <= 64)
      return launch_split<__nv_bfloat16, 8, 64>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    if (a.hd <= 128)
      return launch_split<__nv_bfloat16, 8, 128>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    return launch_split<__nv_bfloat16, 8, 256>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
  }
  switch (max_g) {
    case 1: return launch_split<float, 1, 128>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    case 2: return launch_split<float, 2, 128>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    case 4: return launch_split<float, 4, 128>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    case 8: return launch_split<float, 8, 128>(q, k, v, kv_len, pa, pm, o, ls, B, a, smem_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The first pass. part_acc (B, KV, n_splits, G, hd) and part_ml (B, KV,
// n_splits, G, 2) are scratch, unused (may be null) when n_splits == 1, in
// which case out (and lse, unless null) is written directly. Returns the
// launch's CUDA error, or cudaErrorInvalidValue when the geometry disagrees
// with this kernel.
int decode_attention_split(const void* q, const void* k, const void* v,
                           const void* kv_len, void* part_acc, void* part_ml,
                           void* out, void* lse, int B, int S, int KV, int G, int hd,
                           int tile, int split_len, int n_splits, int pitch,
                           int n_dv, float scale, int max_g, int bf16, int smem_bytes,
                           void* stream) {
  const Args a{S, KV, G, hd, tile, split_len, n_splits, pitch, n_dv, scale};
  const int elem = bf16 ? 2 : 4;
  if (G < 1 || G > max_g || hd * elem % 16 || hd * elem > 512 || (bf16 && hd % 16) ||
      tile < (bf16 ? 64 : 32) || tile > 32 * kMaxBlocks || tile % 32 || split_len % tile ||
      n_splits != (S + split_len - 1) / split_len || pitch != hd * elem + 16 ||
      n_dv != hd * elem / 4 || smem_bytes != smem_bytes_of(a, max_g))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(bf16 != 0, max_g, q, k, v, static_cast<const int*>(kv_len),
                                   static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                                   static_cast<float*>(out), static_cast<float*>(lse), B, a,
                                   smem_bytes,
                                   static_cast<cudaStream_t>(stream)));
}

// The second pass, for n_splits > 1; lse may be null.
int decode_attention_combine(const void* part_acc, const void* part_ml,
                             const void* kv_len, void* out, void* lse, int B, int S, int KV,
                             int G, int hd, int split_len, int n_splits,
                             void* stream) {
  const Args a{S, KV, G, hd, 0, split_len, n_splits, 0, 0, 0.f};
  const dim3 grid(B * KV, (G * hd + THREADS - 1) / THREADS);
  combine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(kv_len), static_cast<float*>(out), static_cast<float*>(lse), a);
  return cudaGetLastError();
}

}  // extern "C"
