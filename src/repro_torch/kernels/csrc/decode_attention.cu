// Flash-decode GQA attention for one decoded token, for sm_90a.
//
// Replaces the Pallas TPU kernel decode_attention_pallas (_kernel) of
// src/repro/kernels/decode_attention.py. The function, for each batch row b,
// KV head h and grouped query g (query head h*G + g):
//   s_t = (q[b,h,g] . k[b,t,h]) * hd^-0.5      dot product in fp32
//   p_t = exp(s_t - m) over t < kv_len[b],      m = max_t s_t
//   out[b,h,g] = (sum_t p_t v[b,t,h]) / max(sum_t p_t, 1e-30)
// q (B, KV, G, hd), k and v (B, S, KV, hd) in fp32 or bf16, kv_len (B,) int32,
// out (B, KV, G, hd) fp32. Scores, probabilities and sums stay fp32.
//
// What bounds it on the H100: bytes. Each K and V row up to kv_len is read
// once and used for 2G flops an element; at G <= 8 that is far below the
// card's ridge, so the least time is the bytes of q, of the K and V rows up
// to kv_len and of the output over 3.35 TB/s (134 MB, 40 us, for Llama-3-8B
// at batch 8 and S = 4096).
//
// What this simple design does about it:
// - The TPU kernel walked the sequence in order on one core, carrying (m, l,
//   acc) across grid steps. Here the sequence is cut into splits of
//   split_len positions, one block per (split, KV head, batch row), so a
//   batch-8 Llama-3-8B cache at S = 4096 gives 1024 blocks for 132 SMs. The
//   split count is a function of S alone (decode_geometry), never of B, so a
//   row's bits do not depend on which other rows are busy.
// - A block stages its G query rows in shared memory as fp32 and keeps its
//   lane's slice of them in registers. Lanes read a cache row's hd elements
//   as 16-byte loads, `lanes` lanes a position, several positions a warp and
//   UNROLL positions a lane in flight before any is used.
// - Pass 1 writes the split's scores to shared memory; the softmax over the
//   split is then exact (no online rescaling inside a split); pass 2 reads V
//   once and sums p * v in registers, then across lane groups by shuffles
//   and across warps through shared memory, in a fixed order.
// - A block never reads past kv_len: a split's loops stop at it, and a split
//   that lies wholly past it returns at once. Such a split writes nothing,
//   and the combine pass skips it: it reads only the ceil(kv_len/split_len)
//   splits that hold a position (split 0 always runs, so a row with kv_len 0
//   gives zeros). It does NOT rely on exp(m_i - M) vanishing for an empty
//   split, where m_i would be -1e30 and l_i the count of masked positions.
// - With more than one split a second launch (combine_kernel) merges the
//   splits' (m, l, acc) in split order, one thread an output element, so
//   its loads over the splits are independent. No atomics anywhere.
// wgmma, TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;                // decode_attention.WARPS
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;               // decode_attention.UNROLL
constexpr float NEG_INF = -1e30f;       // the reference's mask value, finite

// 16 bytes of T, widened to fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float out[N]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float out[N]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  int S, KV, G, hd;
  int lanes;       // lanes a cache position: a power of two, lanes * VEC >= hd
  int ppw;         // positions a warp at once: 32 / lanes
  int step;        // positions the block covers per unrolled slot: WARPS * ppw
  int chunk;       // ... per loop step: step * UNROLL
  int split_len;   // positions a split
  int n_splits;    // ceil(S / split_len)
  float scale;     // hd^-0.5, rounded to fp32
};

__device__ __forceinline__ int valid_len(const int* kv_len, int b, int S) {
  return min(max(kv_len[b], 0), S);
}

template <typename T, int MAXG>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             float* __restrict__ out, const Args a) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = valid_len(kv_len, b, a.S);
  const int start = split * a.split_len;
  if (start >= len && split > 0) return;   // wholly past kv_len: skipped, see above
  const int n = max(0, min(a.split_len, len - start));

  const int G = a.G, hd = a.hd, SL = a.split_len;
  float* qs = smem;                                    // [G][hd]
  float* sc = qs + G * hd;                             // [G][SL] scores, then p;
                                                       // later [WARPS][G][hd] partial sums
  float* ms = sc + G * max(SL, WARPS * hd);            // [G]
  float* ls = ms + G;                                  // [G]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // The lane layout (lanes, ppw, step, chunk) comes from decode_geometry.
  const int ppw = a.ppw, step = a.step, chunk = a.chunk;
  const int grp = lane / a.lanes;          // this lane's position within a warp's ppw
  const int sub = lane % a.lanes;          // this lane's slice of hd
  const int d0 = sub * VEC;
  const bool live = d0 < hd;               // lanes past hd (hd/VEC not a power of 2) idle

  const T* qb = q + (static_cast<size_t>(b) * a.KV + h) * G * hd;
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = to_float(qb[i]);
  __syncthreads();

  float qr[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = (g < G && live) ? qs[g * hd + d0 + e] : 0.f;

  const size_t row = static_cast<size_t>(a.KV) * hd;   // elements between positions
  const size_t base_off = (static_cast<size_t>(b) * a.S + start) * row +
                          static_cast<size_t>(h) * hd + d0;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // Pass 1: scores of the split's positions.
  for (int base = 0; base < n; base += chunk) {
    float kv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * step + warp * ppw + grp;
      if (live && t < n) {
        Vec<T>::load(kb + t * row, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * step + warp * ppw + grp;
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(qr[g][e], kv[u][e], acc);
        s[g] = acc;
      }
      for (int off = a.lanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      }
      if (sub == 0 && t < n) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) sc[g * SL + t] = s[g] * a.scale;
      }
    }
  }
  __syncthreads();

  // Softmax over the split: one warp a query row.
  for (int g = warp; g < G; g += WARPS) {
    float m = NEG_INF;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[g * SL + t]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sc[g * SL + t] - m);
      sc[g * SL + t] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }
  __syncthreads();

  // Pass 2: acc[g] = sum_t p[g][t] v[t], this lane's slice of hd.
  float acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  for (int base = 0; base < n; base += chunk) {
    float vv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * step + warp * ppw + grp;
      if (live && t < n) {
        Vec<T>::load(vb + t * row, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * step + warp * ppw + grp;
      if (t < n) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float p = sc[g * SL + t];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
          }
        }
      }
    }
  }
  // across the warp's position groups (lanes a position apart)
  for (int off = a.lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  }
  __syncthreads();   // every p read: sc becomes the per-warp partial sums
  float* red = sc;   // [WARPS][G][hd]
  if (grp == 0 && live) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[(warp * G + g) * hd + d0 + e] = acc[g][e];
  }
  __syncthreads();

  const size_t head = static_cast<size_t>(b) * a.KV + h;
  for (int i = tid; i < G * hd; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w * G * hd + i];
    if (a.n_splits == 1) {
      out[head * G * hd + i] = sum / fmaxf(ls[i / hd], 1e-30f);
    } else {
      part_acc[(head * a.n_splits + split) * G * hd + i] = sum;
    }
  }
  if (a.n_splits > 1 && tid < G) {
    float* ml = part_ml + ((head * a.n_splits + split) * G + tid) * 2;
    ml[0] = ms[tid];
    ml[1] = ls[tid];
  }
}

// The second pass: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)
// over the splits i < ceil(kv_len / split_len), in split order. A block a
// (batch row, KV head, slice of THREADS output elements): one warp a query
// row finds M and the denominator over the splits (lane-strided, then a
// shuffle tree), then each thread sums its element over the splits with
// independent loads, UNROLL in flight.
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int* __restrict__ kv_len, float* __restrict__ out, const Args a) {
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
}

template <typename T, int MAXG>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* kv_len,
                         float* part_acc, float* part_ml, float* out, int B,
                         const Args& a, int smem_bytes, cudaStream_t stream) {
  const dim3 grid(a.n_splits, a.KV, B);
  split_kernel<T, MAXG><<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, part_acc, part_ml, out, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int max_g, const void* q, const void* k, const void* v,
                     const int* kv_len, float* part_acc, float* part_ml, float* out,
                     int B, const Args& a, int smem_bytes, cudaStream_t stream) {
  switch (max_g) {
    case 1: return launch_split<T, 1>(q, k, v, kv_len, part_acc, part_ml, out, B, a, smem_bytes, stream);
    case 2: return launch_split<T, 2>(q, k, v, kv_len, part_acc, part_ml, out, B, a, smem_bytes, stream);
    case 4: return launch_split<T, 4>(q, k, v, kv_len, part_acc, part_ml, out, B, a, smem_bytes, stream);
    case 8: return launch_split<T, 8>(q, k, v, kv_len, part_acc, part_ml, out, B, a, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The first pass. part_acc (B, KV, n_splits, G, hd) and part_ml (B, KV,
// n_splits, G, 2) are scratch, unused (may be null) when n_splits == 1, in
// which case out is written directly. Returns the launch's CUDA error.
int decode_attention_split(const void* q, const void* k, const void* v,
                           const void* kv_len, void* part_acc, void* part_ml,
                           void* out, int B, int S, int KV, int G, int hd,
                           int lanes, int ppw, int step, int chunk, int split_len,
                           int n_splits, float scale, int max_g, int bf16,
                           int smem_bytes, void* stream) {
  const Args a{S, KV, G, hd, lanes, ppw, step, chunk, split_len, n_splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* o = static_cast<float*>(out);
  if (bf16) return dispatch<__nv_bfloat16>(max_g, q, k, v, len, pa, pm, o, B, a, smem_bytes, s);
  return dispatch<float>(max_g, q, k, v, len, pa, pm, o, B, a, smem_bytes, s);
}

// The second pass, for n_splits > 1.
int decode_attention_combine(const void* part_acc, const void* part_ml,
                             const void* kv_len, void* out, int B, int S, int KV,
                             int G, int hd, int split_len, int n_splits,
                             void* stream) {
  const Args a{S, KV, G, hd, 0, 0, 0, 0, split_len, n_splits, 0.f};
  const dim3 grid(B * KV, (G * hd + THREADS - 1) / THREADS);
  combine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(kv_len), static_cast<float*>(out), a);
  return cudaGetLastError();
}

}  // extern "C"
