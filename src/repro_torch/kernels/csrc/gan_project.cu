// The GAN generators' latent projection, y = relu(z @ W), and its gradient,
// fp32, for sm_90a.
//
// Replaces no TPU kernel: the reference computes the projection with jnp ops
// (src/repro/models/gan.py::generator_apply), left to XLA. A served image
// must not depend on its bucket, and a batched cuBLAS call gives a row other
// bits than its one-row call; one cuBLAS call a row costs a launch a row.
// These kernels are batch-invariant by construction, so one launch serves
// the whole batch.
//
//   project_relu_kernel: y[b, j] = relu(sum_k z[b, k] * W[k, j])
//   project_dw_kernel:   dW[k, j] = sum_b z[b, k] * gm[b, j]
//   project_dz_kernel:   dz[b, k] = sum_j gm[b, j] * W[k, j]
// with gm = g * [y > 0] (y <= 0 ? 0 : g, as PyTorch's threshold_backward):
// relu's derivative applied as g is read, never stored.
//
// What bounds it on the H100: DCGAN's W is 100 x 16384 (6.55 MB). At batch
// 128 a forward does 0.42 GFLOP on 6.55 MB of W and 8.4 MB of y: fp32 FMAs
// bound it (6.3 us at 67 TFLOP/s). At batch 1 it reads W once to do one FMA
// with each element: bytes bound it (2 us at 3.35 TB/s).
//
// The design:
// - One thread owns each output it computes and sums it in one fmaf chain:
//   k ascending in the forward, b ascending in dW, j ascending in dz. No
//   contraction is split, and no tile size reads the batch: the grid's row
//   count is the only thing the batch sets. So each output's bits are the
//   same whatever the batch, and no atomics or workspace are needed.
// - Staging. A chain of 100 steps whose operands come straight from global
//   memory is bound by its loads' latency, a few in flight a warp at a
//   time (PERF.md's kernel table). So the forward and dW stream their
//   operands through a 4-stage cp.async ring in shared memory: a stage is a
//   chunk of the contraction, and three chunks are in flight while one is
//   summed (DCGAN's K = 100 is 7 chunks of 16). 16-byte copies where N is a
//   multiple of 4 and the operands are 16-byte aligned (the wrapper says
//   which), else 4-byte ones; rows, columns and steps past the operands are
//   zero-filled. The copy width never changes an output's sum.
// - Forward: a block owns 32 rows x 128 columns; a thread 8 rows x 4
//   adjacent columns, 32 FMAs for each W float4 and two z float4s it reads
//   from shared memory (z broadcast across the warp). A stage holds W[k0 :
//   k0 + 16, the block's columns] and z[the block's rows, k0 : k0 + 16] as
//   [k][row]. W's re-reads by the other row blocks come from L2. A warp
//   whose rows all lie past the batch copies but skips its FMAs (a
//   warp-uniform test). Relu is applied to the accumulator and y is written
//   once, already in the first layer's NHWC order.
// - dW: a block owns 32 rows of W x 128 columns; a thread 8 rows x 4
//   columns. A stage holds y and g for 8 samples x the block's columns and
//   z[those samples, the block's rows] as [b][k]; relu's mask is applied as
//   g is read from the stage. dW is written once.
// - dz (only where z needs a gradient; no benchmark cell asks for it): a
//   block owns 16 samples x 16 rows of W, one output a thread; gm and W
//   are staged 32 columns at a time by plain loads.

#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace {

using tconv::cp_async4;
using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;

constexpr int TR = 8;              // rows a thread (of y in the forward, of dW in dW)
constexpr int TC = 4;              // adjacent columns a thread
constexpr int NCG = 32;            // column groups a block: one warp across
constexpr int BC = TC * NCG;       // 128 columns a block
constexpr int WARPS = 4;
constexpr int NT = NCG * WARPS;    // 128 threads (forward and dW)
constexpr int BR = TR * WARPS;     // 32 rows a block (of y, or of dW)
constexpr int STAGES = 4;          // depth of the cp.async ring
constexpr int KC = 16;             // forward: contraction steps a stage
constexpr int BCH = 8;             // dW: samples a stage
constexpr int DZ_T = 16;           // dz: samples and rows of W a block
constexpr int DZ_NT = DZ_T * DZ_T;        // 256 threads
constexpr int JC = 32;             // dz: columns staged at once

__device__ __forceinline__ float relu_mask(float y, float g) {
  return y <= 0.f ? 0.f : g;
}

// Stage the rows [q0, q0 + nq) of a row-major (rows, N) operand, its
// columns [c0, c0 + BC), into dst[nq][BC]; rows at or past `rows` become
// zeros. Each thread copies quads (tid + i NT).
template <int NQ>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int q0, int rows,
                                           int c0, int N, bool vec) {
  constexpr int QUADS = NQ * BC / 4;
  static_assert(QUADS % NT == 0, "whole quads a thread");
#pragma unroll
  for (int i = 0; i < QUADS / NT; ++i) {
    const int q = threadIdx.x + i * NT;
    const int row = q / (BC / 4), col = c0 + (q % (BC / 4)) * 4;
    const bool in = q0 + row < rows;
    cp_quad(dst + row * BC + (q % (BC / 4)) * 4,
            src + static_cast<long long>(in ? q0 + row : 0) * N + col, src,
            in ? N - col : 0, vec);
  }
}

// Stage z[b0 : b0 + NB, k0 : k0 + NK] (B x K, row-major) into dst[NB][NK]
// (KT false) or dst[NK][NB] (KT true), zeros past B and K, by 4-byte
// copies (z's rows are K floats apart, not 16-byte aligned in general).
template <int NB, int NK, bool KT>
__device__ __forceinline__ void stage_z(float* dst, const float* z, int b0, int k0, int B,
                                        int K) {
  static_assert((NB * NK) % NT == 0, "whole elements a thread");
#pragma unroll
  for (int i = 0; i < NB * NK / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int b = KT ? e % NB : e / NK, k = KT ? e / NB : e % NK;
    const bool in = b0 + b < B && k0 + k < K;
    cp_async4(dst + e, in ? z + static_cast<long long>(b0 + b) * K + k0 + k : z, in);
  }
}

__global__ void __launch_bounds__(NT) project_relu_kernel(
    const float* __restrict__ z, const float* __restrict__ w, float* __restrict__ y,
    int B, int K, int N, int vec) {
  __shared__ __align__(16) float ws[STAGES][KC][BC];   // W[k0 + k, c0 + c]
  __shared__ __align__(16) float zs[STAGES][KC][BR];   // z[r0 + r, k0 + k]
  const int cg = threadIdx.x % NCG, warp = threadIdx.x / NCG;
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * BC, j0 = c0 + cg * TC;
  const int rt = r0 + warp * TR;                   // the thread's first row
  const bool live = rt < B;                        // warp-uniform
  const int chunks = (K + KC - 1) / KC;
  auto stage = [&](int c) {
    const int s = c % STAGES;
    stage_rows<KC>(&ws[s][0][0], w, c * KC, K, c0, N, vec);
    stage_z<BR, KC, true>(&zs[s][0][0], z, r0, c * KC, B, K);
  };
  float acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c landed; every thread is done with chunk c - 1's stage
    if (c + STAGES - 1 < chunks) stage(c + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const int s = c % STAGES, kn = min(KC, K - c * KC);
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[s][k][cg * TC]);
      const float4 za = *reinterpret_cast<const float4*>(&zs[s][k][warp * TR]);
      const float4 zb = *reinterpret_cast<const float4*>(&zs[s][k][warp * TR + 4]);
      const float zr[TR] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float wc[TC] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = fmaf(zr[r], wc[cc], acc[r][cc]);
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  const bool wide = vec && j0 + TC <= N;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    if (rt + r >= B) break;
    float o[TC];
#pragma unroll
    for (int cc = 0; cc < TC; ++cc) o[cc] = acc[r][cc] < 0.f ? 0.f : acc[r][cc];  // NaN stays
    float* yr = y + static_cast<long long>(rt + r) * N + j0;
    if (wide) {
      *reinterpret_cast<float4*>(yr) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int cc = 0; cc < TC; ++cc)
        if (j0 + cc < N) yr[cc] = o[cc];
    }
  }
}

__global__ void __launch_bounds__(NT) project_dw_kernel(
    const float* __restrict__ z, const float* __restrict__ y, const float* __restrict__ g,
    float* __restrict__ dw, int B, int K, int N, int vec) {
  __shared__ __align__(16) float ys[STAGES][BCH][BC];   // y[b0 + b, c0 + c]
  __shared__ __align__(16) float gs[STAGES][BCH][BC];   // g[b0 + b, c0 + c]
  __shared__ __align__(16) float zs[STAGES][BCH][BR];   // z[b0 + b, k0 + k]
  const int cg = threadIdx.x % NCG, warp = threadIdx.x / NCG;
  const int k0 = blockIdx.y * BR, c0 = blockIdx.x * BC, j0 = c0 + cg * TC;
  const int kt = k0 + warp * TR;                   // the thread's first row of dW
  const bool live = kt < K;                        // warp-uniform
  const int chunks = (B + BCH - 1) / BCH;
  auto stage = [&](int c) {
    const int s = c % STAGES;
    stage_rows<BCH>(&ys[s][0][0], y, c * BCH, B, c0, N, vec);
    stage_rows<BCH>(&gs[s][0][0], g, c * BCH, B, c0, N, vec);
    stage_z<BCH, BR, false>(&zs[s][0][0], z, c * BCH, k0, B, K);
  };
  float acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < chunks) stage(c + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const int s = c % STAGES, bn = min(BCH, B - c * BCH);
#pragma unroll 4
    for (int b = 0; b < bn; ++b) {
      const float4 yv = *reinterpret_cast<const float4*>(&ys[s][b][cg * TC]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[s][b][cg * TC]);
      const float4 za = *reinterpret_cast<const float4*>(&zs[s][b][warp * TR]);
      const float4 zb = *reinterpret_cast<const float4*>(&zs[s][b][warp * TR + 4]);
      const float zr[TR] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float gm[TC] = {relu_mask(yv.x, gv.x), relu_mask(yv.y, gv.y),
                            relu_mask(yv.z, gv.z), relu_mask(yv.w, gv.w)};
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = fmaf(zr[r], gm[cc], acc[r][cc]);
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  const bool wide = vec && j0 + TC <= N;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    if (kt + r >= K) break;
    float* dr = dw + static_cast<long long>(kt + r) * N + j0;
    if (wide) {
      *reinterpret_cast<float4*>(dr) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int cc = 0; cc < TC; ++cc)
        if (j0 + cc < N) dr[cc] = acc[r][cc];
    }
  }
}

__global__ void __launch_bounds__(DZ_NT) project_dz_kernel(
    const float* __restrict__ w, const float* __restrict__ y, const float* __restrict__ g,
    float* __restrict__ dz, int B, int K, int N) {
  __shared__ float gs[DZ_T][JC + 1];   // gs[b][j] = gm[b0 + b, j0 + j]
  __shared__ float ws[DZ_T][JC + 1];   // ws[k][j] = W[k0 + k, j0 + j]
  const int kl = threadIdx.x % DZ_T, bl = threadIdx.x / DZ_T;
  const int b0 = blockIdx.y * DZ_T, k0 = blockIdx.x * DZ_T;
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += JC) {
    for (int i = threadIdx.x; i < DZ_T * JC; i += DZ_NT) {
      const int r = i / JC, j = i % JC, jj = j0 + j;
      const int b = b0 + r, k = k0 + r;
      const long long gi = static_cast<long long>(b) * N + jj;
      gs[r][j] = (b < B && jj < N) ? relu_mask(y[gi], g[gi]) : 0.f;
      ws[r][j] = (k < K && jj < N) ? w[static_cast<long long>(k) * N + jj] : 0.f;
    }
    __syncthreads();
    const int jn = min(JC, N - j0);
    for (int j = 0; j < jn; ++j) acc = fmaf(gs[bl][j], ws[kl][j], acc);
    __syncthreads();
  }
  if (b0 + bl < B && k0 + kl < K) dz[static_cast<long long>(b0 + bl) * K + k0 + kl] = acc;
}

bool valid_shape(int B, int K, int N) { return B >= 1 && K >= 1 && N >= 1; }

}  // namespace

// Each launcher takes the tile sizes the Python wrapper computed its grid
// from, and returns cudaErrorInvalidValue where they are not the ones
// compiled here, else the launch's error.
extern "C" int project_relu_f32(const float* z, const float* w, float* y, int B, int K,
                                int N, int br, int bc, int vec, void* stream) {
  if (br != BR || bc != BC || !valid_shape(B, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BC - 1) / BC, (B + BR - 1) / BR);
  project_relu_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      z, w, y, B, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int project_dw_f32(const float* z, const float* y, const float* g, float* dw,
                              int B, int K, int N, int bk, int bc, int vec, void* stream) {
  if (bk != BR || bc != BC || !valid_shape(B, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BC - 1) / BC, (K + BR - 1) / BR);
  project_dw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      z, y, g, dw, B, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int project_dz_f32(const float* w, const float* y, const float* g, float* dz,
                              int B, int K, int N, int bt, void* stream) {
  if (bt != DZ_T || !valid_shape(B, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + DZ_T - 1) / DZ_T, (B + DZ_T - 1) / DZ_T);
  project_dz_kernel<<<grid, DZ_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      w, y, g, dz, B, K, N);
  return static_cast<int>(cudaGetLastError());
}
