// A generator's RGB head, y = tanh(x @ W + b) over each pixel of its last
// NHWC feature map, and its gradient, fp32, for sm_90a.
//
// Replaces no TPU kernel: the reference's Table-4 generators end in their
// last transpose conv. The published EB-GAN (arXiv:1609.03126) ends in an
// RGB image made from its 64-channel 256^2 map. The head sits on the served
// path, where a request's image must not depend on the bucket it was packed
// into, and a batched cuBLAS call gives a row other bits than its one-row
// call. So each output here is one fmaf chain in a fixed order, with tiles
// fixed at compile time: the batch sets only the grid.
//
//   rgb_head_kernel:     y[p, c]  = tanh(sum_k x[p, k] W[k, c] + b[c])   (k ascending)
//   rgb_head_dx_kernel:  dx[p, k] = sum_c gm[p, c] W[k, c]               (c ascending)
//   rgb_head_dw_kernel:  part[blk, k C + c] = sum_p x[p, k] gm[p, c], part[blk, K C + c]
//                        = sum_p gm[p, c], over the block's pixels in ascending order
//   rgb_head_sum_kernel: dW and db, the blocks' partials summed in block order
// with gm = g * (1 - y^2): tanh's derivative from the saved output, applied
// as g is read, never stored.
//
// What bounds it on the H100: bytes. EB-GAN at batch 64 reads 64 channels
// of 256^2 pixels a sample, 1.07 GB (0.32 ms at 3.35 TB/s), for 6 FLOPs a
// channel; dx writes as many bytes as the forward reads, dW reads them again.
//
// The design:
// - A block owns 128 pixels, one a thread. Their K channels are staged in
//   shared memory, padded to K + 1 floats a pixel, so that each thread
//   walking its own pixel's channels reads a bank of its own. The tile is
//   128 K contiguous floats of x: where K is a multiple of 4 and x is 16-byte
//   aligned (the wrapper says which) each thread copies it by 16-byte loads
//   in tile order, all of its share in flight at once (16 at K = 64); else a
//   warp copies whole rows by 4-byte loads (KW, the words a lane copies of a
//   row, ceil(K / 32), a template argument). The first build copied rows by
//   4-byte loads alone: the forward ran at 27% of its bound and dW's
//   partials at 19%, while dx, whose tile goes the other way as stores,
//   reached 80% (PERF.md). W (and b) sit in shared memory as [k][4], read by
//   broadcast.
// - dx is computed into the same padded tile and written by whole rows.
// - dW: each block sums a fixed run of 128-pixel tiles (the wrapper sets the
//   run from the pixel count alone); thread k owns row k of dW (C sums),
//   thread K the bias sums. A second pass adds the blocks' partials in block
//   order. No atomics: the sums' order is fixed.

#include <cuda_runtime.h>

namespace {

constexpr int PT = 128;            // pixels a block, one a thread
constexpr int NT = PT;             // threads a block
constexpr int WARPS = NT / 32;
constexpr int MAX_K = 64;          // input channels (K + 1 threads own dW rows and db)
constexpr int MAX_C = 4;           // output channels
constexpr int SUM_NT = 64;         // threads a block of the partials' sum

// Stage x[p0 : p0 + PT, 0 : K] into xs[PT][K + 1]; pixels past P and
// channels past K read zero. `vec`: K % 4 == 0 and x 16-byte aligned.
template <int KW>
__device__ __forceinline__ void stage_rows(float* xs, const float* __restrict__ x,
                                           long long p0, long long P, int K, bool vec) {
  if (vec) {
    const int kq = K >> 2;
    const int rows = static_cast<int>(min(static_cast<long long>(PT), P - p0));
    const float4* src = reinterpret_cast<const float4*>(x + p0 * K);
#pragma unroll 16
    for (int e = threadIdx.x; e < PT * kq; e += NT) {
      const int r = e / kq, q = e - r * kq;
      const float4 v = r < rows ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      float* d = xs + r * (K + 1) + 4 * q;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 8
  for (int r = warp; r < PT; r += WARPS) {
    const long long p = p0 + r;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int k = lane + 32 * j;
      if (k < K) xs[r * (K + 1) + k] = p < P ? __ldg(x + p * K + k) : 0.f;
    }
  }
}

// ws[k][c] = W[k, c] (K x C row-major), zeros past C.
__device__ __forceinline__ void stage_w(float (*ws)[MAX_C], const float* __restrict__ w,
                                        int K, int C) {
  for (int i = threadIdx.x; i < K * MAX_C; i += NT) {
    const int k = i / MAX_C, c = i % MAX_C;
    ws[k][c] = c < C ? w[k * C + c] : 0.f;
  }
}

// gm of one pixel: g * (1 - y^2) a channel, zeros past C and past P.
__device__ __forceinline__ void tanh_grad(float* gm, const float* __restrict__ g,
                                          const float* __restrict__ y, long long p,
                                          long long P, int C) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    float v = 0.f;
    if (c < C && p < P) {
      const float yc = y[p * C + c];
      v = g[p * C + c] * (1.f - yc * yc);
    }
    gm[c] = v;
  }
}

template <int KW>
__global__ void __launch_bounds__(NT) rgb_head_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ y, long long P, int K, int C, int vec) {
  extern __shared__ float xs[];                  // [PT][K + 1]
  __shared__ float ws[MAX_K][MAX_C];
  const long long p0 = static_cast<long long>(blockIdx.x) * PT;
  stage_w(ws, w, K, C);
  stage_rows<KW>(xs, x, p0, P, K, vec);
  __syncthreads();
  const float* row = xs + threadIdx.x * (K + 1);
  float acc[MAX_C] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float v = row[k];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) acc[c] = fmaf(v, ws[k][c], acc[c]);
  }
  const long long p = p0 + threadIdx.x;
  if (p >= P) return;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < C) y[p * C + c] = tanhf(acc[c] + b[c]);
}

template <int KW>
__global__ void __launch_bounds__(NT) rgb_head_dx_kernel(
    const float* __restrict__ g, const float* __restrict__ y, const float* __restrict__ w,
    float* __restrict__ dx, long long P, int K, int C) {
  extern __shared__ float ds[];                  // [PT][K + 1]
  __shared__ float ws[MAX_K][MAX_C];
  const long long p0 = static_cast<long long>(blockIdx.x) * PT;
  stage_w(ws, w, K, C);
  float gm[MAX_C];
  tanh_grad(gm, g, y, p0 + threadIdx.x, P, C);
  __syncthreads();
  float* row = ds + threadIdx.x * (K + 1);
  for (int k = 0; k < K; ++k) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) d = fmaf(gm[c], ws[k][c], d);
    row[k] = d;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 8
  for (int r = warp; r < PT; r += WARPS) {
    const long long p = p0 + r;
    if (p >= P) break;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int k = lane + 32 * j;
      if (k < K) dx[p * K + k] = ds[r * (K + 1) + k];
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(NT) rgb_head_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ y,
    float* __restrict__ part, long long P, int K, int C, int tiles, int vec) {
  extern __shared__ float xs[];                  // [PT][K + 1]
  __shared__ float gs[PT][MAX_C];
  const int t = threadIdx.x;
  float acc[MAX_C] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const long long p0 = (static_cast<long long>(blockIdx.x) * tiles + i) * PT;
    if (p0 >= P) break;                          // the same for the whole block
    stage_rows<KW>(xs, x, p0, P, K, vec);
    tanh_grad(gs[t], g, y, p0 + t, P, C);
    __syncthreads();
    if (t < K) {
      for (int r = 0; r < PT; ++r) {
        const float v = xs[r * (K + 1) + t];
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) acc[c] = fmaf(v, gs[r][c], acc[c]);
      }
    } else if (t == K) {
      for (int r = 0; r < PT; ++r) {
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) acc[c] += gs[r][c];
      }
    }
    __syncthreads();
  }
  const int n = K * C + C;
  float* out = part + static_cast<long long>(blockIdx.x) * n;
  if (t <= K) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < C) out[t * C + c] = acc[c];
  }
}

__global__ void __launch_bounds__(SUM_NT) rgb_head_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
    int blocks, int K, int C) {
  const int n = K * C + C;
  const int o = blockIdx.x * SUM_NT + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i) s += part[static_cast<long long>(i) * n + o];
  if (o < K * C) dw[o] = s;
  else db[o - K * C] = s;
}

bool valid_shape(long long P, int K, int C) {
  return P >= 1 && K >= 1 && K <= MAX_K && C >= 1 && C <= MAX_C;
}

int tile_smem(int K) { return PT * (K + 1) * static_cast<int>(sizeof(float)); }

}  // namespace

// Each launcher takes the pixel tile the Python wrapper computed its grid
// from, and returns cudaErrorInvalidValue where it is not the one compiled
// here (or a shape is out of range), else the launch's error.
extern "C" int rgb_head_f32(const float* x, const float* w, const float* b, float* y,
                            long long P, int K, int C, int pt, int vec, void* stream) {
  if (pt != PT || !valid_shape(P, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((P + PT - 1) / PT);
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 32)
    rgb_head_kernel<1><<<grid, NT, tile_smem(K), s>>>(x, w, b, y, P, K, C, vec);
  else
    rgb_head_kernel<2><<<grid, NT, tile_smem(K), s>>>(x, w, b, y, P, K, C, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rgb_head_dx_f32(const float* g, const float* y, const float* w, float* dx,
                               long long P, int K, int C, int pt, void* stream) {
  if (pt != PT || !valid_shape(P, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((P + PT - 1) / PT);
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 32)
    rgb_head_dx_kernel<1><<<grid, NT, tile_smem(K), s>>>(g, y, w, dx, P, K, C);
  else
    rgb_head_dx_kernel<2><<<grid, NT, tile_smem(K), s>>>(g, y, w, dx, P, K, C);
  return static_cast<int>(cudaGetLastError());
}

// The partials' pass on `blocks` blocks of `tiles` tiles each, then their
// sum into dw (K x C) and db (C).
extern "C" int rgb_head_dw_f32(const float* x, const float* g, const float* y,
                               float* part, float* dw, float* db, long long P, int K, int C,
                               int pt, int blocks, int tiles, int vec, void* stream) {
  if (pt != PT || !valid_shape(P, K, C) || blocks < 1 || tiles < 1 ||
      static_cast<long long>(blocks) * tiles * PT < P)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 32)
    rgb_head_dw_kernel<1><<<blocks, NT, tile_smem(K), s>>>(x, g, y, part, P, K, C, tiles, vec);
  else
    rgb_head_dw_kernel<2><<<blocks, NT, tile_smem(K), s>>>(x, g, y, part, P, K, C, tiles, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * C + C;
  rgb_head_sum_kernel<<<(n + SUM_NT - 1) / SUM_NT, SUM_NT, 0, s>>>(part, dw, db, blocks, K, C);
  return static_cast<int>(cudaGetLastError());
}
