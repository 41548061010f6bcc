// Per-phase unified transpose convolution, fp32, for sm_90a.
//
// Replaces: src/repro/kernels/transpose_conv2d.py::transpose_conv2d_pallas_phase
// (the Pallas TPU kernel _phase_kernel, grid (batch, phase, cout, cin)).
//
// Computes the same function as transpose_conv2d_fused.cu, one output parity
// per block:
//   out[b, 2t+pr, 2u+pc, c] = act(bias[c] + sum_{ci,p,q}
//       Ipad[b, row0(pr)+t+p, col0(pc)+u+q, ci] * S[wsel(pr,pc), p, q, ci, c])
// with Ipad the NHWC input seen through a floor(P/2) zero border and S the
// segregated sub-kernel stack read straight from the HWIO kernel
// (S[s, p, q] = K[2p + s/2, 2q + s%2], zero past the n x n kernel). The
// geometry (phase origins, the odd-padding sub-kernel swap, tiles, grid,
// shared memory) is computed in Python (transpose_conv2d.py::phase_geometry).
//
// What bounds it on the H100: fp32 arithmetic, as for the fused kernel (the
// same operations on the same bytes; ~200 FLOP/byte at the DCGAN layers
// against a ridge of ~20).
//
// The design is the per-phase form the paper's unified kernel is measured
// against: one block per (output parity, phase-plane tile, Cout tile, batch
// item). The TPU's sequential cin grid axis is a loop inside the block; each
// step stages the block's own halo'd 16-channel input window and its one
// sub-kernel's weights in shared memory. Unlike the fused kernel, no staged
// tile is shared across parities: the four parities of one output tile stage
// four overlapping windows. Each thread keeps 2 positions x 4 channels of
// fp32 accumulators; bias and activation are applied on them before the
// single store. Ragged edges (Cout not a tile multiple, odd M, Cin not a
// multiple of the chunk) are masked. Each output's sum runs over (cin chunk,
// cin, p, q) in a fixed order that does not depend on the batch.

#include <cuda_runtime.h>

namespace {

struct PhaseArgs {
  int B, N, Cin, Cout, n_k, M, pad_lo;
  int row0[2], col0[2];  // padded-input origin of each row / column parity
  int wsel[4];           // output parity (2*pr+pc) -> stacked sub-kernel
  int th, tw, n_w;       // phase-plane tile and tiles along w
  int xh, xw;            // staged input window th + R - 1, tw + R - 1
  int act;
  float slope;
};

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case 1: return y > 0.f ? y : 0.f;
    case 2: return tanhf(y);
    case 3: return y > 0.f ? y : slope * y;
    default: return y;
  }
}

constexpr int kPositionsPerThread = 2;
constexpr int kPositionGroups = 32;
constexpr int kCinChunk = 16;

template <int CT, int R>
__global__ void __launch_bounds__(CT / 4 * kPositionGroups)
phase_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             const PhaseArgs a) {
  constexpr int NCG = CT / 4;
  constexpr int NT = NCG * kPositionGroups;
  constexpr int PPT = kPositionsPerThread;
  constexpr int CI = kCinChunk;
  constexpr int SUB = R * R * CI * CT;  // the staged chunk of one sub-kernel
  extern __shared__ __align__(16) float smem[];
  const int xw = a.xw;
  const int xplane = a.xh * xw;
  float* xs = smem;                              // [ci][xh][xw]
  float* ws = smem + ((CI * xplane + 3) & ~3);   // [p][q][ci][CT]

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int t0 = (blockIdx.x / a.n_w) * a.th;
  const int u0 = (blockIdx.x % a.n_w) * a.tw;
  const int co0 = blockIdx.y * CT;
  const int b = blockIdx.z >> 2;
  const int par = blockIdx.z & 3;
  const int pr = par >> 1;
  const int pc = par & 1;
  const int s = a.wsel[par];
  // global input row / column of the staged window's origin
  const int gr0 = a.row0[pr] + t0 - a.pad_lo;
  const int gc0 = a.col0[pc] + u0 - a.pad_lo;

  int tl[PPT], ul[PPT], xoff[PPT];
  bool live[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    int pos = pg + kPositionGroups * j;
    live[j] = pos < a.th * a.tw;
    pos = live[j] ? pos : 0;
    tl[j] = pos / a.tw;
    ul[j] = pos % a.tw;
    xoff[j] = tl[j] * xw + ul[j];
  }
  float acc[PPT][4];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int ci0 = 0; ci0 < a.Cin; ci0 += CI) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < CI * xplane; idx += NT) {
      const int ci = idx % CI;
      const int rc = idx / CI;
      const int c = rc % xw;
      const int r = rc / xw;
      const int gr = gr0 + r;
      const int gc = gc0 + c;
      const int gci = ci0 + ci;
      float v = 0.f;
      if (gr >= 0 && gr < a.N && gc >= 0 && gc < a.N && gci < a.Cin)
        v = x[((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.Cin + gci];
      xs[ci * xplane + r * xw + c] = v;
    }
    for (int idx = tid; idx < SUB; idx += NT) {
      const int c = idx % CT;
      const int k = idx / CT;
      const int ci = k % CI;
      const int pq = k / CI;  // p * R + q
      const int kh = 2 * (pq / R) + (s >> 1);
      const int kw = 2 * (pq % R) + (s & 1);
      const int gci = ci0 + ci;
      const int gco = co0 + c;
      float v = 0.f;
      if (kh < a.n_k && kw < a.n_k && gci < a.Cin && gco < a.Cout)
        v = w[((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + gci) * a.Cout + gco];
      ws[idx] = v;
    }
    __syncthreads();
    // Channels past Cin were staged as zeros: they add exact zeros.
#pragma unroll 4
    for (int ci = 0; ci < CI; ++ci) {
      const float* xc = xs + ci * xplane;
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + ((p * R + q) * CI + ci) * CT + cg * 4);
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const float xv = xc[xoff[j] + p * xw + q];
            acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int oh = 2 * (t0 + tl[j]) + pr;
    const int ow = 2 * (u0 + ul[j]) + pc;
    if (!live[j] || oh >= a.M || ow >= a.M) continue;
    float* o = out + ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = co0 + cg * 4 + k;
      if (c < a.Cout) {
        float y = acc[j][k];
        if (bias != nullptr) y += bias[c];
        o[c] = activate(y, a.act, a.slope);
      }
    }
  }
}

template <int CT, int R>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out,
                   const PhaseArgs& a, int n_h, int n_co, int smem_bytes,
                   cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        phase_kernel<CT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_h * a.n_w, n_co, 4 * a.B);
  phase_kernel<CT, R><<<grid, CT / 4 * kPositionGroups, smem_bytes, stream>>>(
      x, w, bias, out, a);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_r(int R, const float* x, const float* w, const float* bias,
                     float* out, const PhaseArgs& a, int n_h, int n_co,
                     int smem_bytes, cudaStream_t stream) {
  switch (R) {
    case 1: return launch<CT, 1>(x, w, bias, out, a, n_h, n_co, smem_bytes, stream);
    case 2: return launch<CT, 2>(x, w, bias, out, a, n_h, n_co, smem_bytes, stream);
    case 3: return launch<CT, 3>(x, w, bias, out, a, n_h, n_co, smem_bytes, stream);
    case 4: return launch<CT, 4>(x, w, bias, out, a, n_h, n_co, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tconv_phase_f32(
    const float* x, const float* w, const float* bias, float* out,
    int B, int N, int Cin, int Cout, int n_k, int M, int R, int pad_lo,
    int row00, int row01, int col00, int col01,
    int wsel0, int wsel1, int wsel2, int wsel3,
    int th, int tw, int n_h, int n_w, int xh, int xw,
    int ct, int n_co, int act, float slope, int smem_bytes, void* stream) {
  PhaseArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M;
  a.pad_lo = pad_lo;
  a.row0[0] = row00; a.row0[1] = row01; a.col0[0] = col00; a.col0[1] = col01;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.th = th; a.tw = tw; a.n_w = n_w; a.xh = xh; a.xw = xw;
  a.act = act; a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (ct) {
    case 4: e = launch_r<4>(R, x, w, bias, out, a, n_h, n_co, smem_bytes, s); break;
    case 8: e = launch_r<8>(R, x, w, bias, out, a, n_h, n_co, smem_bytes, s); break;
    case 16: e = launch_r<16>(R, x, w, bias, out, a, n_h, n_co, smem_bytes, s); break;
    case 32: e = launch_r<32>(R, x, w, bias, out, a, n_h, n_co, smem_bytes, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
