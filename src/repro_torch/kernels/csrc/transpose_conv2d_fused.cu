// Phase-fused unified transpose convolution, fp32, for sm_90a.
//
// Replaces: src/repro/kernels/transpose_conv2d.py::transpose_conv2d_pallas
// (the Pallas TPU kernel _fused_kernel).
//
// Computes out[b, 2t+pr, 2u+pc, c] = act(bias[c] + sum_{ci,p,q}
//   Ipad[b, row0(pr)+t+p, col0(pc)+u+q, ci] * S[wsel(pr,pc), p, q, ci, c])
// where Ipad is the NHWC input seen through a floor(P/2) zero border and S is
// the (4, R, R, Cin, Cout) stack of the four segregated sub-kernels, read
// straight from the HWIO kernel: S[s, p, q] = K[2p + s/2, 2q + s%2], zero
// where that tap lies outside the n x n kernel. The geometry (row0/col0
// offsets, the odd-padding sub-kernel swap wsel, tiles, launch grid, shared
// memory size) is computed in Python (transpose_conv2d.py::fused_geometry).
//
// What bounds it on the H100: the spatially large GAN layers do 2 GFLOP on
// 10 MB (~200 FLOP/byte), far above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s (~20 FLOP/byte), so the bound is fp32 arithmetic; in practice a
// simple kernel is held back by shared-memory loads per FMA.
//
// What this simple design does about it: one block per (spatial tile of the
// phase plane, cout tile, batch item). The TPU's sequential cin grid axis is
// a loop inside the block: each step stages one halo'd 16-channel input
// chunk and the matching weight chunk of all four sub-kernels in shared
// memory, and every staged input element feeds all four parities (the
// paper's point: the upsampled map is never built, and the input is read
// once for all phases). Each thread keeps 4 parities x 2 positions x 4
// channels of fp32 accumulators in registers. The sub-kernel extent R and
// the Cout tile are template parameters, so the tap and channel loops unroll
// into loads at constant offsets, weights as float4 broadcasts. The output
// is stored once after the bias and activation. Ragged edges (Cout = 3, odd
// M, Cin not a multiple of the chunk) are masked; nothing is padded up or
// cropped.
// The sum for one output runs over (cin chunk, cin, p, q) in a fixed order
// that does not depend on the batch: no split-K, no atomics.

#include <cuda_runtime.h>

namespace {

struct FusedArgs {
  int B, N, Cin, Cout, n_k, M, pad_lo;
  int base_r, base_c;
  int roff[2], coff[2];  // phase origins relative to the tile origin
  int wsel[4];           // output parity (2*pr+pc) -> stacked sub-kernel
  int th, tw, n_w;       // phase-plane tile and tiles along w
  int xh, xw;            // staged input tile
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

// CT output channels and R x R sub-kernels are compile-time, so the tap and
// cin loops unroll into shared-memory loads at constant offsets from a few
// per-thread bases, issued well ahead of the FMAs that consume them.
template <int CT, int R>
__global__ void __launch_bounds__(CT / 4 * kPositionGroups)
fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             const FusedArgs a) {
  constexpr int NCG = CT / 4;  // channel groups of four
  constexpr int NT = NCG * kPositionGroups;
  constexpr int PPT = kPositionsPerThread;
  constexpr int CI = kCinChunk;
  constexpr int SUB = R * R * CI * CT;  // one staged sub-kernel chunk
  extern __shared__ __align__(16) float smem[];
  const int xw = a.xw;
  const int xplane = a.xh * xw;
  float* xs = smem;                              // [ci][xh][xw]
  float* ws = smem + ((CI * xplane + 3) & ~3);   // [s][p][q][ci][CT]

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int t0 = (blockIdx.x / a.n_w) * a.th;
  const int u0 = (blockIdx.x % a.n_w) * a.tw;
  const int co0 = blockIdx.y * CT;
  const int b = blockIdx.z;

  int tl[PPT], ul[PPT];
  bool live[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    int pos = pg + kPositionGroups * j;
    live[j] = pos < a.th * a.tw;
    pos = live[j] ? pos : 0;
    tl[j] = pos / a.tw;
    ul[j] = pos % a.tw;
  }
  // staged-tile offset of each (parity, position) window origin, and of
  // each parity's sub-kernel for this thread's four channels
  int xoff[4][PPT];
  int woff[4];
#pragma unroll
  for (int par = 0; par < 4; ++par) {
    woff[par] = a.wsel[par] * SUB + cg * 4;
#pragma unroll
    for (int j = 0; j < PPT; ++j)
      xoff[par][j] = (tl[j] + a.roff[par >> 1]) * xw + ul[j] + a.coff[par & 1];
  }
  float acc[4][PPT][4];
#pragma unroll
  for (int par = 0; par < 4; ++par)
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[par][j][k] = 0.f;

  for (int ci0 = 0; ci0 < a.Cin; ci0 += CI) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < CI * xplane; idx += NT) {
      const int ci = idx % CI;
      const int rc = idx / CI;
      const int c = rc % xw;
      const int r = rc / xw;
      const int gr = a.base_r + t0 + r - a.pad_lo;
      const int gc = a.base_c + u0 + c - a.pad_lo;
      const int gci = ci0 + ci;
      float v = 0.f;
      if (gr >= 0 && gr < a.N && gc >= 0 && gc < a.N && gci < a.Cin)
        v = x[((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.Cin + gci];
      xs[ci * xplane + r * xw + c] = v;
    }
    for (int idx = tid; idx < 4 * SUB; idx += NT) {
      const int c = idx % CT;
      const int k = idx / CT;
      const int ci = k % CI;
      const int spq = k / CI;  // (s * R + p) * R + q
      const int q = spq % R;
      const int p = (spq / R) % R;
      const int s = spq / (R * R);
      const int kh = 2 * p + (s >> 1);
      const int kw = 2 * q + (s & 1);
      const int gci = ci0 + ci;
      const int gco = co0 + c;
      float v = 0.f;
      if (kh < a.n_k && kw < a.n_k && gci < a.Cin && gco < a.Cout)
        v = w[((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + gci) * a.Cout + gco];
      ws[idx] = v;
    }
    __syncthreads();
    // Channels past Cin were staged as zeros: they add exact zeros.
#pragma unroll 2
    for (int ci = 0; ci < CI; ++ci) {
      const float* xc = xs + ci * xplane;
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int par = 0; par < 4; ++par) {
            const float4 wv = *reinterpret_cast<const float4*>(
                ws + woff[par] + ((p * R + q) * CI + ci) * CT);
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
              const float xv = xc[xoff[par][j] + p * xw + q];
              acc[par][j][0] = fmaf(xv, wv.x, acc[par][j][0]);
              acc[par][j][1] = fmaf(xv, wv.y, acc[par][j][1]);
              acc[par][j][2] = fmaf(xv, wv.z, acc[par][j][2]);
              acc[par][j][3] = fmaf(xv, wv.w, acc[par][j][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int par = 0; par < 4; ++par) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int oh = 2 * (t0 + tl[j]) + (par >> 1);
      const int ow = 2 * (u0 + ul[j]) + (par & 1);
      if (!live[j] || oh >= a.M || ow >= a.M) continue;
      float* o = out + ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = co0 + cg * 4 + k;
        if (c < a.Cout) {
          float y = acc[par][j][k];
          if (bias != nullptr) y += bias[c];
          o[c] = activate(y, a.act, a.slope);
        }
      }
    }
  }
}

template <int CT, int R>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out,
                   const FusedArgs& a, int n_h, int n_co, int smem_bytes,
                   cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<CT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_h * a.n_w, n_co, a.B);
  fused_kernel<CT, R><<<grid, CT / 4 * kPositionGroups, smem_bytes, stream>>>(
      x, w, bias, out, a);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_r(int R, const float* x, const float* w, const float* bias,
                     float* out, const FusedArgs& a, int n_h, int n_co,
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

extern "C" int tconv_fused_f32(
    const float* x, const float* w, const float* bias, float* out,
    int B, int N, int Cin, int Cout, int n_k, int M, int R, int pad_lo,
    int base_r, int base_c, int roff0, int roff1, int coff0, int coff1,
    int wsel0, int wsel1, int wsel2, int wsel3,
    int th, int tw, int n_h, int n_w, int xh, int xw,
    int ct, int n_co, int act, float slope, int smem_bytes, void* stream) {
  FusedArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M;
  a.pad_lo = pad_lo; a.base_r = base_r; a.base_c = base_c;
  a.roff[0] = roff0; a.roff[1] = roff1; a.coff[0] = coff0; a.coff[1] = coff1;
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
