// Implicit-GEMM transpose convolution, fp32, for sm_90a.
//
// Replaces: src/repro/kernels/transpose_conv2d_gemm.py::transpose_conv2d_pallas_gemm
// (the Pallas TPU kernel _gemm_kernel).
//
// Computes the whole layer as one GEMM
//   out[row, co] = act(bias[co] + sum_{kh, kw, ci} A[row, (kh, kw, ci)] * K[kh, kw, ci, co])
// whose A operand is never built: tap (kh, kw) of output (oh, ow) reads
// input ((oh + kh - P) / 2, (ow + kw - P) / 2) iff both numerators are even,
// non-negative and in range, else zero. Batch folds into the rows.
//
// What bounds it on the H100: the channel-deep 4x4 head layer it serves
// (DCGAN L0 at batch 8: 2.15 GFLOP of segregated work on 35 MB, 33.5 MB of
// it weights) is bound by fp32 arithmetic (~32 us at 67 TFLOP/s) over the
// weight stream (~10.5 us at 3.35 TB/s). Taken densely, the GEMM does 4x
// the segregated MACs: three taps in four read the parity zeros.
//
// What this simple design does about it: a tiled SGEMM, 32 rows x 64 cout a
// block, K in chunks of 16 input channels within one tap, 4 x 4 fp32
// accumulators a thread fed by float4 shared-memory loads; the next chunk's
// global loads are issued into registers before the current chunk's FMAs.
// The A tile is gathered by address with the predicate above, each row's
// source pixel resolved once per tap: the TPU kernel's one-hot gather
// matmul is gone. GEMM rows are ordered phase-major -- (output parity,
// batch, t, u) -- so the rows of a block share one or two output parities,
// and a tap that no row of the block reads is skipped whole: at the head
// layer a block then runs 4 (one parity) or 8 (two) of the 16 taps, instead
// of all 16. Skipped taps would only have added exact zeros, so each
// output's sum, taken over (tap, cin) in a fixed order with no split-K and
// no atomics, does not depend on the batch or the bucket.

#include <cuda_runtime.h>

namespace {

struct GemmArgs {
  int B, N, Cin, Cout, n_k, P, M, Hp;
  int act;
  float slope;
};

constexpr int BM = 32;   // GEMM rows a block
constexpr int BN = 64;   // output channels a block
constexpr int BK = 16;   // input channels a K step
constexpr int NT = 128;  // threads: 8 row groups x 16 channel groups, 4 x 4 each

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case 1: return y > 0.f ? y : 0.f;
    case 2: return tanhf(y);
    case 3: return y > 0.f ? y : slope * y;
    default: return y;
  }
}

// Flat input pixel (ih * N + iw) that tap (kh, kw) of output (oh, ow)
// reads, or -1 when it reads a zero of the upsampled map.
__device__ __forceinline__ int tap_source(int oh, int ow, int kh, int kw,
                                          const GemmArgs& a) {
  const int ar = oh + kh - a.P;
  const int ac = ow + kw - a.P;
  if (ar < 0 || ac < 0 || (ar & 1) || (ac & 1)) return -1;
  const int ih = ar >> 1;
  const int iw = ac >> 1;
  if (ih >= a.N || iw >= a.N) return -1;
  return ih * a.N + iw;
}

__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            const GemmArgs a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int rb[BM];   // batch item of each row, -1 for a row past the output
  __shared__ int roh[BM];
  __shared__ int row_[BM];
  __shared__ long long rsrc[BM];  // this tap's input pixel offset, -1: a zero

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  if (tid < BM) {
    const int r = m0 + tid;
    const int plane = a.Hp * a.Hp;
    const int per_phase = a.B * plane;
    const int ph = r / per_phase;
    const int rem = r % per_phase;
    const int tu = rem % plane;
    const int oh = 2 * (tu / a.Hp) + (ph >> 1);
    const int ow = 2 * (tu % a.Hp) + (ph & 1);
    const bool ok = ph < 4 && oh < a.M && ow < a.M;
    rb[tid] = ok ? rem / plane : -1;
    roh[tid] = oh;
    row_[tid] = ow;
  }
  __syncthreads();

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  constexpr int A_PER = BM * BK / NT;  // A elements a thread stages
  constexpr int B_PER = BK * BN / NT;
  float ra[A_PER], rw[B_PER];          // the next K step, held in registers
  const int taps = a.n_k * a.n_k;
  for (int tap = 0; tap < taps; ++tap) {
    const int kh = tap / a.n_k;
    const int kw = tap % a.n_k;
    int reads = 0;
    if (tid < BM) {
      long long src = -1;
      if (rb[tid] >= 0) {
        const int pix = tap_source(roh[tid], row_[tid], kh, kw, a);
        if (pix >= 0)
          src = (static_cast<long long>(rb[tid]) * a.N * a.N + pix) * a.Cin;
      }
      rsrc[tid] = src;
      reads = src >= 0;
    }
    if (!__syncthreads_or(reads)) continue;  // uniform over the block

    const float* wt = w + static_cast<long long>(tap) * a.Cin * a.Cout;
    auto fetch = [&](int ci0) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * NT;
        const long long src = rsrc[idx / BK];
        const int ci = ci0 + idx % BK;
        ra[i] = (src >= 0 && ci < a.Cin) ? x[src + ci] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * NT;
        const int ci = ci0 + idx / BN;
        const int co = co0 + idx % BN;
        rw[i] = (ci < a.Cin && co < a.Cout)
                    ? wt[static_cast<long long>(ci) * a.Cout + co] : 0.f;
      }
    };
    fetch(0);
    for (int ci0 = 0; ci0 < a.Cin; ci0 += BK) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * NT;
        As[idx % BK][idx / BK] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * NT;
        Bs[idx / BN][idx % BN] = rw[i];
      }
      __syncthreads();
      if (ci0 + BK < a.Cin) fetch(ci0 + BK);  // in flight during the FMAs
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (rb[r] < 0) continue;
    float* o = out + ((static_cast<long long>(rb[r]) * a.M + roh[r]) * a.M + row_[r]) * a.Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < a.Cout) {
        float y = acc[i][j];
        if (bias != nullptr) y += bias[co];
        o[co] = activate(y, a.act, a.slope);
      }
    }
  }
}

}  // namespace

extern "C" int tconv_gemm_f32(
    const float* x, const float* w, const float* bias, float* out,
    int B, int N, int Cin, int Cout, int n_k, int P, int M, int Hp,
    int n_m, int n_co, int act, float slope, void* stream) {
  GemmArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.P = P;
  a.M = M; a.Hp = Hp; a.act = act; a.slope = slope;
  const dim3 grid(n_m, n_co);
  gemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(x, w, bias, out, a);
  return static_cast<int>(cudaGetLastError());
}
