// Implicit-GEMM transpose convolution, fp32, for sm_90a.
//
// Replaces: src/repro/kernels/transpose_conv2d_gemm.py::transpose_conv2d_pallas_gemm
// (the Pallas TPU kernel _gemm_kernel).
//
// Computes the layer as four implicit GEMMs, one per output parity (the
// segregated form):
//   out[b, 2t+pr, 2u+pc, co] = act(bias[co] + sum_{p, q, ci}
//       Ipad[b, row0(pr)+t+p, col0(pc)+u+q, ci] * S[wsel(pr,pc), p, q, ci, co])
// Rows are the parity's phase-plane positions (b, t, u) with the batch folded
// in, the contraction runs over that parity's R x R sub-kernel taps x Cin,
// and the columns are Cout. Ipad is the NHWC input seen through a floor(P/2)
// zero border and S the sub-kernel stack read straight from the HWIO kernel
// (S[s, p, q] = K[2p + s/2, 2q + s%2], zero past the n x n kernel). The
// geometry (phase origins, the odd-padding swap, chunks, splits, shared
// memory) is computed in Python (transpose_conv2d_gemm.py::gemm_geometry);
// the launcher checks that it agrees with the constants compiled here.
//
// What bounds it on the H100: the channel-deep head layers it serves (every
// zoo generator's L0, a 4 x 4 phase plane). DCGAN L0 at batch 1 reads 33.5 MB
// of weights to do 16 FMAs with each: bytes bound it (10 us at 3.35 TB/s).
// At batch 8 it does 1.07 G FMAs on the same bytes: fp32 FMAs bound it (32 us
// at 67 TFLOP/s).
//
// The design:
// - One output parity a block, so each row reads every tap of the block's
//   contraction: no tap is walked that no row reads.
// - Split contraction. Each block takes a contiguous run of the parity's
//   (tap, 16-channel chunk) steps. The split count depends on the layer's
//   shape alone: enough that the layer's grid at batch 1 reaches two blocks
//   an SM, so at bucket 1 every SM streams its share of the weights. Each
//   split writes its own slice of partial sums, and the header's
//   reduce_splits_kernel adds them in split order, then bias and activation.
// - Staging. Steps run through a 3-stage cp.async ring (tconv::cp_quad:
//   16-byte copies, or 4-byte ones where a channel count is ragged or a row
//   unaligned, chosen at run time; borders and rows past the batch
//   zero-filled): the input rows [row][channel] from NHWC and the weights
//   [channel][Cout] from HWIO, each in its own order.
// - Register tile. 128 threads: 2 warp slices x 4 row groups x 16 channel
//   groups. A thread owns 8 consecutive rows x 8 output channels (4 at
//   4 cg, 4 at 64 + 4 cg): per 4 contraction steps it loads 8 input float4s
//   (along the contraction) and 8 weight float4s, and does 256 FMAs, 16 a
//   128-bit shared load. Each slice takes half of
//   every stage's 4-channel groups; after the loop the two slices add
//   through shared memory in slice order.
// - Rows and batch. A 32-row tile folds images into its rows, so the
//   weights feed 32 positions at batch 8; at batch 1 a DCGAN L0 plane holds
//   16, and the warps whose 16 rows lie past the batch skip their FMAs
//   whole (a warp-uniform test).
// Every output's sum runs over (split, step, slice, 4-channel group,
// channel) in an order fixed by the shape, never by the batch: no atomics,
// so a batched call gives each sample the bits of its own unbatched call.

#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace {

using tconv::activate;
using tconv::component;
using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;
using tconv::pick2;
using tconv::pick4;

constexpr int BM = 32;        // rows (one parity's positions, batch folded in) a block
constexpr int BN = 128;       // output channels a block
constexpr int BK = 16;        // input channels a step (one tap)
constexpr int KS = 2;         // warp slices of each step
constexpr int NT = 128;       // threads: KS x 4 row groups x 16 channel groups
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int AP = BK + 4;    // staged input row pitch (floats): rows 5 bank groups apart
constexpr int STAGE = BM * AP + BK * BN;   // floats: input rows, then weight rows
constexpr int RING = STAGES * STAGE;
constexpr int OUT = KS * BM * BN;          // the slices' tiles after the loop
constexpr int SMEM = 4 * (RING > OUT ? RING : OUT);
static_assert(KS * 4 * 16 == NT && BM == 4 * 8 && BN == 16 * 8, "thread map");
static_assert(BM * BK / 4 == NT && (BK * BN / 4) % NT == 0, "copy map");

struct GemmArgs {
  int B, N, Cin, Cout, n_k, M, R;
  int org_r[2], org_c[2];   // input row/col of plane position 0, tap 0, by parity
  int wsel[4];              // output parity (2*pr+pc) -> stacked sub-kernel
  int n_co;                 // Cout tiles
  int splits;               // contraction splits (1: the epilogue runs here)
  int cpt;                  // 16-channel steps a tap
  int n_steps;              // R * R * cpt
  int vx, vw;               // 16-byte copies of the input / of weights and outputs
  int act;
  float slope;
};

// Issue this thread's copies of step `step` into the ring slot at `as`: its
// input row's 4-channel group `aq`, then 4 weight rows' 16-byte pieces.
__device__ __forceinline__ void stage(float* as, const float* __restrict__ x,
                                      const float* __restrict__ w, const GemmArgs& a,
                                      int step, int s, int co0, bool a_live, int a_b,
                                      int a_r0, int a_c0) {
  const int tid = threadIdx.x;
  const int tap = step / a.cpt;
  const int ci0 = (step - tap * a.cpt) * BK;
  const int p = tap / a.R;
  const int q = tap - p * a.R;
  // the input: thread tid stages row tid / 4, channels 4 (tid % 4) ..
  {
    const int ih = a_r0 + p;
    const int iw = a_c0 + q;
    const int ci = ci0 + 4 * (tid & 3);
    const bool in = a_live && ih >= 0 && ih < a.N && iw >= 0 && iw < a.N;
    const float* src = in
        ? x + ((static_cast<long long>(a_b) * a.N + ih) * a.N + iw) * a.Cin + ci
        : x;
    cp_quad(as + (tid >> 2) * AP + 4 * (tid & 3), src, x, in ? a.Cin - ci : 0, a.vx);
  }
  // the weights [ci][BN]: thread tid stages piece tid % 32 of rows tid / 32 + 4 j
  float* bs = as + BM * AP;
  const int kh = 2 * p + (s >> 1);
  const int kw = 2 * q + (s & 1);
  const bool tap_in = kh < a.n_k && kw < a.n_k;
  const int co = co0 + 4 * (tid & 31);
#pragma unroll
  for (int j = 0; j < BK * BN / 4 / NT; ++j) {
    const int row = (tid >> 5) + (NT / 32) * j;
    const int ci = ci0 + row;
    const bool in = tap_in && ci < a.Cin;
    const float* src = in
        ? w + ((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + ci) * a.Cout + co
        : w;
    cp_quad(bs + row * BN + 4 * (tid & 31), src, w, in ? a.Cout - co : 0, a.vw);
  }
}

__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ part, const __grid_constant__ GemmArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int rg = (tid >> 4) & 3;
  const int ksl = tid >> 6;

  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y / a.n_co;
  const int co0 = (blockIdx.y - split * a.n_co) * BN;
  const int par = blockIdx.z;
  const int pr = par >> 1;
  const int pc = par & 1;
  const int s = pick4(a.wsel, par);
  const int hp = (a.M + 1) >> 1;
  const int plane = hp * hp;
  const int rows = a.B * plane;

  // the input row this thread stages, resolved once
  const int ar = m0 + (tid >> 2);
  const bool a_live = ar < rows;
  const int a_b = ar / plane;
  const int a_t = (ar - a_b * plane) / hp;
  const int a_u = ar - a_b * plane - a_t * hp;
  const int a_r0 = pick2(a.org_r, pr) + a_t;
  const int a_c0 = pick2(a.org_c, pc) + a_u;

  const int c_lo = split * a.n_steps / a.splits;
  const int nk = (split + 1) * a.n_steps / a.splits - c_lo;
  // a warp's 16 rows (row groups 2w, 2w + 1 of its slice) wholly past the
  // batch add nothing: the test is uniform over the warp
  const bool live = m0 + (rg >> 1) * 16 < rows;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      stage(smem + st * STAGE, x, w, a, c_lo + st, s, co0, a_live, a_b, a_r0, a_c0);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of step k landed
    __syncthreads();               // everyone's did; step k - 1 is consumed
    if (k + STAGES - 1 < nk)
      stage(smem + (k + STAGES - 1) % STAGES * STAGE, x, w, a, c_lo + k + STAGES - 1, s,
            co0, a_live, a_b, a_r0, a_c0);
    cp_async_commit();
    if (!live) continue;
    const float* as = smem + (k % STAGES) * STAGE;
    const float* bs = as + BM * AP;
#pragma unroll
    for (int h = 0; h < BK / 4 / KS; ++h) {   // this slice's 4-channel groups
      const int kq = ksl + KS * h;
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (rg * 8 + i) * AP + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (4 * kq + kk) * BN + 4 * cg);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + (4 * kq + kk) * BN + 64 + 4 * cg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = component(av[i], kk);
          acc[i][0] = fmaf(xv, b0.x, acc[i][0]);
          acc[i][1] = fmaf(xv, b0.y, acc[i][1]);
          acc[i][2] = fmaf(xv, b0.z, acc[i][2]);
          acc[i][3] = fmaf(xv, b0.w, acc[i][3]);
          acc[i][4] = fmaf(xv, b1.x, acc[i][4]);
          acc[i][5] = fmaf(xv, b1.y, acc[i][5]);
          acc[i][6] = fmaf(xv, b1.z, acc[i][6]);
          acc[i][7] = fmaf(xv, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The slices' tiles go through shared memory (the ring is free now), so
  // they add in slice order and the stores run along contiguous channels.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* t = smem + (ksl * BM + rg * 8 + i) * BN + 4 * cg;
    *reinterpret_cast<float4*>(t) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(t + 64) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const bool partial = a.splits > 1;
  float* dst = partial ? part + static_cast<long long>(split) * a.B * a.M * a.M * a.Cout
                       : out;
  // e runs over (row, channel quad), the quad fastest
  for (int e = tid; e < BM * BN / 4; e += NT) {
    const int cq = e % (BN / 4);
    const int row = e / (BN / 4);
    const int r = m0 + row;
    const int co = co0 + 4 * cq;
    if (r >= rows || co >= a.Cout) continue;
    const int b = r / plane;
    const int t = (r - b * plane) / hp;
    const int u = r - b * plane - t * hp;
    const int oh = 2 * t + pr;
    const int ow = 2 * u + pc;
    if (oh >= a.M || ow >= a.M) continue;
    float4 v = *reinterpret_cast<const float4*>(smem + row * BN + 4 * cq);
#pragma unroll
    for (int sl = 1; sl < KS; ++sl) {
      const float4 o = *reinterpret_cast<const float4*>(smem + (sl * BM + row) * BN + 4 * cq);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    const int nb = a.Cout - co;   // channels of this quad that exist
    if (!partial) {
      if (bias != nullptr) {
        v.x += bias[co];
        if (nb > 1) v.y += bias[co + 1];
        if (nb > 2) v.z += bias[co + 2];
        if (nb > 3) v.w += bias[co + 3];
      }
      v.x = activate(v.x, a.act, a.slope);
      v.y = activate(v.y, a.act, a.slope);
      v.z = activate(v.z, a.act, a.slope);
      v.w = activate(v.w, a.act, a.slope);
    }
    float* o = dst + ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout + co;
    if (a.vw) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      if (nb > 1) o[1] = v.y;
      if (nb > 2) o[2] = v.z;
      if (nb > 3) o[3] = v.w;
    }
  }
}

}  // namespace

// The Python geometry and the constants compiled here must describe the
// same kernel: tile, steps, splits and shared memory are checked.
extern "C" int tconv_gemm_f32(
    const float* x, const float* w, const float* bias, float* out, float* part,
    int B, int N, int Cin, int Cout, int n_k, int M, int R,
    int org_r0, int org_r1, int org_c0, int org_c1,
    int wsel0, int wsel1, int wsel2, int wsel3,
    int bm, int bn, int bk, int n_m, int n_co, int splits, int cpt, int n_steps,
    int vx, int vw, int act, float slope, int smem_bytes, void* stream) {
  GemmArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M; a.R = R;
  a.org_r[0] = org_r0; a.org_r[1] = org_r1; a.org_c[0] = org_c0; a.org_c[1] = org_c1;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.n_co = n_co; a.splits = splits; a.cpt = cpt; a.n_steps = n_steps;
  a.vx = vx; a.vw = vw; a.act = act; a.slope = slope;
  const int hp = (M + 1) / 2;
  if (bm != BM || bn != BN || bk != BK || smem_bytes != SMEM ||
      n_m != (B * hp * hp + BM - 1) / BM || n_co != (Cout + BN - 1) / BN ||
      cpt != (Cin + BK - 1) / BK || n_steps != R * R * cpt || splits < 1 ||
      splits > n_steps || (splits > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // several blocks an SM need the largest shared-memory carveout
  e = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_kernel<<<dim3(n_m, splits * n_co, 4), NT, smem_bytes, st>>>(x, w, bias, out, part, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long total = static_cast<long long>(B) * M * M * Cout;
  return static_cast<int>(
      tconv::reduce_splits(part, bias, out, total, Cout, splits, act, slope, st));
}
