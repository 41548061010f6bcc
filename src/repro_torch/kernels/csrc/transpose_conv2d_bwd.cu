// Segregated backward of the unified transpose convolution, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/transpose_conv2d_bwd.py:
//   epilogue_grad_kernel  <- epilogue_grad_pallas       (_epilogue_grad_kernel)
//   dx_kernel, dx_poor_kernel <- transpose_conv2d_dx_pallas (_dx_kernel)
//   dw_kernel, dw_poor_kernel <- transpose_conv2d_dw_pallas (_dw_kernel, with_db)
// plus sum_splits_kernel, the second pass of a split contraction.
//
// The functions (geometry computed in Python, transpose_conv2d_bwd.py):
//   gm = g * act'(y)         (from the saved output y; folded into dx and dw)
//   dx[b,i,j,ci] = sum_{ph,p,q,co} gm[b, 2t+pr, 2u+pc, co] * S[wsel(ph), p, q, ci, co]
//       t = i + roff(pr) - p, u = j + coff(pc) - q; zero where t, u < 0 or
//       the output row/col 2t+pr, 2u+pc >= M
//   dw[kh,kw,ci,co] = sum_{b,t,u} Ipad[b, row0(pr)+t+p, col0(pc)+u+q, ci] * gm[b, 2t+pr, 2u+pc, co]
//       with (pr, pc, p, q) the one phase and stacked tap that read HWIO tap
//       (kh, kw): s = 2(kh%2) + kw%2, p = kh/2, q = kw/2, (pr,pc) = phase_of_sub(s)
//   db[co] = sum_{b,oh,ow} gm[b, oh, ow, co]
// S[s, p, q] = K[2p + s/2, 2q + s%2] is the sub-kernel stack, read straight
// from the HWIO kernel; Ipad is x seen through a floor(P/2) zero border.
//
// What bounds them on the H100: dx and dw each do the forward's MACs (2.15
// GFLOP at DCGAN L0-L2, batch 8) on a few MB, far above the fp32 ridge
// (~20 FLOP/byte), so fp32 arithmetic bounds them (~32 us at 67 TFLOP/s).
// Epilogue-grad moves 3 bytes per byte it computes on and is bound by HBM.
//
// What these designs do about it:
// - epilogue-grad: one grid-stride pass, one read of g and y, one write. The
//   products are rounded one by one (__fmul_rn/__fsub_rn, no FMA
//   contraction), so the kernel gives the bits of the plain PyTorch version.
//   A standalone pass is a launch floor (2-4 us for 1.5 us of bytes at most),
//   so the backward of a layer does not run it: the four dx and dw instances
//   take g, y and the activation (act != 0) and apply act_grad as they stage
//   g. The rich ones load a thread's y pieces of a ring stage into
//   registers (same mapping, same zero fill as its g pieces) and, after the
//   FMAs of the stage being read, store g * act'(y) into the stage's slot:
//   rich dx loads g into registers too, rich dw copies g by cp.async and
//   rewrites it in place; no shared memory is added. Poor dx loads each
//   pixel of a window once a position group, folds it and shares it through
//   shared memory; poor dw applies it in registers. Every staged gm value
//   has the standalone kernel's bits and every sum keeps its order; gm is
//   never written, and each kernel reads y where it read gm.
// - dx is an implicit GEMM: rows dx positions (b, i, j), columns Cin, the
//   contraction over the stacked taps (parity, p, q) x Cout. Two layouts,
//   chosen by Cout:
//   "rich" (Cout > 4): 256 threads with 8 x 8 fp32 accumulators each on a
//   128 x 128 block tile; 16-channel Cout steps through a 4-stage cp.async
//   ring, one barrier a step. Both operands are contiguous along the
//   contraction (a gm pixel in NHWC, a weight row K[kh, kw, ci, :] in
//   HWIO), so both are staged [row][step] in their own order with 16-byte
//   copies (4-byte where Cout is ragged or a row unaligned) and a thread
//   reads float4s along the contraction: 16 FMAs a 128-bit shared load. A
//   thread stages two gm rows and resolves their pixel for each tap by its
//   own index math; borders, and taps past an odd kernel, are zero-filled.
//   "poor" (Cout <= 4, every zoo output layer, where writing dx takes as
//   long as the FMAs: 1.37 against 1.50 us at DCGAN L3): the contraction
//   is not padded to 16 channels. The 4 R R taps x 32 Cin of weights sit in
//   shared memory; a thread takes 8 consecutive positions x 4 Cin, walks
//   each parity's row taps with a sliding window of 8 + R - 1 gm pixels
//   (one float4 each: Cout channels, zeros after) and writes dx in 16-byte
//   pieces along Cin.
// - dw is one GEMM per HWIO tap, rows Cin, columns Cout, K over the B*Hp*Hp
//   positions of that tap's phase plane. Two layouts, chosen by Cout:
//   "rich"/"narrow" (Cout > 4): 256 threads with 8 x 8 fp32 accumulators
//   each (16 FMAs a 128-bit shared load) on a 128 x 128 or 256 x 64 block
//   tile; positions stream through a 3-stage cp.async ring, one barrier a
//   16-position stage. A thread stages one position's x row (Cin) and gm
//   row (Cout) pieces straight from NHWC in 16-byte copies (4-byte where a
//   channel count is ragged or a row unaligned), resolving that position's
//   two pixels by its own index math. db is summed from the staged gm
//   tiles by the blocks of each phase's first tap and first Cin block.
//   "poor" (Cout <= 4, a GAN's output layer, bound by reading x): a block
//   takes one phase, one row tap p and 64 Cin; a thread keeps the R column
//   taps of that row x 4 Cin x 4 Cout and walks phase-plane rows with a
//   sliding window of R float4 pixels, so each x pixel is read once per
//   (phase, p) and one gm pixel feeds R taps (one lane of the slice loads
//   each of its channels, the shuffles share it); 16 row slices of a block are
//   added in slice order through shared memory. The rows are split widely
//   across blocks.
// - Determinism: no atomics. Where the TPU carried a sum across sequential
//   grid steps, a block loops. Where that leaves too few blocks for 132 SMs,
//   the contraction is split into a number of parts that depends only on the
//   layer's shape (bwd_geometry); each part is written to its own slice and
//   sum_splits_kernel adds the slices in split order. Every sum therefore
//   runs in one fixed order, and a resumed training run repeats its bits.

#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace {

using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;
using tconv::pick2;
using tconv::pick4;

// ------------------------------------------------------------ epilogue grad

// g * act'(y), the one expression of every kernel here that applies it: the
// standalone pass and the dx and dw kernels that fold it into their staging
// give the same bits for the same (g, y).
template <int ACT>
__device__ __forceinline__ float act_grad_c(float gv, float yv, float slope) {
  if (ACT == 1) return yv > 0.f ? gv : 0.f;                                // relu
  if (ACT == 2) return __fmul_rn(gv, __fsub_rn(1.f, __fmul_rn(yv, yv)));   // tanh
  if (ACT == 3) return yv > 0.f ? gv : __fmul_rn(slope, gv);               // leaky
  return gv;
}

__device__ __forceinline__ float act_grad(float gv, float yv, int act, float slope) {
  switch (act) {
    case 1: return act_grad_c<1>(gv, yv, slope);
    case 2: return act_grad_c<2>(gv, yv, slope);
    case 3: return act_grad_c<3>(gv, yv, slope);
    default: return gv;
  }
}

template <int ACT>
__device__ __forceinline__ float4 act_grad4_c(float4 gv, float4 yv, float slope) {
  return make_float4(act_grad_c<ACT>(gv.x, yv.x, slope), act_grad_c<ACT>(gv.y, yv.y, slope),
                     act_grad_c<ACT>(gv.z, yv.z, slope), act_grad_c<ACT>(gv.w, yv.w, slope));
}

// act' of four channels, chosen at run time (the rich kernels' stores).
__device__ __forceinline__ float4 act_grad4(float4 gv, float4 yv, int act, float slope) {
  return make_float4(act_grad(gv.x, yv.x, act, slope), act_grad(gv.y, yv.y, act, slope),
                     act_grad(gv.z, yv.z, act, slope), act_grad(gv.w, yv.w, act, slope));
}

// cp_quad's copy into registers: 4 floats from src of which n exist (zeros
// after; none read when n <= 0), one 16-byte load where vec.
__device__ __forceinline__ float4 ld_quad(const float* src, int n, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n <= 0) return v;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  v.x = __ldg(src);
  if (n > 1) v.y = __ldg(src + 1);
  if (n > 2) v.z = __ldg(src + 2);
  if (n > 3) v.w = __ldg(src + 3);
  return v;
}

__global__ void epilogue_grad_kernel(const float* __restrict__ g,
                                     const float* __restrict__ y,
                                     float* __restrict__ out, long long n,
                                     int act, float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = act_grad(g[i], y[i], act, slope);
}

// ---------------------------------------------------------------------- dx

struct DxArgs {
  int B, N, Cin, Cout, n_k, M, R;
  int roff[2], coff[2];  // plane-row offset by output parity: pad_lo - row0
  int wsel[4];           // output parity -> stacked sub-kernel
  int cpt;               // 16-channel Cout steps a tap (rich)
  int n_steps;           // 4 R R cpt (rich)
  int splits;            // contraction splits (rich)
  int vg;                // 16-byte copies of gm and weight rows (Cout a multiple of 4)
  int vx;                // 16-byte dx stores (Cin a multiple of 4; poor)
  int n_groups;          // position groups of the poor layout
  int gpr;               // ... along a dx row
  int act;               // 0: g is gm; else g * act'(y) is applied as g is staged
  float slope;           // leaky_relu's negative slope (act 3)
};

// The rich layout (Cout > 4): rows are dx positions (b, i, j), columns Cin,
// the contraction runs over the stacked taps (parity, p, q) x Cout in
// 16-channel steps. Both operands are contiguous along the contraction (a
// gm pixel's channels in NHWC, a weight row K[kh, kw, ci, :] in HWIO), so
// both are staged [row][step] in their own order with 16-byte copies and a
// thread reads float4s along the contraction: 8 rows x 8 Cin a thread, 16
// FMAs a 128-bit shared load.
constexpr int DX_BM = 128;     // dx positions a block
constexpr int DX_BN = 128;     // input channels a block
constexpr int DX_BK = 16;      // Cout channels a step (one tap)
constexpr int DX_THREADS = 256;
constexpr int DX_STAGES = 4;   // cp.async ring depth
constexpr int DX_P = DX_BK + 4;   // staged row pitch: 8 consecutive rows, 8 bank groups
constexpr int DX_STAGE = (DX_BM + DX_BN) * DX_P;
constexpr int DX_SMEM = 4 * DX_STAGES * DX_STAGE;
static_assert(DX_BM * DX_BK / 4 == 2 * DX_THREADS && DX_BN * DX_BK / 4 == 2 * DX_THREADS,
              "two copies of each operand a thread");

// Issue this thread's copies of step `step` into the ring slot at `as`:
// gm rows tid / 4 and 64 + tid / 4 (their pixel for this tap, resolved by
// the thread) and weight rows ci0 + tid / 4 and ci0 + 64 + tid / 4, each
// the 16-byte piece tid % 4 of the step. With act' folded (FOLD), the two g
// pieces and their y pieces (same mapping, same zero fill) are loaded into
// `gr` and `yr` instead; dx_put stores them folded.
template <int FOLD>
__device__ __forceinline__ void dx_stage(float* as, float4 (&gr)[2], float4 (&yr)[2],
                                         const float* __restrict__ g,
                                         const float* __restrict__ y,
                                         const float* __restrict__ w, const DxArgs& a,
                                         int step, int ci0, const int (&rb)[2],
                                         const int (&ri)[2], const int (&rj)[2]) {
  const int tid = threadIdx.x;
  const int tap = step / a.cpt;
  const int co = (step - tap * a.cpt) * DX_BK + 4 * (tid & 3);
  const int rr = a.R * a.R;
  const int ph = tap / rr;
  const int p = (tap - ph * rr) / a.R;
  const int q = tap - ph * rr - p * a.R;
  const int pr = ph >> 1;
  const int pc = ph & 1;
  const int s = pick4(a.wsel, ph);
  const int kh = 2 * p + (s >> 1);
  const int kw = 2 * q + (s & 1);
  const bool tap_in = kh < a.n_k && kw < a.n_k;
  float* bs = as + DX_BM * DX_P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (tid >> 2) + 64 * h;
    // test the sign before anything else: no division of a negative
    const int t = ri[h] + pick2(a.roff, pr) - p;
    const int u = rj[h] + pick2(a.coff, pc) - q;
    const int oh = 2 * t + pr;
    const int ow = 2 * u + pc;
    const bool in = rb[h] >= 0 && t >= 0 && u >= 0 && oh < a.M && ow < a.M;
    const long long off =
        in ? ((static_cast<long long>(rb[h]) * a.M + oh) * a.M + ow) * a.Cout + co : 0;
    const int n = in ? a.Cout - co : 0;
    if (FOLD) {
      gr[h] = ld_quad(g + off, n, a.vg);
      yr[h] = ld_quad(y + off, n, a.vg);
    } else {
      cp_quad(as + row * DX_P + 4 * (tid & 3), g + off, g, n, a.vg);
    }
    const int ci = ci0 + row;
    const bool win = tap_in && ci < a.Cin;
    const float* wsrc = win
        ? w + ((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + ci) * a.Cout + co
        : w;
    cp_quad(bs + row * DX_P + 4 * (tid & 3), wsrc, w, win ? a.Cout - co : 0, a.vg);
  }
}

// Store this thread's two gm pieces, g * act'(y), into the ring slot at `as`.
__device__ __forceinline__ void dx_put(float* as, const float4 (&gr)[2],
                                       const float4 (&yr)[2], const DxArgs& a) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(as + ((threadIdx.x >> 2) + 64 * h) * DX_P +
                               4 * (threadIdx.x & 3)) = act_grad4(gr[h], yr[h], a.act, a.slope);
}

// FOLD: one instance stages gm (act 0), the other g and y, folding act'.
template <int FOLD>
__global__ void __launch_bounds__(DX_THREADS)
dx_kernel(const float* __restrict__ g, const float* __restrict__ y,
          const float* __restrict__ w, float* __restrict__ out,
          const __grid_constant__ DxArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid & 15;   // Cin cg + 16 j of the tile
  const int rg = tid >> 4;   // rows rg + 16 i of the tile
  const int m0 = blockIdx.x * DX_BM;
  const int ci0 = blockIdx.y * DX_BN;
  const int split = blockIdx.z;
  const int plane = a.N * a.N;
  const int rows = a.B * plane;

  // the two gm rows this thread stages, resolved once; b -1 past the end
  int rb[2], ri[2], rj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + (tid >> 2) + 64 * h;
    rb[h] = r < rows ? r / plane : -1;
    ri[h] = (r % plane) / a.N;
    rj[h] = r % a.N;
  }
  const int c_lo = split * a.n_steps / a.splits;
  const int nk = (split + 1) * a.n_steps / a.splits - c_lo;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // act' folded: this thread's g and y pieces of the step in flight. They
  // are loaded as the step's copies are issued and stored folded after the
  // FMAs of the step being read (dx_put): gm goes through registers, so the
  // fold adds no shared-memory traffic (staging y there and rewriting g in
  // place cost 7-8 us at DCGAN L0-L2, probe)
  float4 gr[2], yr[2];
  {
    // the first steps' loads all issued before any is stored: one wait
    float4 pg[DX_STAGES - 1][2], py[DX_STAGES - 1][2];
#pragma unroll
    for (int st = 0; st < DX_STAGES - 1; ++st) {
      if (st < nk)
        dx_stage<FOLD>(smem + st * DX_STAGE, pg[st], py[st], g, y, w, a, c_lo + st, ci0, rb,
                       ri, rj);
      cp_async_commit();
    }
#pragma unroll
    for (int st = 0; st < DX_STAGES - 1; ++st)
      if (FOLD && st < nk) dx_put(smem + st * DX_STAGE, pg[st], py[st], a);
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<DX_STAGES - 2>();   // this thread's copies of step k landed
    __syncthreads();                  // everyone's did; step k - 1 is consumed
    const bool next = k + DX_STAGES - 1 < nk;
    float* const next_slot = smem + (k + DX_STAGES - 1) % DX_STAGES * DX_STAGE;
    if (next)
      dx_stage<FOLD>(next_slot, gr, yr, g, y, w, a, c_lo + k + DX_STAGES - 1, ci0, rb, ri,
                     rj);
    cp_async_commit();
    const float* as = smem + (k % DX_STAGES) * DX_STAGE;
    const float* bs = as + DX_BM * DX_P;
#pragma unroll
    for (int kq = 0; kq < DX_BK / 4; ++kq) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (rg + 16 * i) * DX_P + 4 * kq);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + (cg + 16 * j) * DX_P + 4 * kq);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[i][j];
          v = fmaf(av[i].x, bv.x, v);
          v = fmaf(av[i].y, bv.y, v);
          v = fmaf(av[i].z, bv.z, v);
          acc[i][j] = fmaf(av[i].w, bv.w, v);
        }
      }
    }
    // the next step's gm pieces: its slot held step k - 1, consumed before
    // this step's barrier; the barrier of step k + 1 publishes them
    if (FOLD && next) dx_put(next_slot, gr, yr, a);
  }
  cp_async_wait<0>();

  float* o = out + static_cast<long long>(split) * rows * a.Cin;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + rg + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = ci0 + cg + 16 * j;
      if (ci < a.Cin) o[static_cast<long long>(r) * a.Cin + ci] = acc[i][j];
    }
  }
}

// The poor layout (Cout <= 4, every zoo output layer): the contraction is
// 4 R R taps x Cout channels, so it is not padded to 16 channels. A block
// takes 32 Cin and 32 groups of 8 consecutive dx positions along a row; the
// 4 R R taps x 32 Cin of weights ([tap][ci][4 co], Cout padded with zeros)
// sit in shared memory. A thread takes one group x 4 Cin: for each parity
// and row tap it loads a sliding window of 8 + R - 1 gm pixels, each one
// float4 (Cout channels and zeros, masked on load), and applies the R column
// taps to its 8 positions; dx goes out in 16-byte writes along Cin, 128
// contiguous bytes a position.
constexpr int DXP_THREADS = 256;
constexpr int DXP_CT = 32;     // Cin a block
constexpr int DXP_NP = 8;      // positions a thread
constexpr int DXP_GROUPS = DXP_THREADS / (DXP_CT / 4);   // position groups a block
constexpr int MAX_R = 4;       // the poor layouts' largest stacked sub-kernel

template <int R>
constexpr int dx_poor_smem() { return 4 * 4 * R * R * DXP_CT * 4; }

// One thread's walk of the poor layout: for each parity and row tap a
// sliding window of gm pixels, the R column taps applied to its 8 positions.
// ACT is a template argument so that no branch sits between a window's
// loads: a run-time choice a pixel ran the unfolded kernel 1.4x slower
// (probe). Where ACT folds act', the 8 lanes of the position group (its Cin
// quads) share each window instead of each loading all of it: lane cq loads
// g and y of pixels cq and cq + 8, forms g * act'(y) and writes it to the
// group's window `gwin` in shared memory, and every lane reads the window
// back, so each pixel is loaded and folded once a group, not 8 times.
template <int R, int ACT>
__device__ __forceinline__ void dx_poor_walk(const float* __restrict__ g,
                                             const float* __restrict__ y,
                                             const float* wsm, float4* gwin, const DxArgs& a,
                                             int b, int i, int j0, int cq,
                                             float4 (&acc)[DXP_NP]) {
  const unsigned gmask = 0xffu << (threadIdx.x & 24);   // the group's 8 lanes
  const long long img = static_cast<long long>(b) * a.M * a.M * a.Cout;
  auto load = [&](const float* src) {   // a pixel's Cout channels, zeros after
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.vg) {
      v = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      v.x = __ldg(src);
      if (a.Cout > 1) v.y = __ldg(src + 1);
      if (a.Cout > 2) v.z = __ldg(src + 2);
      if (a.Cout > 3) v.w = __ldg(src + 3);
    }
    return v;
  };
  auto pixel = [&](int oh, int ow) {
    const long long off = img + (static_cast<long long>(oh) * a.M + ow) * a.Cout;
    if (ACT == 0) return load(g + off);
    return act_grad4_c<ACT>(load(g + off), load(y + off), a.slope);
  };
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int pr = ph >> 1;
    const int pc = ph & 1;
    const int u0 = j0 + pick2(a.coff, pc) - (R - 1);   // the window's first plane column
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int t = i + pick2(a.roff, pr) - p;
      const int oh = 2 * t + pr;
      if (t < 0 || oh >= a.M) continue;
      float4 win[DXP_NP + R - 1];
      if (ACT == 0) {
#pragma unroll
        for (int m = 0; m < DXP_NP + R - 1; ++m) {
          const int u = u0 + m;
          const int ow = 2 * u + pc;
          win[m] = u >= 0 && ow < a.M ? pixel(oh, ow) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        __syncwarp(gmask);   // the group has read its last window
        for (int m = cq; m < DXP_NP + R - 1; m += DXP_CT / 4) {
          const int u = u0 + m;
          const int ow = 2 * u + pc;
          gwin[m] = u >= 0 && ow < a.M ? pixel(oh, ow) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncwarp(gmask);   // ... and written this one
#pragma unroll
        for (int m = 0; m < DXP_NP + R - 1; ++m) win[m] = gwin[m];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float* wt = wsm + ((ph * R * R + p * R + q) * DXP_CT + 4 * cq) * 4;
        float4 wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[c] = *reinterpret_cast<const float4*>(wt + 4 * c);
#pragma unroll
        for (int n = 0; n < DXP_NP; ++n) {
          const float4 gv = win[n + R - 1 - q];   // plane column j0 + n + coff - q
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float v = tconv::component(acc[n], c);
            v = fmaf(gv.x, wv[c].x, v);
            v = fmaf(gv.y, wv[c].y, v);
            v = fmaf(gv.z, wv[c].z, v);
            v = fmaf(gv.w, wv[c].w, v);
            if (c == 0) acc[n].x = v;
            else if (c == 1) acc[n].y = v;
            else if (c == 2) acc[n].z = v;
            else acc[n].w = v;
          }
        }
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(DXP_THREADS)
dx_poor_kernel(const float* __restrict__ g, const float* __restrict__ y,
               const float* __restrict__ w, float* __restrict__ out,
               const __grid_constant__ DxArgs a) {
  extern __shared__ __align__(16) float smem[];   // [tap][ci][4]
  __shared__ float4 windows[DXP_GROUPS][DXP_NP + MAX_R - 1];   // folded windows, a group each
  const int tid = threadIdx.x;
  const int ci0 = blockIdx.y * DXP_CT;
  // the weights: row (tap, ci) of 4 R R x 32, a float4 of Cout channels each
  for (int row = tid; row < 4 * R * R * DXP_CT; row += DXP_THREADS) {
    const int tap = row / DXP_CT;
    const int ci = ci0 + row % DXP_CT;
    const int ph = tap / (R * R);
    const int p = tap / R % R;
    const int q = tap % R;
    const int s = pick4(a.wsel, ph);
    const int kh = 2 * p + (s >> 1);
    const int kw = 2 * q + (s & 1);
    const bool in = kh < a.n_k && kw < a.n_k && ci < a.Cin;
    const float* src = in
        ? w + ((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + ci) * a.Cout
        : w;
    cp_quad(smem + 4 * row, src, w, in ? a.Cout : 0, a.vg);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cq = tid % (DXP_CT / 4);
  const int grp = blockIdx.x * DXP_GROUPS + tid / (DXP_CT / 4);
  if (grp >= a.n_groups) return;
  const int b = grp / (a.N * a.gpr);
  const int i = grp / a.gpr % a.N;
  const int j0 = grp % a.gpr * DXP_NP;

  float4 acc[DXP_NP];
#pragma unroll
  for (int n = 0; n < DXP_NP; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* gwin = windows[tid / (DXP_CT / 4)];
  switch (a.act) {
    case 1: dx_poor_walk<R, 1>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    case 2: dx_poor_walk<R, 2>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    case 3: dx_poor_walk<R, 3>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    default: dx_poor_walk<R, 0>(g, y, smem, gwin, a, b, i, j0, cq, acc);
  }

  const int ci = ci0 + 4 * cq;
  if (ci >= a.Cin) return;
#pragma unroll
  for (int n = 0; n < DXP_NP; ++n) {
    const int j = j0 + n;
    if (j >= a.N) break;
    float* dst = out + ((static_cast<long long>(b) * a.N + i) * a.N + j) * a.Cin + ci;
    if (a.vx) {
      *reinterpret_cast<float4*>(dst) = acc[n];
    } else {
      dst[0] = acc[n].x;
      if (ci + 1 < a.Cin) dst[1] = acc[n].y;
      if (ci + 2 < a.Cin) dst[2] = acc[n].z;
      if (ci + 3 < a.Cin) dst[3] = acc[n].w;
    }
  }
}

// ---------------------------------------------------------------------- dw

struct DwArgs {
  int B, N, Cin, Cout, n_k, M, Hp, pad_lo;
  int row0[2], col0[2];  // padded-input origin by output row/col parity
  int wsel[4];           // output parity -> stacked sub-kernel
  int phase_of_sub[4];   // stacked sub-kernel -> output parity (inverse)
  int n_co_blocks;
  int per_split;         // positions (rich) or phase-plane rows (poor) a split
  int with_db;
  int vx, vw;            // 16-byte copies of x / of gm and the partial sums
  int act;               // 0: g is gm; else g * act'(y) is applied as g is staged
  float slope;           // leaky_relu's negative slope (act 3)
};

constexpr int DW_THREADS = 256;
constexpr int DW_BK = 16;      // positions a ring stage
constexpr int DW_STAGES = 3;   // cp.async ring depth
constexpr int DW_SLICES = 16;  // poor layout: row slices of a block

// The rich layout: BM Cin x BN Cout of one HWIO tap a block, 8 x 8 a
// thread (rows ty*4 + i and BM/2 + ty*4 + i, columns likewise).
template <int BM, int BN>
struct DwTile {
  static constexpr int TX = BN / 8;              // threads along Cout
  static constexpr int STAGE = DW_BK * (BM + BN);  // floats: x rows, then gm rows
  static constexpr int SMEM = 4 * DW_STAGES * STAGE;
  static constexpr int GP = BN / 64;              // gm pieces a thread a stage
  static_assert((BM / 8) * (BN / 8) == DW_THREADS, "8 x 8 a thread");
  static_assert(BM % 64 == 0 && BN % 64 == 0, "16 threads x 16 bytes a row");
};

// Issue this thread's copies of the ring stage of positions [k0, k0 + BK):
// thread tid takes position k0 + tid / 16 and the 16-byte pieces tid % 16
// + 16 j of its x row (Cin) and its gm row (Cout), so its position's two
// pixels are resolved once, by its own index math. With act' folded (FOLD),
// g's pieces are copied where gm's would be and their y pieces (same
// mapping, same zero fill) loaded into `yr`; dw_put folds them in place.
template <int BM, int BN, int FOLD>
__device__ __forceinline__ void dw_stage(float* xs, float4 (&yr)[BN / 64],
                                         const float* __restrict__ x,
                                         const float* __restrict__ g,
                                         const float* __restrict__ y, const DwArgs& a,
                                         int k0, int k_end, int pr, int pc, int p, int q,
                                         int ci0, int co0) {
  float* gs = xs + DW_BK * BM;
  const int kk = threadIdx.x / 16;
  const int lane16 = threadIdx.x % 16;
  const int k = k0 + kk;
  long long xsrc = -1;
  long long gsrc = -1;
  if (k < k_end) {
    const int plane = a.Hp * a.Hp;
    const int b = k / plane;
    const int rem = k - b * plane;
    const int t = rem / a.Hp;
    const int u = rem - t * a.Hp;
    const int oh = 2 * t + pr;
    const int ow = 2 * u + pc;
    if (oh < a.M && ow < a.M) {
      gsrc = ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout;
      const int ih = a.row0[pr] + t + p - a.pad_lo;
      const int iw = a.col0[pc] + u + q - a.pad_lo;
      if (ih >= 0 && ih < a.N && iw >= 0 && iw < a.N)
        xsrc = ((static_cast<long long>(b) * a.N + ih) * a.N + iw) * a.Cin;
    }
  }
#pragma unroll
  for (int j = 0; j < BM / 64; ++j) {
    const int ci = ci0 + 4 * (lane16 + 16 * j);
    cp_quad(xs + kk * BM + 4 * (lane16 + 16 * j), xsrc >= 0 ? x + xsrc + ci : x, x,
            xsrc >= 0 ? a.Cin - ci : 0, a.vx);
  }
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) {
    const int co = co0 + 4 * (lane16 + 16 * j);
    const long long off = gsrc >= 0 ? gsrc + co : 0;
    const int n = gsrc >= 0 ? a.Cout - co : 0;
    cp_quad(gs + kk * BN + 4 * (lane16 + 16 * j), g + off, g, n, a.vw);
    if (FOLD) yr[j] = ld_quad(y + off, n, a.vw);
  }
}

// Rewrite this thread's g pieces of the stage at `xs` in place with
// g * act'(y), once its own copies of them have landed.
template <int BM, int BN>
__device__ __forceinline__ void dw_put(float* xs, const float4 (&yr)[BN / 64],
                                       const DwArgs& a) {
  float* gs = xs + DW_BK * BM;
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) {
    float4* piece = reinterpret_cast<float4*>(gs + threadIdx.x / 16 * BN +
                                              4 * (threadIdx.x % 16 + 16 * j));
    *piece = act_grad4(*piece, yr[j], a.act, a.slope);
  }
}

// Two blocks an SM (128 registers at most: left to itself the instance that
// folds act' takes 129, one block an SM, and runs 1.1x slower at DCGAN
// L0-L2, probe). FOLD: one instance a tile stages gm (act 0), the other g
// and y, folding act'.
template <int BM, int BN, int FOLD>
__global__ void __launch_bounds__(DW_THREADS, 2)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ y, float* __restrict__ part,
          float* __restrict__ db_part, const __grid_constant__ DwArgs a) {
  using T = DwTile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ci0 = (blockIdx.x / a.n_co_blocks) * BM;
  const int co0 = (blockIdx.x % a.n_co_blocks) * BN;
  const int tap = blockIdx.y;
  const int split = blockIdx.z;
  const int kh = tap / a.n_k;
  const int kw = tap % a.n_k;
  const int ph = a.phase_of_sub[2 * (kh & 1) + (kw & 1)];
  const int pr = ph >> 1;
  const int pc = ph & 1;
  const int p = kh >> 1;
  const int q = kw >> 1;
  const int positions = a.B * a.Hp * a.Hp;
  const int k_begin = split * a.per_split;
  const int k_end = min(positions, k_begin + a.per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + DW_BK - 1) / DW_BK : 0;
  // the blocks of each phase's first tap and first Cin block also sum db
  const bool do_db = a.with_db && p == 0 && q == 0 && ci0 == 0;

  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dbacc = 0.f;

  // act' folded: g is copied into the stage as gm is, and this thread's y
  // pieces of the stage in flight wait in registers; after the FMAs of the
  // stage being read, the thread rewrites its g pieces of that stage in place
  // (dw_put). Holding g in registers as well, as dx does, spills at two
  // blocks an SM and runs slower (probe).
  float4 yr[T::GP];
  {
    // the first stages' loads all issued before any is folded: one wait
    float4 py[DW_STAGES - 1][T::GP];
#pragma unroll
    for (int s = 0; s < DW_STAGES - 1; ++s) {
      if (s < steps)
        dw_stage<BM, BN, FOLD>(smem + s * T::STAGE, py[s], x, g, y, a, k_begin + s * DW_BK,
                               k_end, pr, pc, p, q, ci0, co0);
      cp_async_commit();
    }
#pragma unroll
    for (int s = 0; s < DW_STAGES - 1; ++s)
      if (FOLD && s < steps) dw_put<BM, BN>(smem + s * T::STAGE, py[s], a);
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<DW_STAGES - 2>();   // this thread's copies of stage k landed
    __syncthreads();                  // everyone's did; stage k - 1 is consumed
    const bool next = k + DW_STAGES - 1 < steps;
    float* const next_slot = smem + (k + DW_STAGES - 1) % DW_STAGES * T::STAGE;
    if (next)
      dw_stage<BM, BN, FOLD>(next_slot, yr, x, g, y, a,
                             k_begin + (k + DW_STAGES - 1) * DW_BK, k_end, pr, pc, p, q, ci0,
                             co0);
    cp_async_commit();
    const float* xs = smem + (k % DW_STAGES) * T::STAGE;
    const float* gs = xs + DW_BK * BM;
    if (do_db && tid < BN) {
#pragma unroll
      for (int kk = 0; kk < DW_BK; ++kk) dbacc += gs[kk * BN + tid];
    }
#pragma unroll
    for (int kk = 0; kk < DW_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * BM + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(gs + kk * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(gs + kk * BN + BN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the next stage's gm pieces: no other thread reads its slot before the
    // barrier of stage k + 1, which publishes them
    if (FOLD && next) dw_put<BM, BN>(next_slot, yr, a);
  }
  cp_async_wait<0>();

  float* o = part + static_cast<long long>(split * a.n_k * a.n_k + tap) * a.Cin * a.Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = ci0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (ci >= a.Cin) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + h * (BN / 2) + tx * 4;
      float* dst = o + static_cast<long long>(ci) * a.Cout + co;
      if (a.vw && co + 3 < a.Cout) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < a.Cout) dst[e] = acc[i][4 * h + e];
      }
    }
  }
  if (do_db && tid < BN && co0 + tid < a.Cout)
    db_part[(static_cast<long long>(split) * 4 + ph) * a.Cout + co0 + tid] = dbacc;
}

// The poor layout (Cout <= 4, a GAN's output layer): a block takes one
// phase, one row tap p, 64 input channels and a range of phase-plane rows;
// a thread keeps the R column taps q of that row x 4 Cin x 4 Cout, so one
// gm pixel and a sliding window of R x pixels (float4s of 4 channels) serve
// R taps. DW_SLICES slices of 16 threads take the block's rows in turn and
// are added in slice order through shared memory at the end.
template <int R>
__global__ void __launch_bounds__(DW_THREADS)
dw_poor_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ y, float* __restrict__ part,
               float* __restrict__ db_part, const DwArgs a) {
  extern __shared__ __align__(16) float smem[];   // [slice][q, c, co][cg], db
  const int tid = threadIdx.x;
  const int cg = tid % 16;
  const int sl = tid / 16;
  const int ci = blockIdx.x * 64 + 4 * cg;
  const int ph = blockIdx.y / R;
  const int p = blockIdx.y % R;
  const int pr = ph >> 1;
  const int pc = ph & 1;
  const int s = a.wsel[ph];
  const int kh = 2 * p + (s >> 1);
  const int split = blockIdx.z;
  const int rows = a.B * a.Hp;
  const int r_begin = split * a.per_split;
  const int r_end = min(rows, r_begin + a.per_split);
  const bool db_block = a.with_db && p == 0 && blockIdx.x == 0;
  const int u_end = min(a.Hp, (a.M - pc + 1) / 2);   // ow = 2u + pc < M
  const int ncin = a.Cin - ci;                      // channels of this quad that exist
  const unsigned half = 0xffffu << (threadIdx.x & 16);   // the slice's 16 lanes

  float acc[R][4][4];
#pragma unroll
  for (int qq = 0; qq < R; ++qq)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int co = 0; co < 4; ++co) acc[qq][c][co] = 0.f;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};

  if (kh < a.n_k || db_block) {
    for (int r = r_begin + sl; r < r_end; r += DW_SLICES) {
      const int b = r / a.Hp;
      const int t = r - b * a.Hp;
      const int oh = 2 * t + pr;
      if (oh >= a.M) continue;
      const int ih = a.row0[pr] + t + p - a.pad_lo;
      const bool row_ok = kh < a.n_k && ih >= 0 && ih < a.N && ncin > 0;
      const float* xrow = x + ((static_cast<long long>(b) * a.N + (row_ok ? ih : 0)) * a.N) * a.Cin + ci;
      const long long grow = ((static_cast<long long>(b) * a.M + oh) * a.M + pc) * a.Cout;
      const int iw0 = a.col0[pc] - a.pad_lo;   // x column of (u, q) is iw0 + u + q
      auto pixel = [&](int iw) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row_ok && iw >= 0 && iw < a.N) {
          const float* src = xrow + static_cast<long long>(iw) * a.Cin;
          if (a.vx) {
            v = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            v.x = __ldg(src);
            if (ncin > 1) v.y = __ldg(src + 1);
            if (ncin > 2) v.z = __ldg(src + 2);
            if (ncin > 3) v.w = __ldg(src + 3);
          }
        }
        return v;
      };
      float4 win[R];
#pragma unroll
      for (int qq = 0; qq + 1 < R; ++qq) win[qq + 1] = pixel(iw0 + qq);
#pragma unroll 4
      for (int u = 0; u < u_end; ++u) {
#pragma unroll
        for (int qq = 0; qq + 1 < R; ++qq) win[qq] = win[qq + 1];
        win[R - 1] = pixel(iw0 + u + R - 1);
        const long long gp = grow + static_cast<long long>(2 * u) * a.Cout;
        // the slice's 16 lanes read the same gm pixel: lane cg < Cout loads
        // channel cg (and forms g * act'(y) where act' is folded) and the
        // slice takes the Cout channels by shuffles (zeros after)
        float mine = 0.f;
        if (cg < a.Cout) {
          mine = __ldg(g + gp + cg);
          if (a.act) mine = act_grad(mine, __ldg(y + gp + cg), a.act, a.slope);
        }
        float gv[4];
#pragma unroll
        for (int co = 0; co < 4; ++co) gv[co] = __shfl_sync(half, mine, co, 16);
#pragma unroll
        for (int qq = 0; qq < R; ++qq) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float xv = tconv::component(win[qq], c);
#pragma unroll
            for (int co = 0; co < 4; ++co) acc[qq][c][co] = fmaf(xv, gv[co], acc[qq][c][co]);
          }
        }
#pragma unroll
        for (int co = 0; co < 4; ++co) dbacc[co] += gv[co];
      }
    }
  }

  // the slices' sums, added in slice order
  constexpr int OUTS = R * 16;   // (q, c, co) a thread
  float* red = smem;
  float* red_db = smem + DW_SLICES * OUTS * 16;
#pragma unroll
  for (int o = 0; o < OUTS; ++o) red[(sl * OUTS + o) * 16 + cg] = (&acc[0][0][0])[o];
  if (cg == 0) {
#pragma unroll
    for (int co = 0; co < 4; ++co) red_db[sl * 4 + co] = dbacc[co];
  }
  __syncthreads();
  float* dst = part + static_cast<long long>(split) * a.n_k * a.n_k * a.Cin * a.Cout;
  for (int i = tid; i < OUTS * 16; i += DW_THREADS) {
    const int og = i / 16;          // (q, c, co)
    const int cgi = i % 16;
    const int qq = og / 16;
    const int c = og / 4 % 4;
    const int co = og % 4;
    const int kw = 2 * qq + (s & 1);
    const int cin = blockIdx.x * 64 + 4 * cgi + c;
    if (kh >= a.n_k || kw >= a.n_k || cin >= a.Cin || co >= a.Cout) continue;
    float v = 0.f;
    for (int z = 0; z < DW_SLICES; ++z) v += red[(z * OUTS + og) * 16 + cgi];
    dst[((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + cin) * a.Cout + co] = v;
  }
  if (db_block && tid < a.Cout) {
    float v = 0.f;
    for (int z = 0; z < DW_SLICES; ++z) v += red_db[z * 4 + tid];
    db_part[(static_cast<long long>(split) * 4 + ph) * a.Cout + tid] = v;
  }
}

template <int R>
constexpr int dw_poor_smem() { return 4 * (DW_SLICES * R * 16 * 16 + DW_SLICES * 4); }

// ----------------------------------------------------- split-K second pass

// out[i] = sum_{z < splits} part[z][i], z in order, for two outputs at once.
__global__ void sum_splits_kernel(const float* __restrict__ pa, float* __restrict__ oa,
                                  long long na, int sa,
                                  const float* __restrict__ pb, float* __restrict__ ob,
                                  long long nb, int sb) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < na + nb; i += stride) {
    float s = 0.f;
    if (i < na) {
      for (int z = 0; z < sa; ++z) s += pa[z * na + i];
      oa[i] = s;
    } else {
      const long long j = i - na;
      for (int z = 0; z < sb; ++z) s += pb[z * nb + j];
      ob[j] = s;
    }
  }
}

int grid_stride_blocks(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return static_cast<int>(want < 1 ? 1 : (want > 8 * 132 ? 8 * 132 : want));
}

// The Python geometry and the constants compiled here must describe the
// same kernel: tile, shared memory and grid are checked.
template <int BM, int BN>
cudaError_t launch_dw(const float* x, const float* g, const float* y, float* part,
                      float* db_part, const DwArgs& a, int n_blocks, int n_taps,
                      int splits, int smem_bytes, cudaStream_t stream) {
  using T = DwTile<BM, BN>;
  if (smem_bytes != T::SMEM || a.n_co_blocks != (a.Cout + BN - 1) / BN ||
      n_blocks != a.n_co_blocks * ((a.Cin + BM - 1) / BM) || n_taps != a.n_k * a.n_k ||
      a.per_split % DW_BK != 0)
    return cudaErrorInvalidValue;
  auto kernel = a.act ? dw_kernel<BM, BN, 1> : dw_kernel<BM, BN, 0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_blocks, n_taps, splits), DW_THREADS, smem_bytes, stream>>>(
      x, g, y, part, db_part, a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_dw_poor(const float* x, const float* g, const float* y, float* part,
                           float* db_part, const DwArgs& a, int n_blocks, int n_taps,
                           int splits, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes != dw_poor_smem<R>() || a.Cout > 4 || n_blocks != (a.Cin + 63) / 64 ||
      n_taps != 4 * R || (a.n_k + 1) / 2 != R)
    return cudaErrorInvalidValue;
  auto kernel = dw_poor_kernel<R>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_blocks, n_taps, splits), DW_THREADS, smem_bytes, stream>>>(
      x, g, y, part, db_part, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tconv_epilogue_grad_f32(const float* g, const float* y, float* out,
                                       long long n, int act, float slope, int blocks,
                                       void* stream) {
  epilogue_grad_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g, y, out, n, act, slope);
  return static_cast<int>(cudaGetLastError());
}

// layout: 0 rich (128 positions x 128 Cin a block, split contraction), 1
// poor (Cout <= 4: 32 groups of 8 positions x 32 Cin a block, R compiled).
// act 0: g is gm and y is not read; 1-3: gm = g * act'(y) as g is staged.
extern "C" int tconv_dx_f32(const float* g, const float* y, const float* w, float* out,
                            int B, int N, int Cin, int Cout, int n_k, int M, int R,
                            int roff0, int roff1, int coff0, int coff1,
                            int wsel0, int wsel1, int wsel2, int wsel3,
                            int layout, int tile_m, int tile_n, int n_blocks,
                            int n_ci_blocks, int splits, int cpt, int n_steps, int vg,
                            int vx, int smem_bytes, int act, float slope, void* stream) {
  DxArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M; a.R = R;
  a.roff[0] = roff0; a.roff[1] = roff1; a.coff[0] = coff0; a.coff[1] = coff1;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.cpt = cpt; a.n_steps = n_steps; a.splits = splits; a.vg = vg; a.vx = vx;
  a.gpr = (N + DXP_NP - 1) / DXP_NP;
  a.n_groups = B * N * a.gpr;
  a.act = act; a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 3) return static_cast<int>(cudaErrorInvalidValue);
  // the Python geometry and the constants compiled here must describe the
  // same kernel
  if (layout == 0) {
    if (tile_m != DX_BM || tile_n != DX_BN || smem_bytes != DX_SMEM ||
        n_blocks != (B * N * N + DX_BM - 1) / DX_BM ||
        n_ci_blocks != (Cin + DX_BN - 1) / DX_BN || cpt != (Cout + DX_BK - 1) / DX_BK ||
        n_steps != 4 * R * R * cpt || splits < 1 || splits > n_steps)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = act ? dx_kernel<1> : dx_kernel<0>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(n_blocks, n_ci_blocks, splits), DX_THREADS, smem_bytes, s>>>(g, y, w, out, a);
    return static_cast<int>(cudaGetLastError());
  }
  if (layout != 1 || tile_m != DXP_GROUPS * DXP_NP || tile_n != DXP_CT || Cout > 4 ||
      splits != 1 || n_blocks != (a.n_groups + DXP_GROUPS - 1) / DXP_GROUPS ||
      n_ci_blocks != (Cin + DXP_CT - 1) / DXP_CT || (n_k + 1) / 2 != R)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const float*, const float*, const float*, float*, const DxArgs) = nullptr;
  int want = 0;
  switch (R) {
    case 1: kernel = dx_poor_kernel<1>; want = dx_poor_smem<1>(); break;
    case 2: kernel = dx_poor_kernel<2>; want = dx_poor_smem<2>(); break;
    case 3: kernel = dx_poor_kernel<3>; want = dx_poor_smem<3>(); break;
    case 4: kernel = dx_poor_kernel<4>; want = dx_poor_smem<4>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(n_blocks, n_ci_blocks), DXP_THREADS, smem_bytes, s>>>(g, y, w, out, a);
  return static_cast<int>(cudaGetLastError());
}

// layout: 0 rich (tile_m x tile_n a block), 1 poor (Cout <= 4, 64 Cin a block).
// act 0: g is gm and y is not read; 1-3: gm = g * act'(y) as g is staged.
extern "C" int tconv_dw_f32(const float* x, const float* g, const float* y, float* part,
                            float* db_part, int B, int N, int Cin, int Cout, int n_k,
                            int M, int Hp, int pad_lo, int row00, int row01, int col00,
                            int col01, int ws0, int ws1, int ws2, int ws3,
                            int ps0, int ps1, int ps2, int ps3, int layout, int tile_m,
                            int tile_n, int n_blocks, int n_taps, int splits,
                            int per_split, int with_db, int vx, int vw, int smem_bytes,
                            int act, float slope, void* stream) {
  DwArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M; a.Hp = Hp;
  a.pad_lo = pad_lo;
  a.row0[0] = row00; a.row0[1] = row01; a.col0[0] = col00; a.col0[1] = col01;
  a.wsel[0] = ws0; a.wsel[1] = ws1; a.wsel[2] = ws2; a.wsel[3] = ws3;
  a.phase_of_sub[0] = ps0; a.phase_of_sub[1] = ps1;
  a.phase_of_sub[2] = ps2; a.phase_of_sub[3] = ps3;
  a.n_co_blocks = (Cout + tile_n - 1) / tile_n;
  a.per_split = per_split;
  a.with_db = with_db;
  a.vx = vx; a.vw = vw;
  a.act = act; a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (act < 0 || act > 3) return static_cast<int>(e);
  if (layout == 0 && tile_m == 128 && tile_n == 128)
    e = launch_dw<128, 128>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s);
  else if (layout == 0 && tile_m == 256 && tile_n == 64)
    e = launch_dw<256, 64>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s);
  else if (layout == 1 && tile_m == 64 && tile_n == 4) {
    switch ((n_k + 1) / 2) {
      case 1: e = launch_dw_poor<1>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s); break;
      case 2: e = launch_dw_poor<2>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s); break;
      case 3: e = launch_dw_poor<3>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s); break;
      case 4: e = launch_dw_poor<4>(x, g, y, part, db_part, a, n_blocks, n_taps, splits, smem_bytes, s); break;
      default: break;
    }
  }
  return static_cast<int>(e);
}

extern "C" int tconv_sum_splits_f32(const float* pa, float* oa, long long na, int sa,
                                    const float* pb, float* ob, long long nb, int sb,
                                    void* stream) {
  sum_splits_kernel<<<grid_stride_blocks(na + nb, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(pa, oa, na, sa, pb, ob, nb, sb);
  return static_cast<int>(cudaGetLastError());
}
