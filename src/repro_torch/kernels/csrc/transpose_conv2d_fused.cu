// Phase-fused unified transpose convolution, fp32, for sm_90a.
//
// Replaces: src/repro/kernels/transpose_conv2d.py::transpose_conv2d_pallas
// (the Pallas TPU kernel _fused_kernel).
//
// Computes out[b, 2t+pr, 2u+pc, c] = act(bias[c] + sum_{ci,p,q}
//   Ipad[b, base+t+pr*D+p, base+u+pc*D+q, ci] * S[wsel(pr,pc), p, q, ci, c])
// where Ipad is the NHWC input seen through a floor(P/2) zero border, D is
// 1 for an even P and 0 for an odd one (the two output parities of a row
// start D rows apart), and S is the (4, R, R, Cin, Cout) stack of the four
// segregated sub-kernels, read straight from the HWIO kernel:
// S[s, p, q] = K[2p + s/2, 2q + s%2], zero where that tap lies outside the
// n x n kernel. The geometry (origins, the odd-padding sub-kernel swap wsel,
// layout, tiles, Cin chunks and splits, shared memory) is computed in Python
// (transpose_conv2d.py::fused_geometry); the launcher checks that it agrees
// with the constants compiled here.
//
// What bounds it on the H100: the spatially large GAN layers do 2 GFLOP on
// ~10 MB (~200 FLOP/byte), far above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s (~20 FLOP/byte): fp32 FMA issue is the bound, and a SIMT kernel
// gets near it only if shared-memory loads, staging and idle SMs stay off
// the FMA pipe's critical path.
//
// What this design does about each:
// - Shared-memory loads per FMA. A thread holds a register micro-tile of
//   4 output parities x 4 consecutive positions of a phase-plane row x 4
//   output channels (64 fp32 accumulators). For each group of 4 staged
//   channels it walks the R + D input rows that its parities and row taps
//   touch; per row it loads a register patch of PW + R - 1 + D pixels (one
//   float4 = 4 channels each) once and reuses it for every (parity, row tap,
//   column tap, position). Each weight float4 (4 output channels of one
//   sub-kernel tap and channel) feeds 16 FMAs. At R = 2, D = 1 that is 1024
//   FMAs against 64 + 18 128-bit loads, 12.5 FMAs a load (the simple kernel
//   did 2.7). Tap, parity and position loops are unrolled against compile-
//   time R and D, so every load is an immediate offset from a few bases and
//   the patch stays in registers.
// - Staging. Cin runs in chunks through a 3-stage ring in shared memory
//   filled by cp.async: the chunk two ahead is in flight while the current
//   one is computed, with one __syncthreads a chunk. Weights come straight
//   from HWIO, one 16-byte copy for 4 output channels of a (kh, kw, ci) row;
//   the halo tile comes from NHWC, one 16-byte copy for 4 channels of a
//   pixel, into a [ci/4][row][col][4] layout whose odd row pitch keeps the
//   warp's patch loads free of bank conflicts. Borders, taps past an odd
//   kernel and ragged Cin/Cout are zero-filled by the copy's source size,
//   with no branch in the inner loop. The copies are issued by all threads
//   between the barrier and the FMAs, so their index math is kept short: a
//   thread's weight copies keep one (tap, 16-byte piece) and step the
//   channel, its input copies keep one channel group and step the pixel,
//   and nothing divides by a value that is not a compile-time constant.
//   A Cin (Cout) that is not a multiple of 4, or an operand not 16-byte
//   aligned, turns the input (weight) copies and the stores into 4-byte ones
//   at run time, inside the same kernel.
// - Stores. After the last chunk the micro-tiles go through shared memory
//   (the ring is free then), and the block writes its output tile along
//   contiguous (pixel, channel) runs: a thread's own outputs are 8 pixels
//   apart, which at Cout = 3 would cost a 32-byte sector for 12 bytes.
// - Warps. Two layouts, chosen by Cout alone:
//   "rich" (Cout > 4): 256 threads = 16 channel groups x 16 position groups
//   (a 64-channel x 8x8-position tile). A warp is 4 channel groups of 8
//   consecutive lanes x 8 position groups: a 128-bit shared load merges
//   only consecutive lanes that read one address, so a weight load is
//   served in one wavefront and a patch load in four;
//   "poor" (Cout <= 4: GAN output layers): 128 threads over positions only
//   (a 4-channel x 16x32-position tile; weight loads are broadcasts).
//   Where a layer's image holds too few blocks to fill the card, Cin is
//   split across blocks by a count fixed by the layer's shape alone; each
//   split writes its partial sums to scratch and the header's
//   reduce_splits_kernel adds them in split order, then applies bias and
//   activation.
// The copies and the micro-tile are tconv_microkernel.cuh's, which the pair
// kernel compiles too.
// Every output's sum runs over (split, chunk, channel group, p, q, channel
// in group) in an order fixed by the shape, never by the batch: no atomics,
// so a batched call gives each sample the bits of its own unbatched call.

#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace {

using tconv::activate;
using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;
using tconv::kPW;

constexpr int kStages = 3;   // cp.async ring depth

struct FusedArgs {
  int B, N, Cin, Cout, n_k, M;
  int org_r, org_c;   // input row/col of staged row/col 0 of the tile at (0, 0)
  int wsel[4];        // output parity (2*pr+pc) -> stacked sub-kernel
  int n_w;            // tiles along a phase-plane row
  int n_co;           // Cout tiles
  int splits;         // Cin splits (1: the epilogue runs here)
  int n_chunks;       // Cin chunks in all
  int vx, vw;         // 16-byte copies of the input / of weights and outputs
  int act;
  float slope;
};

// Compile-time shape of one variant: layout (NCG channel groups of 4 x NPG
// position groups of kPW, TW positions a tile row), Cin chunk CI, R, D.
template <int NCG, int NPG, int TW, int CI, int R, int D>
struct Tile {
  static constexpr int NT = NCG * NPG;
  static constexpr int CT = 4 * NCG;           // output channels a block
  static constexpr int PGR = TW / kPW;         // position groups a tile row
  static constexpr int TH = NPG / PGR;         // tile rows
  static constexpr int XH = TH + R - 1 + D;    // staged rows
  static constexpr int XWR = TW + R - 1 + D;   // staged columns
  static constexpr int XW = XWR | 1;           // their pitch: odd, no bank conflicts
  static constexpr int PC = kPW + R - 1 + D;   // register patch columns
  static constexpr int C4 = CI / 4;            // channel groups a chunk
  static constexpr int WROW = 4 * R * R;       // stacked taps (s, p, q)
  static constexpr int XS = C4 * XH * XW * 4;  // floats of a staged input chunk
  static constexpr int WS = CI * WROW * CT;    // floats of a staged weight chunk
  static constexpr int STAGE = XS + WS;
  // the output tile [2 TH][2 TW][CT] in shared memory after the loop: a
  // pixel pitch of CT + 4 and a skew of 4 floats for each 8 columns keep a
  // warp's float4 stores from piling onto the same banks
  static constexpr int OH = 2 * TH, OW = 2 * TW, OP = CT + 4;
  static constexpr int OUT = OH * OW * OP + 4 * ((OW - 1) >> 3);
  static constexpr int SMEM = 4 * (kStages * STAGE > OUT ? kStages * STAGE : OUT);
  static __device__ __forceinline__ int out_at(int r, int c) {
    return (r * OW + c) * OP + 4 * (c >> 3);
  }
  static_assert(TW % kPW == 0 && NPG % PGR == 0 && CI % 4 == 0, "layout");
};

// Issue this thread's copies of Cin chunk `chunk` into the ring slot at
// `xs`: the halo'd input tile, then the weights of all four sub-kernels.
template <int NCG, int NPG, int TW, int CI, int R, int D>
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ x,
                                      const float* __restrict__ w, const FusedArgs& a,
                                      int t0, int u0, int co0, int b, int chunk) {
  using T = Tile<NCG, NPG, TW, CI, R, D>;
  const int tid = threadIdx.x;
  float* ws = xs + T::XS;
  const int ci0 = chunk * CI;
  // the halo tile's copies i = tid, tid + NT, ... over (pixel, channel
  // group): a thread keeps one channel group and steps its pixel
  static_assert(T::NT % T::C4 == 0, "copy partition");
  constexpr int STEP = T::NT / T::C4;
  const int c4 = tid % T::C4;
  int r = tid / T::C4 / T::XWR;
  int c = tid / T::C4 % T::XWR;
  for (; r < T::XH; r += STEP / T::XWR, c += STEP % T::XWR) {
    if (c >= T::XWR) {
      c -= T::XWR;
      ++r;
      if (r >= T::XH) break;
    }
    const int gr = a.org_r + t0 + r;
    const int gc = a.org_c + u0 + c;
    const int gci = ci0 + 4 * c4;
    const bool in = gr >= 0 && gr < a.N && gc >= 0 && gc < a.N;
    const float* src = in
        ? x + ((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.Cin + gci
        : x;
    cp_quad(xs + ((c4 * T::XH + r) * T::XW + c) * 4, src, x, in ? a.Cin - gci : 0, a.vx);
  }
  constexpr int Q = T::WROW * NCG;   // 16-byte weight pieces a channel
  if constexpr (T::NT % Q == 0) {
    // each thread copies one (tap, piece) of every (NT / Q)-th channel
    constexpr int M = T::NT / Q;
    static_assert(CI % M == 0 || M % CI == 0, "copy partition");
    const int cq = tid % NCG;
    const int spq = tid / NCG % T::WROW;
    const int s = spq / (R * R);
    const int kh = 2 * (spq / R % R) + (s >> 1);
    const int kw = 2 * (spq % R) + (s & 1);
    const int gco = co0 + 4 * cq;
    const bool tap = kh < a.n_k && kw < a.n_k;
    const int ci = tid / Q;
    const float* src = w + ((static_cast<long long>(tap ? kh : 0) * a.n_k + (tap ? kw : 0))
                            * a.Cin + ci0 + ci) * a.Cout + gco;
    float* dst = ws + (ci * T::WROW + spq) * T::CT + 4 * cq;
    if (ci < CI) {   // NT / Q > CI leaves threads with nothing to copy
#pragma unroll
      for (int j = 0; j < (CI >= M ? CI / M : 1); ++j) {
        const bool in = tap && ci0 + ci + j * M < a.Cin;
        const float* sj = src + static_cast<long long>(j) * M * a.Cout;
        float* dj = dst + j * M * T::WROW * T::CT;
        cp_quad(dj, sj, w, in ? a.Cout - gco : 0, a.vw);
      }
    }
    return;
  }
  for (int i = tid; i < CI * T::WROW * NCG; i += T::NT) {
    const int cq = i % NCG;
    const int row = i / NCG;          // ci * WROW + (s * R + p) * R + q
    const int ci = row / T::WROW;
    const int spq = row % T::WROW;
    const int s = spq / (R * R);
    const int p = (spq / R) % R;
    const int q = spq % R;
    const int kh = 2 * p + (s >> 1);
    const int kw = 2 * q + (s & 1);
    const int gci = ci0 + ci;
    const int gco = co0 + 4 * cq;
    const bool tap = kh < a.n_k && kw < a.n_k && gci < a.Cin;
    const float* src = tap
        ? w + ((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + gci) * a.Cout + gco
        : w;
    cp_quad(ws + row * T::CT + 4 * cq, src, w, tap ? a.Cout - gco : 0, a.vw);
  }
}

template <int NCG, int NPG, int TW, int CI, int R, int D>
__global__ void __launch_bounds__(NCG * NPG, 1)
fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             float* __restrict__ part, const FusedArgs a) {
  using T = Tile<NCG, NPG, TW, CI, R, D>;
  constexpr int WCG = NCG < 4 ? NCG : 4;   // channel groups a warp
  constexpr int WPG = 32 / WCG;            // position groups a warp
  constexpr int CGW = NCG / WCG;           // warps side by side over channels
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // lanes of one channel group are consecutive (see the note at the top)
  const int cg = lane / WPG + WCG * (warp % CGW);
  const int pg = lane % WPG + WPG * (warp / CGW);
  const int tr = pg / T::PGR;              // tile row of this thread's positions
  const int tc = (pg % T::PGR) * kPW;      // tile column of the first

  const int t0 = (blockIdx.x / a.n_w) * T::TH;
  const int u0 = (blockIdx.x % a.n_w) * TW;
  const int split = blockIdx.y / a.n_co;
  const int co0 = (blockIdx.y % a.n_co) * T::CT;
  const int b = blockIdx.z;
  const int c_lo = split * a.n_chunks / a.splits;
  const int nk = (split + 1) * a.n_chunks / a.splits - c_lo;

  int woff[4];   // this thread's 4 channels of each parity's sub-kernel
#pragma unroll
  for (int par = 0; par < 4; ++par) woff[par] = a.wsel[par] * (R * R * T::CT) + 4 * cg;
  const int xoff = (tr * T::XW + tc) * 4;

  float acc[4][kPW][4];
#pragma unroll
  for (int par = 0; par < 4; ++par)
#pragma unroll
    for (int j = 0; j < kPW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[par][j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      stage<NCG, NPG, TW, CI, R, D>(smem + s * T::STAGE, x, w, a, t0, u0, co0, b,
                                    c_lo + s);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk k landed
    __syncthreads();                // everyone's did; chunk k - 1 is consumed
    if (k + kStages - 1 < nk)
      stage<NCG, NPG, TW, CI, R, D>(smem + (k + kStages - 1) % kStages * T::STAGE,
                                    x, w, a, t0, u0, co0, b, c_lo + k + kStages - 1);
    cp_async_commit();

    const float* xs = smem + (k % kStages) * T::STAGE;
    const float* ws = xs + T::XS;
#pragma unroll 1
    for (int c4 = 0; c4 < T::C4; ++c4)
      tconv::mac_c4<R, D>(xs + c4 * (T::XH * T::XW * 4) + xoff, T::XW,
                          ws + c4 * (4 * T::WROW * T::CT), T::WROW * T::CT, T::CT,
                          woff, acc);
  }

  // The block's outputs go through shared memory (the ring is free now), so
  // the global stores run along contiguous (pixel, channel) rows.
  __syncthreads();
#pragma unroll
  for (int par = 0; par < 4; ++par) {
#pragma unroll
    for (int j = 0; j < kPW; ++j) {
      const int oc = 2 * (tc + j) + (par & 1);
      *reinterpret_cast<float4*>(smem + T::out_at(2 * tr + (par >> 1), oc) + 4 * cg) =
          make_float4(acc[par][j][0], acc[par][j][1], acc[par][j][2], acc[par][j][3]);
    }
  }
  __syncthreads();
  const bool partial = a.splits > 1;
  float* dst = partial
      ? part + static_cast<long long>(split) * a.B * a.M * a.M * a.Cout
      : out;
  const int oh0 = 2 * t0;
  const int ow0 = 2 * u0;
  // i runs over (tile row, tile column, channel quad), the quad fastest
  for (int i = tid; i < T::OH * T::OW * NCG; i += T::NT) {
    const int cq = i % NCG;
    const int oc = i / NCG % T::OW;
    const int orow = i / NCG / T::OW;
    const int co = co0 + 4 * cq;
    if (oh0 + orow >= a.M || ow0 + oc >= a.M || co >= a.Cout) continue;
    float4 v = *reinterpret_cast<const float4*>(smem + T::out_at(orow, oc) + 4 * cq);
    float* o = dst + ((static_cast<long long>(b) * a.M + oh0 + orow) * a.M + ow0 + oc)
                     * a.Cout + co;
    if (!partial) {
      const int nb = a.Cout - co;   // channels of this quad that exist
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
    if (a.vw) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      if (co + 1 < a.Cout) o[1] = v.y;
      if (co + 2 < a.Cout) o[2] = v.z;
      if (co + 3 < a.Cout) o[3] = v.w;
    }
  }
}

// The two layouts and their Cin chunks.
constexpr int layout_ncg(int L) { return L == 0 ? 16 : 1; }
constexpr int layout_npg(int L) { return L == 0 ? 16 : 128; }
constexpr int layout_tw(int L) { return L == 0 ? 8 : 32; }
constexpr int layout_ci(int L, int R) { return L == 0 && R > 2 ? 4 : 8; }

struct Launch {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  float* part;
  FusedArgs a;
  int th, tw, ci, n_h, smem_bytes;
  cudaStream_t stream;
};

template <int L, int R, int D>
cudaError_t launch(const Launch& l) {
  constexpr int NCG = layout_ncg(L), NPG = layout_npg(L), TW = layout_tw(L);
  constexpr int CI = layout_ci(L, R);
  using T = Tile<NCG, NPG, TW, CI, R, D>;
  // the Python geometry and these constants must describe the same kernel
  if (l.th != T::TH || l.tw != TW || l.ci != CI ||
      l.smem_bytes != T::SMEM || l.a.splits < 1 ||
      l.a.splits > l.a.n_chunks || (l.a.splits > 1) != (l.part != nullptr))
    return cudaErrorInvalidValue;
  auto kernel = fused_kernel<NCG, NPG, TW, CI, R, D>;
  if (l.smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_bytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(l.n_h * l.a.n_w, l.a.splits * l.a.n_co, l.a.B);
  kernel<<<grid, T::NT, l.smem_bytes, l.stream>>>(l.x, l.w, l.bias, l.out, l.part, l.a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || l.a.splits == 1) return e;
  const long long total = static_cast<long long>(l.a.B) * l.a.M * l.a.M * l.a.Cout;
  return tconv::reduce_splits(l.part, l.bias, l.out, total, l.a.Cout, l.a.splits,
                              l.a.act, l.a.slope, l.stream);
}

template <int L, int R>
cudaError_t by_d(int d, const Launch& l) {
  switch (d) {
    case 0: return launch<L, R, 0>(l);
    case 1: return launch<L, R, 1>(l);
    default: return cudaErrorInvalidValue;
  }
}

template <int L>
cudaError_t by_r(int r, int d, const Launch& l) {
  switch (r) {
    case 1: return by_d<L, 1>(d, l);
    case 2: return by_d<L, 2>(d, l);
    case 3: return by_d<L, 3>(d, l);
    case 4: return by_d<L, 4>(d, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tconv_fused_f32(
    const float* x, const float* w, const float* bias, float* out, float* part,
    int B, int N, int Cin, int Cout, int n_k, int M, int R, int D,
    int org_r, int org_c, int wsel0, int wsel1, int wsel2, int wsel3,
    int layout, int vx, int vw, int th, int tw, int ci, int n_h, int n_w, int n_co,
    int splits, int n_chunks, int act, float slope, int smem_bytes, void* stream) {
  Launch l;
  l.x = x; l.w = w; l.bias = bias; l.out = out; l.part = part;
  FusedArgs& a = l.a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M;
  a.org_r = org_r; a.org_c = org_c;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.n_w = n_w; a.n_co = n_co; a.splits = splits; a.n_chunks = n_chunks;
  a.vx = vx; a.vw = vw;
  a.act = act; a.slope = slope;
  l.th = th; l.tw = tw; l.ci = ci; l.n_h = n_h; l.smem_bytes = smem_bytes;
  l.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (layout) {
    case 0: e = by_r<0>(R, D, l); break;
    case 1: e = by_r<1>(R, D, l); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
