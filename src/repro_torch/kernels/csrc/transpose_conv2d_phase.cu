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
// geometry (phase origins, the odd-padding sub-kernel swap, layout, tiles,
// chunks, splits, shared memory) is computed in Python
// (transpose_conv2d.py::phase_geometry); the launcher checks that it agrees
// with the constants compiled here.
//
// What bounds it on the H100: fp32 FMA issue, as for the fused kernel (the
// same operations on the same bytes; ~200 FLOP/byte at the DCGAN layers
// against a ridge of ~20).
//
// The design is the fused kernel's machinery with only the unification taken
// out, so that the fused kernel over this one measures the paper's mechanism:
// - One parity a block. A block computes one output parity of a phase-plane
//   tile (blockIdx.z = 4 * batch item + parity). It stages only that
//   parity's halo'd input window, from the parity's own origin, and only its
//   sub-kernel (wsel[parity], the odd-padding swap included). The four
//   parities of an output tile stage four overlapping windows: that
//   redundant staging is the cost the unified kernel removes, and it stays.
// - Shared-memory loads per FMA. A thread keeps tconv_microkernel.cuh's
//   single-parity micro-tile (mac_p1): 4 phase-plane rows x 4 positions x 4
//   output channels, 64 fp32 accumulators; 18.3 FMAs a 128-bit shared load
//   at R = 2 (the fused micro-tile does 12.5, the simple kernel did 2.7).
// - Staging. Cin runs in chunks through a 3-stage cp.async ring, straight
//   from NHWC and HWIO with the fused kernel's copies (tconv::cp_quad:
//   16-byte, or 4-byte chosen at run time for a ragged or unaligned channel
//   run, borders zero-filled by the source size), one __syncthreads a
//   chunk. Weights keep HWIO's Cout-innermost order. A thread's copies keep
//   one channel group (input) or one 16-byte piece (weights) and step the
//   rest; every divisor is a compile-time constant.
// - Warps. Two layouts, chosen by Cout alone:
//   "rich" (Cout > 4): 128 threads; a warp's 32 lanes are 32 channel groups
//   (128 output channels), so a weight load is 512 contiguous bytes and a
//   patch load a broadcast. The 4 warps take 2 x 2 position groups (an 8 x 8
//   tile, ks = 1), or, where the phase plane is at most 4 x 4 (DCGAN L0),
//   the same 4 x 4 positions and a quarter each of every Cin chunk (ks = 4),
//   summed in warp order after the loop: no warp idles on a small plane.
//   "poor" (Cout <= 4): 64 threads over positions only (4 channels x 32 x 32
//   positions; weight loads are broadcasts, patch loads conflict-free
//   through the window's column skew).
// - Small planes. Where a layer holds too few blocks to fill the card, Cin
//   is split across blocks by a count fixed by the layer's shape alone; each
//   split writes its partial sums to scratch and the header's
//   reduce_splits_kernel adds them in split order, then applies bias and
//   activation.
// - Stores. After the last chunk the micro-tiles go through shared memory
//   (the ring is free then), and the block writes its parity's pixels along
//   contiguous (pixel, channel) runs.
// Every output's sum runs over (split, chunk, warp slice, channel group,
// p, q, channel in group) in an order fixed by the shape, never by the
// batch: no atomics, so a batched call gives each sample the bits of its own
// unbatched call.

#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace {

using tconv::activate;
using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;
using tconv::kPH;
using tconv::kPW;
using tconv::skew;

constexpr int kStages = 3;   // cp.async ring depth

struct PhaseArgs {
  int B, N, Cin, Cout, n_k, M;
  int org_r[2], org_c[2];   // input row/col of staged row/col 0 of tile (0, 0), by parity
  int wsel[4];              // output parity (2*pr+pc) -> stacked sub-kernel
  int n_w;                  // tiles along a phase-plane row
  int n_co;                 // Cout tiles
  int splits;               // Cin splits (1: the epilogue runs here)
  int n_chunks;             // Cin chunks in all
  int vx, vw;               // 16-byte copies of the input / of weights and outputs
  int act;
  float slope;
};

// Compile-time shape of one instance: layout L (0 rich, 1 poor), R, and KS
// warp slices of each Cin chunk.
template <int L, int R, int KS>
struct Tile {
  static constexpr int NT = L == 0 ? 128 : 64;
  static constexpr int NCG = L == 0 ? 32 : 1;      // channel groups of 4
  static constexpr int CT = 4 * NCG;               // output channels a block
  static constexpr int NPG = NT / NCG / KS;        // position groups
  static constexpr int PGW = L == 0 ? (KS == 1 ? 2 : 1) : 8;   // ... a tile row
  static constexpr int TW = kPW * PGW;             // tile columns
  static constexpr int TH = kPH * (NPG / PGW);     // tile rows
  static constexpr int CI = L == 1 ? 4 : KS == 4 ? 16 : R <= 2 ? 8 : 4;   // Cin chunk
  static constexpr int C4 = CI / 4;
  static constexpr int XH = TH + R - 1;            // staged rows
  static constexpr int XW = TW + R - 1;            // staged columns
  static constexpr int XP = skew(XW - 1) + 1;      // their pitch, skewed
  static constexpr int XS = C4 * XH * XP * 4;      // floats of a staged input chunk
  static constexpr int WS = CI * R * R * CT;       // floats of a staged weight chunk
  static constexpr int STAGE = XS + WS;
  // the output tile [KS][TH][TW][CT] after the loop, columns skewed
  static constexpr int OWP = skew(TW - 1) + 1;
  static constexpr int OUT = KS * TH * OWP * CT;
  static constexpr int SMEM = 4 * (kStages * STAGE > OUT ? kStages * STAGE : OUT);
  static __device__ __forceinline__ int out_at(int slice, int r, int c) {
    return ((slice * TH + r) * OWP + skew(c)) * CT;
  }
  static_assert(NPG % PGW == 0 && C4 % KS == 0 && NT % C4 == 0, "layout");
  static_assert(NT % NCG == 0 && (L == 0 || KS == 1), "layout");
};

// Issue this thread's copies of Cin chunk `chunk` into the ring slot at
// `xs`: the parity's halo'd input window, then its one sub-kernel's weights.
template <int L, int R, int KS>
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ x,
                                      const float* __restrict__ w, const PhaseArgs& a,
                                      int gr0, int gc0, int s, int co0, int b, int chunk) {
  using T = Tile<L, R, KS>;
  const int tid = threadIdx.x;
  float* ws = xs + T::XS;
  const int ci0 = chunk * T::CI;
  // the window's copies over (pixel, channel group): a thread keeps one
  // channel group and steps its pixel
  constexpr int STEP = T::NT / T::C4;
  const int c4 = tid % T::C4;
  int r = tid / T::C4 / T::XW;
  int c = tid / T::C4 % T::XW;
  const int gci = ci0 + 4 * c4;
  for (; r < T::XH; r += STEP / T::XW, c += STEP % T::XW) {
    if (c >= T::XW) {
      c -= T::XW;
      ++r;
      if (r >= T::XH) break;
    }
    const int gr = gr0 + r;
    const int gc = gc0 + c;
    const bool in = gr >= 0 && gr < a.N && gc >= 0 && gc < a.N;
    const float* src = in
        ? x + ((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.Cin + gci
        : x;
    cp_quad(xs + ((c4 * T::XH + r) * T::XP + skew(c)) * 4, src, x, in ? a.Cin - gci : 0,
            a.vx);
  }
  // the weights [ci][p][q][CT]: a thread keeps one 16-byte piece of a row
  // and steps the row
  const int cq = tid % T::NCG;
  const int gco = co0 + 4 * cq;
  for (int row = tid / T::NCG; row < T::CI * R * R; row += T::NT / T::NCG) {
    const int ci = row / (R * R);
    const int p = row / R % R;
    const int q = row % R;
    const int kh = 2 * p + (s >> 1);
    const int kw = 2 * q + (s & 1);
    const bool in = kh < a.n_k && kw < a.n_k && ci0 + ci < a.Cin;
    const float* src = in
        ? w + ((static_cast<long long>(kh) * a.n_k + kw) * a.Cin + ci0 + ci) * a.Cout + gco
        : w;
    cp_quad(ws + row * T::CT + 4 * cq, src, w, in ? a.Cout - gco : 0, a.vw);
  }
}

template <int L, int R, int KS>
__global__ void __launch_bounds__(Tile<L, R, KS>::NT)
phase_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             float* __restrict__ part, const PhaseArgs a) {
  using T = Tile<L, R, KS>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int cg = tid % T::NCG;
  const int ksl = tid / T::NCG % KS;        // this warp's slice of each chunk
  const int pg = tid / T::NCG / KS;
  const int pgr = pg / T::PGW;
  const int pgc = pg % T::PGW;

  const int t0 = (blockIdx.x / a.n_w) * T::TH;
  const int u0 = (blockIdx.x % a.n_w) * T::TW;
  const int split = blockIdx.y / a.n_co;
  const int co0 = (blockIdx.y % a.n_co) * T::CT;
  const int b = blockIdx.z >> 2;
  const int par = blockIdx.z & 3;
  const int pr = par >> 1;
  const int pc = par & 1;
  // selects, not indexes: an argument array indexed at run time would be
  // copied to the stack
  const int s = par == 0 ? a.wsel[0] : par == 1 ? a.wsel[1] : par == 2 ? a.wsel[2] : a.wsel[3];
  const int gr0 = (pr ? a.org_r[1] : a.org_r[0]) + t0;
  const int gc0 = (pc ? a.org_c[1] : a.org_c[0]) + u0;
  const int c_lo = split * a.n_chunks / a.splits;
  const int nk = (split + 1) * a.n_chunks / a.splits - c_lo;
  const int hp = (a.M + 1) >> 1;
  // a position group wholly off the phase plane adds nothing
  const bool live = t0 + kPH * pgr < hp && u0 + kPW * pgc < hp;
  const int xoff = (kPH * pgr * T::XP + skew(kPW * pgc)) * 4;

  float acc[kPH][kPW][4];
#pragma unroll
  for (int i = 0; i < kPH; ++i)
#pragma unroll
    for (int j = 0; j < kPW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      stage<L, R, KS>(smem + st * T::STAGE, x, w, a, gr0, gc0, s, co0, b, c_lo + st);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk k landed
    __syncthreads();                // everyone's did; chunk k - 1 is consumed
    if (k + kStages - 1 < nk)
      stage<L, R, KS>(smem + (k + kStages - 1) % kStages * T::STAGE, x, w, a, gr0, gc0,
                      s, co0, b, c_lo + k + kStages - 1);
    cp_async_commit();

    const float* xs = smem + (k % kStages) * T::STAGE;
    const float* ws = xs + T::XS;
    if (live) {
#pragma unroll 1
      for (int c4 = ksl; c4 < T::C4; c4 += KS)
        tconv::mac_p1<R>(xs + c4 * (T::XH * T::XP * 4) + xoff, T::XP,
                         ws + c4 * (4 * R * R * T::CT) + 4 * cg, R * R * T::CT, T::CT,
                         acc);
    }
  }

  // The micro-tiles go through shared memory (the ring is free now), one
  // slice a warp slice, so the stores run along contiguous (pixel, channel)
  // rows and the slices add in order.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPH; ++i)
#pragma unroll
    for (int j = 0; j < kPW; ++j)
      *reinterpret_cast<float4*>(smem + T::out_at(ksl, kPH * pgr + i, kPW * pgc + j) +
                                 4 * cg) =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  __syncthreads();
  const bool partial = a.splits > 1;
  float* dst = partial
      ? part + static_cast<long long>(split) * a.B * a.M * a.M * a.Cout
      : out;
  // i runs over (tile row, tile column, channel quad), the quad fastest
  for (int i = tid; i < T::TH * T::TW * T::NCG; i += T::NT) {
    const int cq = i % T::NCG;
    const int oc = i / T::NCG % T::TW;
    const int orow = i / T::NCG / T::TW;
    const int oh = 2 * (t0 + orow) + pr;
    const int ow = 2 * (u0 + oc) + pc;
    const int co = co0 + 4 * cq;
    if (oh >= a.M || ow >= a.M || co >= a.Cout) continue;
    float4 v = *reinterpret_cast<const float4*>(smem + T::out_at(0, orow, oc) + 4 * cq);
#pragma unroll
    for (int sl = 1; sl < KS; ++sl) {
      const float4 u = *reinterpret_cast<const float4*>(smem + T::out_at(sl, orow, oc) +
                                                        4 * cq);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    float* o = dst + ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout + co;
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

struct Launch {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  float* part;
  PhaseArgs a;
  int th, tw, ci, n_h, smem_bytes;
  cudaStream_t stream;
};

template <int L, int R, int KS>
cudaError_t launch(const Launch& l) {
  using T = Tile<L, R, KS>;
  // the Python geometry and these constants must describe the same kernel
  if (l.th != T::TH || l.tw != T::TW || l.ci != T::CI || l.smem_bytes != T::SMEM ||
      l.a.splits < 1 || l.a.splits > l.a.n_chunks ||
      (l.a.splits > 1) != (l.part != nullptr))
    return cudaErrorInvalidValue;
  auto kernel = phase_kernel<L, R, KS>;
  // several blocks an SM need the largest shared-memory carveout
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       l.smem_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(l.n_h * l.a.n_w, l.a.splits * l.a.n_co, 4 * l.a.B);
  kernel<<<grid, T::NT, l.smem_bytes, l.stream>>>(l.x, l.w, l.bias, l.out, l.part, l.a);
  e = cudaGetLastError();
  if (e != cudaSuccess || l.a.splits == 1) return e;
  const long long total = static_cast<long long>(l.a.B) * l.a.M * l.a.M * l.a.Cout;
  return tconv::reduce_splits(l.part, l.bias, l.out, total, l.a.Cout, l.a.splits,
                              l.a.act, l.a.slope, l.stream);
}

// The compiled instances (layout, R, ks): rich R = 1..4 with ks = 1, rich
// R = 1, 2 with ks = 4, poor R = 1..4 (transpose_conv2d.phase_variants).
cudaError_t dispatch(int layout, int r, int ks, const Launch& l) {
  if (layout == 0 && ks == 1) {
    switch (r) {
      case 1: return launch<0, 1, 1>(l);
      case 2: return launch<0, 2, 1>(l);
      case 3: return launch<0, 3, 1>(l);
      case 4: return launch<0, 4, 1>(l);
    }
  } else if (layout == 0 && ks == 4) {
    switch (r) {
      case 1: return launch<0, 1, 4>(l);
      case 2: return launch<0, 2, 4>(l);
    }
  } else if (layout == 1 && ks == 1) {
    switch (r) {
      case 1: return launch<1, 1, 1>(l);
      case 2: return launch<1, 2, 1>(l);
      case 3: return launch<1, 3, 1>(l);
      case 4: return launch<1, 4, 1>(l);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tconv_phase_f32(
    const float* x, const float* w, const float* bias, float* out, float* part,
    int B, int N, int Cin, int Cout, int n_k, int M, int R,
    int org_r0, int org_r1, int org_c0, int org_c1,
    int wsel0, int wsel1, int wsel2, int wsel3,
    int layout, int ks, int vx, int vw, int th, int tw, int ci, int n_h, int n_w,
    int n_co, int splits, int n_chunks, int act, float slope, int smem_bytes,
    void* stream) {
  Launch l;
  l.x = x; l.w = w; l.bias = bias; l.out = out; l.part = part;
  PhaseArgs& a = l.a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M;
  a.org_r[0] = org_r0; a.org_r[1] = org_r1; a.org_c[0] = org_c0; a.org_c[1] = org_c1;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.n_w = n_w; a.n_co = n_co; a.splits = splits; a.n_chunks = n_chunks;
  a.vx = vx; a.vw = vw;
  a.act = act; a.slope = slope;
  l.th = th; l.tw = tw; l.ci = ci; l.n_h = n_h; l.smem_bytes = smem_bytes;
  l.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(layout, R, ks, l));
}
