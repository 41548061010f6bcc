// Two stacked stride-2 transpose-conv layers in one launch, fp32, for sm_90a;
// the interface between them never leaves the chip.
//
// Replaces: src/repro/kernels/transpose_conv2d_pair.py::transpose_conv2d_pair_pallas
// (the Pallas TPU kernel _pair_kernel, grid (batch, cout2, mid, cin), whose
// interface is a VMEM scratch slab summed over sequential cin steps).
//
// Computes out = act2(tconv(pad2(crop_M1(act1(tconv(x, k1) + b1))), k2) + b2):
// the producer's interleaved output is cropped to M1 x M1, re-padded by the
// consumer's zero halo, and read by the consumer's four phases. Each tconv is
// the unified kernel-segregated form of transpose_conv2d_fused.cu, sub-kernels
// read straight from the HWIO kernels. All geometry (phase origins, the
// odd-padding swap, the cluster partition, tiles, ring, shared memory) comes
// from Python (transpose_conv2d_pair.py::pair_launch_geometry); the launcher
// checks it against the constants compiled here.
//
// What bounds it on the H100: fp32 arithmetic. The pair does both layers'
// operations on fewer bytes than the two layers apart: the fp32 interface
// round trip it removes is 2 MiB (DCGAN head pair) or 4 MiB (tail pair) at
// batch 8, under 2 us at 3.35 TB/s, against 64 us and 34 us of fp32 work.
// So the pair saves launches and device memory, not bandwidth, and it wins
// only if its FMA stream runs as densely as the layers' own kernels.
//
// Design. A batch item's interface (8x8x512 fp32 = 128 KiB for the DCGAN
// head pair, 32x32x128 = 512 KiB for the tail) does not fit one block's
// 227 KB of shared memory, but it fits a thread-block cluster. One cluster of
// CL <= 16 blocks runs each batch item (16 is a non-portable size: an H100
// runs 7 such clusters at once, so batch 8 takes two waves):
//   1. producer: block `rank` owns interface channel quads [g*qpr, g*qpr +
//      qpr), g = rank / n_bands, over the band of padded interface rows
//      [r0, r0 + rpb), r0 = (rank % n_bands) * rpb: the whole plane (one
//      band) where C1 holds at least 16 quads, else the cluster's spare
//      blocks split the rows. It computes them tile by tile, applies bias1
//      and act1 on the fp32 sums, and writes them into its own shared
//      memory, laid out [quad][rpb][s2][4] with the consumer's zero halo
//      already in place.
//   2. cluster barrier.
//   3. consumer: the blocks share the output's (phase-plane tile, C2 tile)
//      work tiles round-robin. A ring stage stages the tile's interface
//      window for 4*ks2 channels from their owners' shared memory (128-bit
//      distributed-shared-memory loads, eight in flight a thread) beside the
//      matching k2 chunk; bias2 and act2 are applied before one store.
//   4. cluster barrier, so no block leaves while another still reads it.
// The interface is never a tensor in device memory.
//
// Both phases run tconv_microkernel.cuh's register micro-tile, the fused
// kernel's: a thread owns 4 parities x 4 positions of a phase-plane row x 4
// channels (64 accumulators) and feeds 16 FMAs from each 128-bit weight
// load. A tile of a phase is ncg channel quads x th x tw positions; where it
// holds fewer than 256 micro-tiles (the DCGAN head's 4x4 producer plane
// holds 4 rows of 4 positions, so 32 channels make 32 micro-tiles), the
// contraction is split ks <= 16 ways inside the block: a ring stage holds
// 4*ks input channels and split s contracts quad s of each stage. (A tile
// of fewer than 16 micro-tiles, on a small plane with a large kernel,
// leaves threads idle; they still copy.) At the tile's
// end the ks partial sums meet in shared memory and are added in split
// order. Cin streams through a cp.async ring of `ring` (3, or 2 where 3 do
// not fit beside the interface) stages with one barrier a stage: the
// producer's input window comes from NHWC and every weight chunk from HWIO
// in 16-byte copies (4-byte ones where a channel count is ragged or a row
// unaligned), zero-filled past borders, taps and channels. Staged weights
// are [ci][tap][4 ncg], HWIO's order, so consecutive threads' copies fill
// contiguous shared memory (a scattered destination cut cp.async's rate
// threefold); staged windows are [quad][row][col][4] at an odd pitch.
//
// There are no atomics: every interface and output element is summed by one
// fixed sequence (ring stage, split quad, row tap, column tap, channel, then
// the splits in order), and the partition depends on the pair's shape alone,
// so a sample's bits do not depend on the batch it is served in.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tconv_microkernel.cuh"

namespace cg = cooperative_groups;

namespace {

using tconv::activate;
using tconv::cp_async_commit;
using tconv::cp_async_wait;
using tconv::cp_quad;
using tconv::kPW;

constexpr int kThreads = 256;
constexpr int kMicro = 4 * kPW * 4;          // accumulators a thread
constexpr int kRedFloats = kThreads * kMicro;
constexpr int kPrefetch = 2;                 // interface pieces a thread holds across FMAs
constexpr int kRemoteBatch = 8;              // interface loads in flight a thread

// The order of these fields is the order of the int array the host passes
// (transpose_conv2d_pair.py::_GEOMETRY_FIELDS, then the copy widths and
// the two activation codes).
struct PairArgs {
  int B, N, C0, C1, C2, n_k, M1, M2;
  int cl, qpr;              // cluster blocks; interface channel quads a block
  int n_bands, rpb;         // interface row bands; padded rows a band
  int wsel[4];              // output parity -> stacked sub-kernel (both layers)
  // producer
  int org1r, org1c;         // input row / col of staged row / col 0 at tile (0, 0)
  int hp1, th1, tw1, n_w1, ncg1, ks1, nct1, xh1, xwr1, xp1, nst1;
  // interface and consumer
  int s2, pad_lo2;          // padded interface extent; its zero border
  int b0r, b0c;             // first padded-interface row / col read
  int hp2, th2, tw2, n_w2, n_sp2, ncg2, ks2, n_co2, xh2, xwr2, xp2, nst2;
  int ring;                 // cp.async ring depth (2 or 3)
  int vx, vw1, vw2;         // 16-byte copies of x, k1, k2
  int act1, act2;
};
constexpr int kArgInts = sizeof(PairArgs) / sizeof(int);

// n / d by a multiply: exact for n * d < 2^32 (here n and d stay below
// 2^16), set up once a tile; the copies of every ring stage index their
// pieces with it instead of a division by a run-time value.
struct FastDiv {
  unsigned m;
  int d;
  __device__ __forceinline__ explicit FastDiv(int d_)
      : m(d_ > 1 ? 0xffffffffu / static_cast<unsigned>(d_) + 1u : 0u), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return m ? static_cast<int>(__umulhi(static_cast<unsigned>(n), m)) : n;
  }
};

// One phase's tile, as the device walks it.
struct Phase {
  int cin, cout;            // contraction channels; the layer's output channels
  int th, tw, ncg, ks, xh, xwr, xp, nst;
  int stage_x;              // floats of a stage's input window
  int stage;                // floats of a ring stage
};

template <int R, int D>
__device__ __forceinline__ Phase make_phase(int cin, int cout, int th, int tw, int ncg,
                                            int ks, int xh, int xwr, int xp, int nst) {
  Phase f;
  f.cin = cin; f.cout = cout; f.th = th; f.tw = tw;
  f.ncg = ncg; f.ks = ks; f.xh = xh; f.xwr = xwr; f.xp = xp; f.nst = nst;
  f.stage_x = ks * xh * xp * 4;
  f.stage = f.stage_x + 4 * ks * 4 * R * R * 4 * ncg;
  return f;
}

// Stage the weight chunk of ring stage `st` for output channels [co0, co0 +
// 4 ncg): HWIO rows ci of [4 ks st, 4 ks (st + 1)), every stacked tap
// (s, p, q), into ws[ci][tap][4 ncg]; consecutive threads copy consecutive
// 16-byte pieces of a row. Taps past an odd kernel and ragged channels are
// zero-filled.
template <int R>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w,
                                              const Phase& f, int n_k, int co0, int st,
                                              bool vec) {
  constexpr int WROW = 4 * R * R;
  const int ci_n = 4 * f.ks;
  const int ci0 = st * ci_n;
  const int ct = 4 * f.ncg;
  const int tid = threadIdx.x;
  const int lg_ncg = __ffs(f.ncg) - 1;          // ncg is a power of two
  const int pieces_a_ci = f.ncg * WROW;
  if ((WROW & (WROW - 1)) == 0 && pieces_a_ci <= kThreads) {
    // each thread copies one (tap, quad) of every M-th channel
    const int lg_pieces = lg_ncg + __ffs(WROW) - 1;
    const int m = kThreads >> lg_pieces;
    const int cq = tid & (f.ncg - 1);
    const int spq = (tid >> lg_ncg) & (WROW - 1);
    const int s = spq / (R * R);
    const int kh = 2 * (spq / R % R) + (s >> 1);
    const int kw = 2 * (spq % R) + (s & 1);
    const bool tap = kh < n_k && kw < n_k;
    const int gco = co0 + 4 * cq;
    const int n_co = tap ? f.cout - gco : 0;
    int ci = tid >> lg_pieces;
    const float* src = w + ((static_cast<long long>(tap ? kh : 0) * n_k + (tap ? kw : 0))
                            * f.cin + ci0 + ci) * f.cout + gco;
    float* dst = ws + (ci * WROW + spq) * ct + 4 * cq;
    for (; ci < ci_n; ci += m) {
      cp_quad(dst, src, w, ci0 + ci < f.cin ? n_co : 0, vec);
      src += static_cast<long long>(m) * f.cout;
      dst += m * WROW * ct;
    }
    return;
  }
  for (int i = tid; i < pieces_a_ci * ci_n; i += kThreads) {
    const int cq = i & (f.ncg - 1);
    const int row = i >> lg_ncg;   // ci * WROW + spq
    const int ci = row / WROW;
    const int spq = row % WROW;
    const int s = spq / (R * R);
    const int kh = 2 * (spq / R % R) + (s >> 1);
    const int kw = 2 * (spq % R) + (s & 1);
    const int gci = ci0 + ci;
    const int gco = co0 + 4 * cq;
    const bool in = kh < n_k && kw < n_k && gci < f.cin;
    const float* src = in
        ? w + ((static_cast<long long>(kh) * n_k + kw) * f.cin + gci) * f.cout + gco
        : w;
    cp_quad(ws + row * ct + 4 * cq, src, w, in ? f.cout - gco : 0, vec);
  }
}

// One tile of a phase: the ring over the contraction, the micro-tile, and
// the splits' sums added in order, handed to emit(v, out_row, out_col,
// channel) -- tile-local output coordinates -- for every output of the tile.
// stage_x(xs, st, pass) fills the input window of ring stage st: pass 0
// issues its copies (cp.async, or remote loads into registers), pass 1, run
// after the micro-tile of the stage in use, stores what pass 0 loaded, so
// a remote load's latency hides behind the FMAs. The weights come from w.
// Ends with a barrier, so the ring is free for the next tile.
template <int R, int D, class StageX, class Emit>
__device__ __forceinline__ void run_tile(const Phase& f, float* smem, const int (&wsel)[4],
                                         const float* __restrict__ w, int n_k, int co0,
                                         bool vec_w, int ring, StageX stage_x, Emit emit) {
  constexpr int WROW = 4 * R * R;
  const int tid = threadIdx.x;
  const int npg = f.th * f.tw / kPW;    // position groups
  const int nts = f.ncg * npg;          // micro-tiles of the tile
  const int s = tid / nts;              // this thread's split: quad s of a stage
  const bool active = s < f.ks;         // a small tile leaves threads idle
  const int tis = tid % nts;
  const int cgi = tis / npg;            // lanes along positions share a quad
  const int pg = tis % npg;
  const int pgr = f.tw / kPW;
  const int tr = pg / pgr;
  const int tc = (pg % pgr) * kPW;
  const int ct = 4 * f.ncg;
  int woff[4];
#pragma unroll
  for (int par = 0; par < 4; ++par) woff[par] = wsel[par] * R * R * ct + 4 * cgi;
  const int xoff = s * (f.xh * f.xp * 4) + (tr * f.xp + tc) * 4;
  const int wbase = s * 4 * WROW * ct;

  float acc[4][kPW][4];
#pragma unroll
  for (int par = 0; par < 4; ++par)
#pragma unroll
    for (int j = 0; j < kPW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[par][j][k] = 0.f;

  for (int st = 0; st < ring - 1; ++st) {
    if (st < f.nst) {
      float* xs = smem + (st % ring) * f.stage;
      stage_x(xs, st, 0);
      stage_weights<R>(xs + f.stage_x, w, f, n_k, co0, st, vec_w);
      stage_x(xs, st, 1);
    }
    cp_async_commit();
  }
  for (int k = 0; k < f.nst; ++k) {
    if (ring == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();               // stage k landed everywhere; k - 1 is consumed
    const int next = k + ring - 1;
    float* nxs = smem + (next % ring) * f.stage;
    if (next < f.nst) {
      stage_x(nxs, next, 0);
      stage_weights<R>(nxs + f.stage_x, w, f, n_k, co0, next, vec_w);
    }
    cp_async_commit();
    const float* xs = smem + (k % ring) * f.stage;
    if (active)
      tconv::mac_c4<R, D>(xs + xoff, f.xp, xs + f.stage_x + wbase, WROW * ct, ct, woff, acc);
    if (next < f.nst) stage_x(nxs, next, 1);
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: the splits' sums go there
  if (active)
#pragma unroll
  for (int par = 0; par < 4; ++par)
#pragma unroll
    for (int j = 0; j < kPW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        smem[((s * kMicro) + (par * kPW + j) * 4 + k) * nts + tis] = acc[par][j][k];
  __syncthreads();
  // outputs of the tile (2 th rows x 2 tw columns x 4 ncg channels), the
  // channel fastest, so a consumer's stores run along contiguous memory
  const int lg_ct = __ffs(ct) - 1;              // 4 ncg and 2 tw: powers of two
  const int lg_ow = __ffs(2 * f.tw) - 1;
  for (int i = tid; i < kMicro * nts; i += kThreads) {
    const int c = i & (ct - 1);
    const int ocol = (i >> lg_ct) & (2 * f.tw - 1);
    const int orow = i >> (lg_ct + lg_ow);
    const int par = 2 * (orow & 1) + (ocol & 1);
    const int u = ocol >> 1;
    const int slot = (par * kPW + u % kPW) * 4 + (c & 3);
    const int at = (c >> 2) * npg + (orow >> 1) * pgr + u / kPW;
    float v = smem[slot * nts + at];
    for (int z = 1; z < f.ks; ++z) v += smem[(z * kMicro + slot) * nts + at];
    emit(v, orow, ocol, c);
  }
  __syncthreads();
}

template <int R, int D>
__global__ void __launch_bounds__(kThreads, 1)
pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ w2, const float* __restrict__ b1,
            const float* __restrict__ b2, float* __restrict__ out,
            const PairArgs a, const float slope1, const float slope2) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int iplane = a.rpb * a.s2 * 4;                // floats of one quad's band
  float* iface = smem;                                // [qpr][rpb][s2][4]
  float* ring = smem + a.qpr * iplane;

  // ---- 1. producer: this block's interface quads, halo zeros around them
  for (int i = tid; i < a.qpr * iplane / 4; i += kThreads)
    reinterpret_cast<float4*>(iface)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const Phase f = make_phase<R, D>(a.C0, a.C1, a.th1, a.tw1, a.ncg1, a.ks1, a.xh1,
                                     a.xwr1, a.xp1, a.nst1);
    // this block's quads and band of padded interface rows [r0, r0 + rpb):
    // the producer's phase rows that write it
    const int c1_lo = rank / a.n_bands * a.qpr * 4;
    const int c1_hi = min(c1_lo + a.qpr * 4, a.C1);
    const int r0 = rank % a.n_bands * a.rpb;
    const int oh_lo = max(0, r0 - a.pad_lo2);
    const int oh_hi = min(a.M1, r0 + a.rpb - a.pad_lo2);
    const int t_lo = oh_lo / 2;
    const int n_sp = oh_hi > oh_lo ? ((oh_hi + 1) / 2 - t_lo + a.th1 - 1) / a.th1 * a.n_w1 : 0;
    for (int tile = 0; tile < n_sp * a.nct1; ++tile) {
      const int sp = tile % n_sp;
      const int t0 = t_lo + (sp / a.n_w1) * a.th1;
      const int u0 = (sp % a.n_w1) * a.tw1;
      const int co0 = c1_lo + (tile / n_sp) * 4 * a.ncg1;
      // the input window of a stage, columns fastest: consecutive threads
      // fill consecutive 16-byte pieces of shared memory
      const FastDiv by_plane(f.xh * f.xwr), by_col(f.xwr);
      auto stage_x = [&](float* xs, int st, int pass) {
        const int total = pass == 0 ? f.ks * f.xh * f.xwr : 0;
        for (int i = tid; i < total; i += kThreads) {
          const int q4 = by_plane.div(i);
          const int rc = i - q4 * by_plane.d;
          const int r = by_col.div(rc);
          const int c = rc - r * f.xwr;
          const int gr = a.org1r + t0 + r;
          const int gc = a.org1c + u0 + c;
          const int gci = (st * f.ks + q4) * 4;
          const bool in = gr >= 0 && gr < a.N && gc >= 0 && gc < a.N;
          const float* src = in
              ? x + ((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.C0 + gci
              : x;
          cp_quad(xs + ((q4 * f.xh + r) * f.xp + c) * 4, src, x, in ? a.C0 - gci : 0,
                  a.vx);
        }
      };
      auto emit = [&](float v, int orow, int ocol, int c) {
        const int oh = 2 * t0 + orow;
        const int ow = 2 * u0 + ocol;
        const int ch = co0 + c;
        if (oh < oh_lo || oh >= oh_hi || ow >= a.M1 || ch >= c1_hi) return;
        if (b1 != nullptr) v += b1[ch];
        const int cl = ch - c1_lo;
        iface[(cl >> 2) * iplane + ((a.pad_lo2 + oh - r0) * a.s2 + a.pad_lo2 + ow) * 4 +
              (cl & 3)] = activate(v, a.act1, slope1);
      };
      run_tile<R, D>(f, ring, a.wsel, w1, a.n_k, co0, a.vw1, a.ring, stage_x, emit);
    }
  }

  // ---- 2. every block's interface is complete and visible to the cluster
  cluster.sync();

  // ---- 3. consumer: work tiles of the output, round-robin over the blocks
  {
    const Phase f = make_phase<R, D>(a.C1, a.C2, a.th2, a.tw2, a.ncg2, a.ks2, a.xh2,
                                     a.xwr2, a.xp2, a.nst2);
    const FastDiv by_qpr(a.qpr), by_rpb(a.rpb);
    for (int work = rank; work < a.n_sp2 * a.n_co2; work += a.cl) {
      const int sp = work % a.n_sp2;
      const int t0 = (sp / a.n_w2) * a.th2;
      const int u0 = (sp % a.n_w2) * a.tw2;
      const int co0 = (work / a.n_sp2) * 4 * a.ncg2;
      // the interface window of a stage from its owners' shared memory:
      // pass 0 loads a thread's first kPrefetch pieces into registers, which
      // pass 1 stores after the FMAs, and moves any further pieces in
      // batches of kRemoteBatch loads in flight, then their stores
      float4 pf[kPrefetch];
      const FastDiv by_plane(f.xh * f.xwr), by_col(f.xwr);
      auto piece = [&](int st, int i) {
        const int q4 = by_plane.div(i);
        const int rc = i - q4 * by_plane.d;
        const int r = by_col.div(rc);
        const int c = rc - r * f.xwr;
        const int gq = st * f.ks + q4;            // interface quad
        const int gr = a.b0r + t0 + r;
        const int gc = a.b0c + u0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gq * 4 < a.C1 && gr < a.s2 && gc < a.s2) {
          const int group = by_qpr.div(gq);
          const int band = by_rpb.div(gr);
          const float* owner = cluster.map_shared_rank(iface, group * a.n_bands + band);
          v = *reinterpret_cast<const float4*>(
              owner + (gq - group * a.qpr) * iplane + ((gr - band * a.rpb) * a.s2 + gc) * 4);
        }
        return v;
      };
      auto at = [&](float* xs, int i) {
        const int q4 = by_plane.div(i);
        const int rc = i - q4 * by_plane.d;
        const int r = by_col.div(rc);
        const int c = rc - r * f.xwr;
        return reinterpret_cast<float4*>(xs + ((q4 * f.xh + r) * f.xp + c) * 4);
      };
      auto stage_x = [&](float* xs, int st, int pass) {
        const int total = f.ks * f.xh * f.xwr;
        if (pass == 1) {
#pragma unroll
          for (int u = 0; u < kPrefetch; ++u)
            if (tid + u * kThreads < total) *at(xs, tid + u * kThreads) = pf[u];
          return;
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u)
          if (tid + u * kThreads < total) pf[u] = piece(st, tid + u * kThreads);
        for (int base = tid + kPrefetch * kThreads; base < total;
             base += kThreads * kRemoteBatch) {
          float4 v[kRemoteBatch];
#pragma unroll
          for (int u = 0; u < kRemoteBatch; ++u) {
            const int i = base + u * kThreads;
            if (i < total) v[u] = piece(st, i);
          }
#pragma unroll
          for (int u = 0; u < kRemoteBatch; ++u) {
            const int i = base + u * kThreads;
            if (i < total) *at(xs, i) = v[u];
          }
        }
      };
      auto emit = [&](float v, int orow, int ocol, int c) {
        const int oh = 2 * t0 + orow;
        const int ow = 2 * u0 + ocol;
        const int ch = co0 + c;
        if (oh >= a.M2 || ow >= a.M2 || ch >= a.C2) return;
        if (b2 != nullptr) v += b2[ch];
        out[((static_cast<long long>(b) * a.M2 + oh) * a.M2 + ow) * a.C2 + ch] =
            activate(v, a.act2, slope2);
      };
      run_tile<R, D>(f, ring, a.wsel, w2, a.n_k, co0, a.vw2, a.ring, stage_x, emit);
    }
  }

  // ---- 4. no block leaves while another may still read its interface
  cluster.sync();
}

// The shared memory a launch needs, from the geometry: the interface slice
// and the larger of the two phases' rings and the splits' sums.
template <int R, int D>
int smem_floats(const PairArgs& a) {
  const int ring1 = a.ring * (a.ks1 * a.xh1 * a.xp1 * 4 + 4 * a.ks1 * 4 * R * R * 4 * a.ncg1);
  const int ring2 = a.ring * (a.ks2 * a.xh2 * a.xp2 * 4 + 4 * a.ks2 * 4 * R * R * 4 * a.ncg2);
  const int work = ring1 > ring2 ? ring1 : ring2;
  return a.qpr * a.rpb * a.s2 * 4 + (work > kRedFloats ? work : kRedFloats);
}

// Whether the geometry describes a tile this kernel computes.
template <int R, int D>
bool geometry_ok(const PairArgs& a, int smem_bytes) {
  auto phase_ok = [](int hp, int th, int tw, int n_w, int ncg, int ks, int xh, int xwr,
                     int xp, int nst, int cin) {
    return tw % kPW == 0 && ks >= 1 && ks <= 16 && ncg >= 1 &&
           ncg * (th * tw / kPW) * ks <= kThreads &&
           xh == th + R - 1 + D && xwr == tw + R - 1 + D && xp >= xwr && (xp & 1) &&
           n_w == (hp + tw - 1) / tw && nst == (cin + 4 * ks - 1) / (4 * ks);
  };
  const int groups = a.n_bands >= 1 ? a.cl / a.n_bands : 0;
  return (a.ring == 2 || a.ring == 3) && a.cl >= 1 && a.cl <= 16 &&
         groups * a.n_bands == a.cl && groups * a.qpr * 4 >= a.C1 &&
         (groups - 1) * a.qpr * 4 < a.C1 && a.n_bands * a.rpb >= a.s2 &&
         (a.n_bands - 1) * a.rpb < a.s2 &&
         a.nct1 == (a.qpr + a.ncg1 - 1) / a.ncg1 &&
         a.n_co2 == (a.C2 + 4 * a.ncg2 - 1) / (4 * a.ncg2) &&
         a.n_sp2 == a.n_w2 * ((a.hp2 + a.th2 - 1) / a.th2) &&
         phase_ok(a.hp1, a.th1, a.tw1, a.n_w1, a.ncg1, a.ks1, a.xh1, a.xwr1, a.xp1, a.nst1,
                  a.C0) &&
         phase_ok(a.hp2, a.th2, a.tw2, a.n_w2, a.ncg2, a.ks2, a.xh2, a.xwr2, a.xp2, a.nst2,
                  a.C1) &&
         smem_bytes == 4 * smem_floats<R, D>(a);
}

template <int R, int D>
cudaError_t prepare(int cl, int smem_bytes) {
  auto kernel = pair_kernel<R, D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  if (cl > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int cl,
                    int batch, int smem_bytes, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(cl, 1, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int R, int D>
cudaError_t launch(const float* x, const float* w1, const float* w2, const float* b1,
                   const float* b2, float* out, const PairArgs& a, float slope1,
                   float slope2, int smem_bytes, cudaStream_t stream) {
  if (!geometry_ok<R, D>(a, smem_bytes)) return cudaErrorInvalidValue;
  cudaError_t e = prepare<R, D>(a.cl, smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, a.cl, a.B, smem_bytes, stream);
  e = cudaLaunchKernelEx(&cfg, pair_kernel<R, D>, x, w1, w2, b1, b2, out, a, slope1,
                         slope2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int R, int D>
cudaError_t occupancy(int cl, int smem_bytes, int* clusters) {
  cudaError_t e = prepare<R, D>(cl, smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, cl, 1, smem_bytes, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, pair_kernel<R, D>, &cfg);
}

}  // namespace

// geo: kArgInts ints in PairArgs order; R and D pick the compiled variant.
extern "C" int tconv_pair_f32(
    const float* x, const float* w1, const float* w2, const float* b1,
    const float* b2, float* out, const int* geo, int n_geo, int R, int D,
    float slope1, float slope2, int smem_bytes, void* stream) {
  if (n_geo != kArgInts) return static_cast<int>(cudaErrorInvalidValue);
  PairArgs a;
  int* dst = reinterpret_cast<int*>(&a);
  for (int i = 0; i < kArgInts; ++i) dst[i] = geo[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define PAIR_CASE(r, d) \
  if (R == r && D == d) e = launch<r, d>(x, w1, w2, b1, b2, out, a, slope1, slope2, smem_bytes, s);
  PAIR_CASE(1, 0) PAIR_CASE(1, 1) PAIR_CASE(2, 0) PAIR_CASE(2, 1)
  PAIR_CASE(3, 0) PAIR_CASE(3, 1) PAIR_CASE(4, 0) PAIR_CASE(4, 1)
#undef PAIR_CASE
  return static_cast<int>(e);
}

// cudaOccupancyMaxActiveClusters of the (R, D) instance at a cluster size and
// shared memory: how many batch items run at once.
extern "C" int tconv_pair_max_active_clusters(int R, int D, int cl, int smem_bytes,
                                              int* clusters) {
  cudaError_t e = cudaErrorInvalidValue;
#define PAIR_CASE(r, d) \
  if (R == r && D == d) e = occupancy<r, d>(cl, smem_bytes, clusters);
  PAIR_CASE(1, 0) PAIR_CASE(1, 1) PAIR_CASE(2, 0) PAIR_CASE(2, 1)
  PAIR_CASE(3, 0) PAIR_CASE(3, 1) PAIR_CASE(4, 0) PAIR_CASE(4, 1)
#undef PAIR_CASE
  return static_cast<int>(e);
}
