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
// odd-padding swap, the cluster partition, tiles, shared memory) comes from
// Python (transpose_conv2d_pair.py::pair_launch_geometry).
//
// What bounds it on the H100: fp32 arithmetic. The pair does both layers'
// operations on fewer bytes than the two layers apart: the fp32 interface
// round trip it removes is 2 MiB (DCGAN head pair) or 8 MiB (tail pair) at
// batch 8, under 3 us at 3.35 TB/s, against 64 us and 34 us of fp32 work.
// So the pair saves launches and device memory, not bandwidth.
//
// Design. A batch item's interface (8x8x512 fp32 = 128 KiB for the DCGAN
// head pair, 32x32x128 = 512 KiB for the tail) does not fit one block's
// 227 KB of shared memory, but it fits a thread-block cluster. One cluster of
// CL <= 8 blocks (portable) runs each batch item:
//   1. producer: block `rank` owns interface channels [rank*mc, rank*mc+mc).
//      It computes them over the whole M1 x M1 plane, tile by tile (all four
//      parities from one staged input window, the Cin loop inside the
//      block), applies bias1 and act1 on the fp32 accumulators, and writes
//      them into its own shared memory, laid out [channel][s2][s2] with the
//      consumer's zero halo already in place.
//   2. cluster barrier.
//   3. consumer: the blocks share the output's (phase-plane tile, C2 tile)
//      work tiles round-robin. For each, a block walks the interface channels
//      rank by rank, staging 16-channel windows from the owner's shared
//      memory (distributed shared memory, map_shared_rank) and the matching
//      k2 chunk, accumulates, and applies bias2 and act2 before one store.
//   4. cluster barrier, so no block leaves while another still reads it.
// The interface is never a tensor in device memory. There are no atomics:
// every interface element and every output element is summed by one thread
// in a fixed order (cin chunk, cin, p, q; then rank, chunk, channel, p, q),
// so a sample's bits do not depend on the batch it is served in.
//
// A thread keeps 4 parities x PPT positions x 4 channels of accumulators;
// PPT (1 or 2) and the channel groups of a tile are chosen per phase by the
// Python geometry so the 256 threads cover the small DCGAN head planes.
// Consecutive threads take consecutive positions of one channel group, so a
// warp's weight loads hit one or two addresses and its input loads are
// consecutive.
// Staging issues eight loads a thread before it stores any, so a chunk
// waits for a few memory latencies, not one per value.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCinChunk = 16;

// The order of these fields is the order of the int array the host passes
// (transpose_conv2d_pair.py::_GEOMETRY_FIELDS).
struct PairArgs {
  int B, N, C0, C1, C2, n_k, M1, M2;
  int cl, mc;               // cluster blocks; interface channels a block
  int wsel[4];              // output parity -> stacked sub-kernel (both layers)
  // producer
  int pad_lo1, x0r, x0c;    // input border; first padded row / col read
  int roff1[2], coff1[2];   // phase origins relative to (x0r, x0c)
  int hp1, th1, tw1, n_w1, n_sp1, xh1, xw1;  // plane, tiles, staged window
  int ncg1, nct1;           // channel groups a tile; channel tiles a block
  // interface and consumer
  int s2, pad_lo2;          // padded interface extent; its zero border
  int b0r, b0c;             // first padded-interface row / col read
  int roff2[2], coff2[2];
  int hp2, th2, tw2, n_w2, n_sp2, xh2, xw2;
  int ncg2, n_co2;
  int act1, act2;
};
constexpr int kArgInts = sizeof(PairArgs) / sizeof(int);

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case 1: return y > 0.f ? y : 0.f;
    case 2: return tanhf(y);
    case 3: return y > 0.f ? y : slope * y;
    default: return y;
  }
}

// Copy `total` values into shared memory: value i is load(i) and goes to
// dst[slot(i)]. Each thread issues kStageBatch loads before it stores any,
// so a staging pass waits for a few memory latencies, not one per value.
constexpr int kStageBatch = 8;

template <typename Load, typename Slot>
__device__ __forceinline__ void stage(float* dst, int total, Load load, Slot slot) {
  for (int base = threadIdx.x; base < total; base += kThreads * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < total ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) dst[slot(i)] = v[u];
    }
  }
}

// Stage the (4, R, R, CI, ct) chunk of the HWIO kernel w: input channels
// [ci0, ci0 + CI) masked at ci_end, output channels [co0, co0 + ct) masked at
// co_end, taps past the n x n kernel zero. ct (4..64, a power of two)
// divides kThreads, so a thread keeps one output channel for the whole pass
// and its row index needs no division by a runtime value.
template <int R>
__device__ __forceinline__ void stage_weights(
    float* ws, const float* __restrict__ w, int n_k, int cin, int cout,
    int ci0, int ci_end, int co0, int co_end, int ct) {
  constexpr int kRows = 4 * R * R * kCinChunk;  // (s, p, q, ci)
  const int c = threadIdx.x % ct;
  const int step = kThreads / ct;
  const bool co_ok = co0 + c < co_end;
  for (int k0 = threadIdx.x / ct; k0 < kRows; k0 += step * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int k = k0 + u * step;
      const int ci = k % kCinChunk;
      const int spq = k / kCinChunk;  // (s * R + p) * R + q
      const int q = spq % R;
      const int p = (spq / R) % R;
      const int s = spq / (R * R);
      const int kh = 2 * p + (s >> 1);
      const int kw = 2 * q + (s & 1);
      const int gci = ci0 + ci;
      v[u] = (k < kRows && co_ok && kh < n_k && kw < n_k && gci < ci_end)
          ? w[((static_cast<long long>(kh) * n_k + kw) * cin + gci) * cout + co0 + c]
          : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int k = k0 + u * step;
      if (k < kRows) ws[k * ct + c] = v[u];
    }
  }
}

// One staged chunk into the accumulators: all four parities, PPT positions,
// four channels a thread.
template <int R, int PPT>
__device__ __forceinline__ void mac_chunk(
    const float* xs, int xplane, int xw, const float* ws, int ct,
    const int (&xoff)[4][PPT], const int (&woff)[4], float (&acc)[4][PPT][4]) {
#pragma unroll 2
  for (int ci = 0; ci < kCinChunk; ++ci) {
    const float* xc = xs + ci * xplane;
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int par = 0; par < 4; ++par) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + woff[par] + ((p * R + q) * kCinChunk + ci) * ct);
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

template <int PPT>
__device__ __forceinline__ void zero(float (&acc)[4][PPT][4]) {
#pragma unroll
  for (int par = 0; par < 4; ++par)
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[par][j][k] = 0.f;
}

template <int R, int PA, int PB>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ w2, const float* __restrict__ b1,
            const float* __restrict__ b2, float* __restrict__ out,
            const PairArgs a, const float slope1, const float slope2) {
  constexpr int CI = kCinChunk;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int iplane = a.s2 * a.s2;
  float* iface = smem;                                 // [mc][s2][s2]
  float* staging = smem + ((a.mc * iplane + 3) & ~3);  // windows, weights

  // ---- 1. producer: this block's interface channels, halo zeros around them
  for (int idx = tid; idx < a.mc * iplane; idx += kThreads) iface[idx] = 0.f;
  const int c1_lo = rank * a.mc;
  const int c1_hi = min(c1_lo + a.mc, a.C1);
  {
    const int ct = a.ncg1 * 4;
    const int groups = kThreads / a.ncg1;
    const int pg = tid % groups;      // lanes along positions: one weight
    const int cgi = tid / groups;     // address a warp, consecutive x reads
    const int xplane = a.xh1 * a.xw1;
    float* xs = staging;                                  // [ci][xh1][xw1]
    float* ws = staging + ((CI * xplane + 3) & ~3);       // [s][p][q][ci][ct]
    int woff[4];
#pragma unroll
    for (int par = 0; par < 4; ++par)
      woff[par] = a.wsel[par] * R * R * CI * ct + cgi * 4;
    for (int tile = 0; tile < a.n_sp1 * a.nct1; ++tile) {
      const int sp = tile % a.n_sp1;
      const int t0 = (sp / a.n_w1) * a.th1;
      const int u0 = (sp % a.n_w1) * a.tw1;
      const int co0 = c1_lo + (tile / a.n_sp1) * ct;
      int tl[PA], ul[PA], xoff[4][PA];
      bool live[PA];
#pragma unroll
      for (int j = 0; j < PA; ++j) {
        int pos = pg + groups * j;
        live[j] = pos < a.th1 * a.tw1;
        pos = live[j] ? pos : 0;
        tl[j] = pos / a.tw1;
        ul[j] = pos % a.tw1;
#pragma unroll
        for (int par = 0; par < 4; ++par)
          xoff[par][j] = (tl[j] + a.roff1[par >> 1]) * a.xw1 + ul[j] + a.coff1[par & 1];
      }
      float acc[4][PA][4];
      zero<PA>(acc);
      for (int ci0 = 0; ci0 < a.C0; ci0 += CI) {
        __syncthreads();  // the previous chunk's reads are done
        // channels fastest: the input is NHWC
        stage(xs, CI * xplane, [&](int idx) {
          const int rc = idx / CI;
          const int gr = a.x0r + t0 + rc / a.xw1 - a.pad_lo1;
          const int gc = a.x0c + u0 + rc % a.xw1 - a.pad_lo1;
          const int gci = ci0 + idx % CI;
          return (gr >= 0 && gr < a.N && gc >= 0 && gc < a.N && gci < a.C0)
              ? x[((static_cast<long long>(b) * a.N + gr) * a.N + gc) * a.C0 + gci]
              : 0.f;
        }, [&](int idx) { return (idx % CI) * xplane + idx / CI; });
        stage_weights<R>(ws, w1, a.n_k, a.C0, a.C1, ci0, a.C0, co0, c1_hi, ct);
        __syncthreads();
        mac_chunk<R, PA>(xs, xplane, a.xw1, ws, ct, xoff, woff, acc);
      }
      // bias1 and act1 on the fp32 accumulators, cropped to M1 x M1
#pragma unroll
      for (int par = 0; par < 4; ++par) {
#pragma unroll
        for (int j = 0; j < PA; ++j) {
          const int oh = 2 * (t0 + tl[j]) + (par >> 1);
          const int ow = 2 * (u0 + ul[j]) + (par & 1);
          if (!live[j] || oh >= a.M1 || ow >= a.M1) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = co0 + cgi * 4 + k;
            if (c < c1_hi) {
              float y = acc[par][j][k];
              if (b1 != nullptr) y += b1[c];
              iface[(c - c1_lo) * iplane + (a.pad_lo2 + oh) * a.s2 + a.pad_lo2 + ow] =
                  activate(y, a.act1, slope1);
            }
          }
        }
      }
    }
  }

  // ---- 2. every block's interface is complete and visible to the cluster
  cluster.sync();

  // ---- 3. consumer: work tiles of the output, round-robin over the blocks
  {
    const int ct = a.ncg2 * 4;
    const int groups = kThreads / a.ncg2;
    const int pg = tid % groups;      // lanes along positions: one weight
    const int cgi = tid / groups;     // address a warp, consecutive x reads
    const int xplane = a.xh2 * a.xw2;
    float* xs = staging;                                  // [ci][xh2][xw2]
    float* ws = staging + ((CI * xplane + 3) & ~3);
    int woff[4];
#pragma unroll
    for (int par = 0; par < 4; ++par)
      woff[par] = a.wsel[par] * R * R * CI * ct + cgi * 4;
    for (int work = rank; work < a.n_sp2 * a.n_co2; work += a.cl) {
      const int sp = work % a.n_sp2;
      const int t0 = (sp / a.n_w2) * a.th2;
      const int u0 = (sp % a.n_w2) * a.tw2;
      const int co0 = (work / a.n_sp2) * ct;
      int tl[PB], ul[PB], xoff[4][PB];
      bool live[PB];
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        int pos = pg + groups * j;
        live[j] = pos < a.th2 * a.tw2;
        pos = live[j] ? pos : 0;
        tl[j] = pos / a.tw2;
        ul[j] = pos % a.tw2;
#pragma unroll
        for (int par = 0; par < 4; ++par)
          xoff[par][j] = (tl[j] + a.roff2[par >> 1]) * a.xw2 + ul[j] + a.coff2[par & 1];
      }
      float acc[4][PB][4];
      zero<PB>(acc);
      for (int src = 0; src < a.cl; ++src) {
        const float* riface = cluster.map_shared_rank(iface, src);
        const int m_lo = src * a.mc;
        const int m_hi = min(m_lo + a.mc, a.C1);
        for (int c0 = m_lo; c0 < m_hi; c0 += CI) {
          __syncthreads();
          // columns fastest: the owner's layout is [channel][row][col]
          stage(xs, CI * xplane, [&](int idx) {
            const int ci = idx / xplane;
            const int rc = idx % xplane;
            const int gr = a.b0r + t0 + rc / a.xw2;
            const int gc = a.b0c + u0 + rc % a.xw2;
            return (c0 + ci < m_hi && gr < a.s2 && gc < a.s2)
                ? riface[(c0 - m_lo + ci) * iplane + gr * a.s2 + gc]
                : 0.f;
          }, [](int idx) { return idx; });
          stage_weights<R>(ws, w2, a.n_k, a.C1, a.C2, c0, m_hi, co0, a.C2, ct);
          __syncthreads();
          mac_chunk<R, PB>(xs, xplane, a.xw2, ws, ct, xoff, woff, acc);
        }
      }
#pragma unroll
      for (int par = 0; par < 4; ++par) {
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const int oh = 2 * (t0 + tl[j]) + (par >> 1);
          const int ow = 2 * (u0 + ul[j]) + (par & 1);
          if (!live[j] || oh >= a.M2 || ow >= a.M2) continue;
          float* o = out + ((static_cast<long long>(b) * a.M2 + oh) * a.M2 + ow) * a.C2;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = co0 + cgi * 4 + k;
            if (c < a.C2) {
              float y = acc[par][j][k];
              if (b2 != nullptr) y += b2[c];
              o[c] = activate(y, a.act2, slope2);
            }
          }
        }
      }
    }
  }

  // ---- 4. no block leaves while another may still read its interface
  cluster.sync();
}

template <int R, int PA, int PB>
cudaError_t launch(const float* x, const float* w1, const float* w2,
                   const float* b1, const float* b2, float* out,
                   const PairArgs& a, float slope1, float slope2, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = pair_kernel<R, PA, PB>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cl, 1, a.B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w1, w2, b1, b2, out, a,
                                           slope1, slope2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_p(int pa, int pb, const float* x, const float* w1,
                     const float* w2, const float* b1, const float* b2, float* out,
                     const PairArgs& a, float s1, float s2, int smem, cudaStream_t st) {
  if (pa == 1 && pb == 1) return launch<R, 1, 1>(x, w1, w2, b1, b2, out, a, s1, s2, smem, st);
  if (pa == 1 && pb == 2) return launch<R, 1, 2>(x, w1, w2, b1, b2, out, a, s1, s2, smem, st);
  if (pa == 2 && pb == 1) return launch<R, 2, 1>(x, w1, w2, b1, b2, out, a, s1, s2, smem, st);
  if (pa == 2 && pb == 2) return launch<R, 2, 2>(x, w1, w2, b1, b2, out, a, s1, s2, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// geo: kArgInts ints in PairArgs order; R, PPT of the producer and of the
// consumer pick the compiled variant.
extern "C" int tconv_pair_f32(
    const float* x, const float* w1, const float* w2, const float* b1,
    const float* b2, float* out, const int* geo, int n_geo, int R, int ppt1,
    int ppt2, float slope1, float slope2, int smem_bytes, void* stream) {
  if (n_geo != kArgInts) return static_cast<int>(cudaErrorInvalidValue);
  PairArgs a;
  int* dst = reinterpret_cast<int*>(&a);
  for (int i = 0; i < kArgInts; ++i) dst[i] = geo[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (R) {
    case 1: e = launch_p<1>(ppt1, ppt2, x, w1, w2, b1, b2, out, a, slope1, slope2, smem_bytes, s); break;
    case 2: e = launch_p<2>(ppt1, ppt2, x, w1, w2, b1, b2, out, a, slope1, slope2, smem_bytes, s); break;
    case 3: e = launch_p<3>(ppt1, ppt2, x, w1, w2, b1, b2, out, a, slope1, slope2, smem_bytes, s); break;
    case 4: e = launch_p<4>(ppt1, ppt2, x, w1, w2, b1, b2, out, a, slope1, slope2, smem_bytes, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
