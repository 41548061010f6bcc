// Segregated backward of the unified transpose convolution, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/transpose_conv2d_bwd.py:
//   epilogue_grad_kernel  <- epilogue_grad_pallas       (_epilogue_grad_kernel)
//   dx_kernel             <- transpose_conv2d_dx_pallas (_dx_kernel)
//   dw_kernel             <- transpose_conv2d_dw_pallas (_dw_kernel, with_db)
// plus sum_splits_kernel, the second pass of a split contraction.
//
// The functions (geometry computed in Python, transpose_conv2d_bwd.py):
//   gm = g * act'(y)                                    (from the saved output y)
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
// What these simple designs do about it:
// - epilogue-grad: one grid-stride pass, one read of g and y, one write. The
//   products are rounded one by one (__fmul_rn/__fsub_rn, no FMA
//   contraction), so the kernel gives the bits of the plain PyTorch version.
// - dx and dw are implicit GEMMs on one SGEMM tile: 128 threads, 4 x 4 fp32
//   accumulators a thread, K in steps of 16, both operands gathered by
//   address into shared memory (the TPU's pre-shifted parity planes and
//   zero-padded copies are gone; ragged edges are masked).
//   dx: rows are dx positions (b, i, j), columns Cin, K runs over the
//   stacked taps (ph, p, q) and Cout in chunks; each row's source in gm is
//   resolved once per tap, and a tap that no row of the block reads (a
//   border) or that lies past an odd kernel is skipped whole.
//   dw: one GEMM per HWIO tap, rows Cin, columns Cout, K over the B*Hp*Hp
//   positions of that tap's phase plane; each position's two sources are
//   resolved once per K step. A Cout of at most 16 takes a 128 x 16 tile.
//   db is summed from the staged gm tiles by the blocks of each phase's
//   first tap and first Cin block: no extra read of gm.
// - Determinism: no atomics. Where the TPU carried a sum across sequential
//   grid steps, a block loops. Where that leaves too few blocks for 132 SMs,
//   the contraction is split into a number of parts that depends only on the
//   layer's shape (bwd_geometry); each part is written to its own slice and
//   sum_splits_kernel adds the slices in split order. Every sum therefore
//   runs in one fixed order, and a resumed training run repeats its bits.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;   // contraction step
constexpr int NT = 128;  // threads of the GEMM kernels: 4 x 4 outputs each

// ------------------------------------------------------------ epilogue grad

__global__ void epilogue_grad_kernel(const float* __restrict__ g,
                                     const float* __restrict__ y,
                                     float* __restrict__ out, long long n,
                                     int act, float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gv = g[i];
    const float yv = y[i];
    float r;
    switch (act) {
      case 1: r = yv > 0.f ? gv : 0.f; break;                                  // relu
      case 2: r = __fmul_rn(gv, __fsub_rn(1.f, __fmul_rn(yv, yv))); break;     // tanh
      case 3: r = yv > 0.f ? gv : __fmul_rn(slope, gv); break;                 // leaky
      default: r = gv;
    }
    out[i] = r;
  }
}

// One K step of the 4 x 4-per-thread tile: acc += As[k][rows] x Bs[k][cols].
template <int AS, int BS>
__device__ __forceinline__ void tile_fma(float (*As)[AS], float (*Bs)[BS],
                                         int ty, int tx, float acc[4][4]) {
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
}

// ---------------------------------------------------------------------- dx

struct DxArgs {
  int B, N, Cin, Cout, n_k, M, R;
  int roff[2], coff[2];  // plane-row offset by output parity: pad_lo - row0
  int wsel[4];           // output parity -> stacked sub-kernel
  int taps_per_split;
};

constexpr int DX_BM = 32;  // dx positions a block
constexpr int DX_BN = 64;  // input channels a block

__global__ void __launch_bounds__(NT)
dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
          float* __restrict__ out, const DxArgs a) {
  __shared__ __align__(16) float As[BK][DX_BM + 4];  // gm: [co][row]
  __shared__ __align__(16) float Bs[BK][DX_BN + 4];  // K:  [co][ci]
  __shared__ int rb[DX_BM], ri[DX_BM], rj[DX_BM];    // row -> (b, i, j), b -1 past the end
  __shared__ long long gsrc[DX_BM];                  // this tap's gm pixel, -1: none

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * DX_BM;
  const int ci0 = blockIdx.y * DX_BN;
  const int split = blockIdx.z;
  const int plane = a.N * a.N;
  const int rows = a.B * plane;
  if (tid < DX_BM) {
    const int r = m0 + tid;
    rb[tid] = r < rows ? r / plane : -1;
    ri[tid] = (r % plane) / a.N;
    rj[tid] = r % a.N;
  }
  __syncthreads();

  const int tx = tid % (DX_BN / 4);
  const int ty = tid / (DX_BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int taps = 4 * a.R * a.R;
  const int t_begin = split * a.taps_per_split;
  const int t_end = min(taps, t_begin + a.taps_per_split);
  for (int tap = t_begin; tap < t_end; ++tap) {
    const int ph = tap / (a.R * a.R);
    const int p = (tap / a.R) % a.R;
    const int q = tap % a.R;
    const int s = a.wsel[ph];
    const int kh = 2 * p + (s >> 1);
    const int kw = 2 * q + (s & 1);
    if (kh >= a.n_k || kw >= a.n_k) continue;  // past an odd kernel: uniform
    const int pr = ph >> 1;
    const int pc = ph & 1;
    int reads = 0;
    if (tid < DX_BM) {
      long long src = -1;
      if (rb[tid] >= 0) {
        // test the sign before anything else: no division of a negative
        const int t = ri[tid] + a.roff[pr] - p;
        const int u = rj[tid] + a.coff[pc] - q;
        const int oh = 2 * t + pr;
        const int ow = 2 * u + pc;
        if (t >= 0 && u >= 0 && oh < a.M && ow < a.M)
          src = ((static_cast<long long>(rb[tid]) * a.M + oh) * a.M + ow) * a.Cout;
      }
      gsrc[tid] = src;
      reads = src >= 0;
    }
    if (!__syncthreads_or(reads)) continue;  // uniform over the block

    const float* wt = w + static_cast<long long>(kh * a.n_k + kw) * a.Cin * a.Cout;
    for (int co0 = 0; co0 < a.Cout; co0 += BK) {
#pragma unroll
      for (int i = 0; i < DX_BM * BK / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx % BK;
        const int mm = idx / BK;
        const long long src = gsrc[mm];
        const int co = co0 + k;
        As[k][mm] = (src >= 0 && co < a.Cout) ? g[src + co] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < DX_BN * BK / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx % BK;
        const int nn = idx / BK;
        const int ci = ci0 + nn;
        const int co = co0 + k;
        Bs[k][nn] = (ci < a.Cin && co < a.Cout)
                        ? wt[static_cast<long long>(ci) * a.Cout + co] : 0.f;
      }
      __syncthreads();
      tile_fma<DX_BM + 4, DX_BN + 4>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  float* o = out + static_cast<long long>(split) * rows * a.Cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i;
    if (rb[rl] < 0) continue;
    const long long base = static_cast<long long>(m0 + rl) * a.Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + tx * 4 + j;
      if (ci < a.Cin) o[base + ci] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------- dw

struct DwArgs {
  int B, N, Cin, Cout, n_k, M, Hp, pad_lo;
  int row0[2], col0[2];  // padded-input origin by output row/col parity
  int phase_of_sub[4];   // stacked sub-kernel -> output parity
  int n_co_blocks;
  int positions_per_split;
  int with_db;
};

template <int BM, int BN>
__global__ void __launch_bounds__(NT)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ part, float* __restrict__ db_part, const DwArgs a) {
  constexpr int TX = BN / 4;  // column groups; NT / TX row groups of 4
  __shared__ __align__(16) float As[BK][BM];  // x:  [position][ci]
  __shared__ __align__(16) float Bs[BK][BN];  // gm: [position][co]
  __shared__ long long xsrc[BK], gsrc[BK];    // this step's pixels, -1: none

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
  const int plane = a.Hp * a.Hp;
  const int positions = a.B * plane;
  const int k_begin = split * a.positions_per_split;
  const int k_end = min(positions, k_begin + a.positions_per_split);
  // the blocks of each phase's first tap and first Cin block also sum db
  const bool do_db = a.with_db && p == 0 && q == 0 && ci0 == 0;

  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float dbacc = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if (tid < BK) {
      const int k = k0 + tid;
      long long xs = -1;
      long long gs = -1;
      if (k < k_end) {
        const int b = k / plane;
        const int rem = k % plane;
        const int t = rem / a.Hp;
        const int u = rem % a.Hp;
        const int oh = 2 * t + pr;
        const int ow = 2 * u + pc;
        if (oh < a.M && ow < a.M) {
          gs = ((static_cast<long long>(b) * a.M + oh) * a.M + ow) * a.Cout;
          const int ih = a.row0[pr] + t + p - a.pad_lo;
          const int iw = a.col0[pc] + u + q - a.pad_lo;
          if (ih >= 0 && ih < a.N && iw >= 0 && iw < a.N)
            xs = ((static_cast<long long>(b) * a.N + ih) * a.N + iw) * a.Cin;
        }
      }
      xsrc[tid] = xs;
      gsrc[tid] = gs;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int mm = idx % BM;
      const int k = idx / BM;
      const long long src = xsrc[k];
      const int ci = ci0 + mm;
      As[k][mm] = (src >= 0 && ci < a.Cin) ? x[src + ci] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int nn = idx % BN;
      const int k = idx / BN;
      const long long src = gsrc[k];
      const int co = co0 + nn;
      Bs[k][nn] = (src >= 0 && co < a.Cout) ? g[src + co] : 0.f;
    }
    __syncthreads();
    if (do_db && tid < BN) {
#pragma unroll
      for (int k = 0; k < BK; ++k) dbacc += Bs[k][tid];
    }
    tile_fma<BM, BN>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* o = part + static_cast<long long>(split * a.n_k * a.n_k + tap) * a.Cin * a.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= a.Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < a.Cout) o[static_cast<long long>(ci) * a.Cout + co] = acc[i][j];
    }
  }
  if (do_db && tid < BN && co0 + tid < a.Cout)
    db_part[(static_cast<long long>(split) * 4 + ph) * a.Cout + co0 + tid] = dbacc;
}

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

template <int BM, int BN>
cudaError_t launch_dw(const float* x, const float* g, float* part, float* db_part,
                      const DwArgs& a, int n_blocks, int n_taps, int splits,
                      cudaStream_t stream) {
  const dim3 grid(n_blocks, n_taps, splits);
  dw_kernel<BM, BN><<<grid, NT, 0, stream>>>(x, g, part, db_part, a);
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

extern "C" int tconv_dx_f32(const float* g, const float* w, float* out,
                            int B, int N, int Cin, int Cout, int n_k, int M, int R,
                            int roff0, int roff1, int coff0, int coff1,
                            int wsel0, int wsel1, int wsel2, int wsel3,
                            int n_row_blocks, int n_ci_blocks, int splits,
                            int taps_per_split, void* stream) {
  DxArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M; a.R = R;
  a.roff[0] = roff0; a.roff[1] = roff1; a.coff[0] = coff0; a.coff[1] = coff1;
  a.wsel[0] = wsel0; a.wsel[1] = wsel1; a.wsel[2] = wsel2; a.wsel[3] = wsel3;
  a.taps_per_split = taps_per_split;
  const dim3 grid(n_row_blocks, n_ci_blocks, splits);
  dx_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(g, w, out, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tconv_dw_f32(const float* x, const float* g, float* part, float* db_part,
                            int B, int N, int Cin, int Cout, int n_k, int M, int Hp,
                            int pad_lo, int row00, int row01, int col00, int col01,
                            int ps0, int ps1, int ps2, int ps3, int tile_m, int tile_n,
                            int n_blocks, int n_taps, int splits,
                            int positions_per_split, int with_db, void* stream) {
  DwArgs a;
  a.B = B; a.N = N; a.Cin = Cin; a.Cout = Cout; a.n_k = n_k; a.M = M; a.Hp = Hp;
  a.pad_lo = pad_lo;
  a.row0[0] = row00; a.row0[1] = row01; a.col0[0] = col00; a.col0[1] = col01;
  a.phase_of_sub[0] = ps0; a.phase_of_sub[1] = ps1;
  a.phase_of_sub[2] = ps2; a.phase_of_sub[3] = ps3;
  a.n_co_blocks = (Cout + tile_n - 1) / tile_n;
  a.positions_per_split = positions_per_split;
  a.with_db = with_db;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_m == 32 && tile_n == 64)
    return static_cast<int>(launch_dw<32, 64>(x, g, part, db_part, a, n_blocks, n_taps, splits, s));
  if (tile_m == 128 && tile_n == 16)
    return static_cast<int>(launch_dw<128, 16>(x, g, part, db_part, a, n_blocks, n_taps, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tconv_sum_splits_f32(const float* pa, float* oa, long long na, int sa,
                                    const float* pb, float* ob, long long nb, int sb,
                                    void* stream) {
  sum_splits_kernel<<<grid_stride_blocks(na + nb, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(pa, oa, na, sa, pb, ob, nb, sb);
  return static_cast<int>(cudaGetLastError());
}
