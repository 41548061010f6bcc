// Building blocks shared by the hand-written transpose-conv kernels for
// sm_90a: the epilogue activation, the cp.async copies that stage tiles into
// shared memory (16-byte, or 4-byte for a ragged or unaligned channel run,
// zero-filled past the data), the register micro-tiles of the unified
// kernel-segregated form (mac_c4, four parities) and of the per-phase form
// (mac_p1, one parity), and the second pass of a Cin split.
//
// The micro-tile (mac_c4). A thread owns 4 output parities x kPW consecutive
// positions of one phase-plane row x 4 output channels: 64 fp32
// accumulators, acc[parity][position][channel]. For each staged input channel
// quad it walks the R + D input rows that its parities and row taps touch;
// per row it loads a register patch of kPW + R - 1 + D pixels (a float4 =
// the quad's 4 channels each) once and reuses it for every (parity, row tap,
// column tap, position). Each weight float4 (4 output channels of one tap and
// input channel) feeds 16 FMAs. D is 1 where the two output parities of a
// row start one input row apart (even padding), else 0.
//
// Staged layouts the micro-tile reads:
//   input:   [channel quad][row][col][4], a row `xw` pixels apart;
//   weights: [ci][stacked tap (s, p, q)][Cout tile]: channel ci of the quad
//            at wc + cc * wci, tap (s, p, q) at + ((s * R + p) * R + q) *
//            wtap (wtap = the tile, wci = 4 R R wtap); woff[parity] holds
//            s * R * R * wtap for the parity's sub-kernel s (the
//            odd-padding swap lives there) plus the thread's channel offset.
// Cout runs innermost, as in HWIO, so consecutive threads' 16-byte copies
// fill contiguous shared memory: cp.async moves a third as much a second
// into a layout that scatters a line's pieces (probes/staging_bandwidth.cu).
// Tap, parity and position loops unroll against compile-time R and D, so
// the patch stays in registers.
//
// The per-phase micro-tile (mac_p1). A thread owns kPH consecutive rows x
// kPW consecutive positions of ONE parity's phase plane x 4 output
// channels: 64 fp32 accumulators, acc[row][position][channel]. Its staged
// input is that parity's own window, so every row tap p of every output row
// reads a different input row: for each tap row p it holds the 4 R weight
// float4s of (q, channel of the quad) in registers, then walks the kPH
// output rows, loading each one's input row (a patch of kPW + R - 1 pixels)
// and applying all R column taps. Each weight float4 feeds 64 FMAs, each
// patch float4 up to 16 R; per channel quad that is 256 R^2 FMAs against
// 4 R^2 weight and 4 R (R + 3) patch loads from shared memory: 12.8, 18.3,
// 21.3 and 23.3 FMAs a 128-bit load at R = 1..4. The staged window skews
// its columns, pixel c at c + c/4: a thread's first column is a multiple of
// kPW, so 8 threads whose position groups sit side by side on a row read 8
// different 16-byte bank groups (without the skew they would share 2).
#pragma once

#include <cuda_runtime.h>

namespace tconv {

constexpr int kPW = 4;   // positions along a phase-plane row a thread
constexpr int kPH = 4;   // phase-plane rows a thread (mac_p1)

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case 1: return y > 0.f ? y : 0.f;
    case 2: return tanhf(y);
    case 3: return y > 0.f ? y : slope * y;
    default: return y;
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage the 4 floats src[0..3] at the 16-byte aligned dst, where n floats
// exist from src on (n <= 0: none; the missing ones become zeros). vec: src
// is 16-byte aligned and n is <= 0 or >= 4, so one 16-byte copy does it.
// `any` is a valid address of the same tensor, read by nothing (a zero-byte
// copy still needs one).
__device__ __forceinline__ void cp_quad(float* dst, const float* src,
                                        const float* any, int n, bool vec) {
  if (vec) {
    cp_async16(dst, n > 0 ? src : any, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < n ? src + e : any, e < n);
  }
}

// Selects, not indexes: an argument array indexed at run time would be
// copied to the stack.
__device__ __forceinline__ int pick2(const int (&v)[2], int i) { return i ? v[1] : v[0]; }
__device__ __forceinline__ int pick4(const int (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Component k of v; k is a constant of an unrolled loop, so this is a
// register, not a branch.
__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One staged input channel quad into the thread's 64 accumulators. xc: the
// quad's staged row 0 at the thread's first position; wc: the quad's first
// channel in the staged weights. The strides may be compile-time constants
// (the fused kernel's: every load an immediate offset) or run-time values
// (the pair kernel's tiles).
template <int R, int D>
__device__ __forceinline__ void mac_c4(const float* xc, int xw, const float* wc,
                                       int wci, int wtap, const int (&woff)[4],
                                       float (&acc)[4][kPW][4]) {
  constexpr int PC = kPW + R - 1 + D;   // register patch columns
#pragma unroll
  for (int rho = 0; rho < R + D; ++rho) {   // staged row (thread's row) + rho
    float4 xr[PC];
#pragma unroll
    for (int kap = 0; kap < PC; ++kap)
      xr[kap] = *reinterpret_cast<const float4*>(xc + (rho * xw + kap) * 4);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int p = rho - pr * D;           // the row tap of parity pr here
      if (p < 0 || p >= R) continue;
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int pc = 0; pc < 2; ++pc) {
          const int par = 2 * pr + pc;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 wv = *reinterpret_cast<const float4*>(
                wc + woff[par] + cc * wci + (p * R + q) * wtap);
#pragma unroll
            for (int j = 0; j < kPW; ++j) {
              const float xv = component(xr[j + pc * D + q], cc);
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
}

// The staged column of pixel column c in mac_p1's skewed window.
__host__ __device__ constexpr int skew(int c) { return c + (c >> 2); }

// One staged input channel quad into one parity's 64 accumulators. xc: the
// quad's staged window at the thread's first row and (skewed) column; xp:
// the window's row pitch in pixels; wc: the quad's first channel in the
// staged weights [ci][p][q][Cout tile] plus the thread's channel offset;
// wci: floats between channels; wtap: floats between taps (p * R + q).
template <int R>
__device__ __forceinline__ void mac_p1(const float* xc, int xp, const float* wc,
                                       int wci, int wtap, float (&acc)[kPH][kPW][4]) {
  constexpr int PC = kPW + R - 1;   // register patch columns
#pragma unroll
  for (int p = 0; p < R; ++p) {
    float4 wq[R][4];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        wq[q][cc] = *reinterpret_cast<const float4*>(wc + cc * wci + (p * R + q) * wtap);
#pragma unroll
    for (int tr = 0; tr < kPH; ++tr) {
      float4 xr[PC];
#pragma unroll
      for (int kap = 0; kap < PC; ++kap)
        xr[kap] = *reinterpret_cast<const float4*>(xc + ((tr + p) * xp + skew(kap)) * 4);
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 wv = wq[q][cc];
#pragma unroll
          for (int j = 0; j < kPW; ++j) {
            const float xv = component(xr[j + q], cc);
            acc[tr][j][0] = fmaf(xv, wv.x, acc[tr][j][0]);
            acc[tr][j][1] = fmaf(xv, wv.y, acc[tr][j][1]);
            acc[tr][j][2] = fmaf(xv, wv.z, acc[tr][j][2]);
            acc[tr][j][3] = fmaf(xv, wv.w, acc[tr][j][3]);
          }
        }
      }
    }
  }
}

namespace {   // each library that includes this compiles its own copy

// Second pass of a Cin split: out = act(sum over splits, in split order,
// of the partial sums + bias).
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, long long total,
                                     int Cout, int splits, int act, float slope) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float y = part[e];
    for (int s = 1; s < splits; ++s) y += part[s * total + e];
    if (bias != nullptr) y += bias[e % Cout];
    out[e] = activate(y, act, slope);
  }
}

// Launch reduce_splits_kernel over the (B, M, M, Cout) output: at most 16
// blocks of 256 threads an SM of an H100.
inline cudaError_t reduce_splits(const float* part, const float* bias, float* out,
                                 long long total, int Cout, int splits, int act,
                                 float slope, cudaStream_t stream) {
  const long long blocks = (total + 255) / 256;
  reduce_splits_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                         stream>>>(part, bias, out, total, Cout, splits, act, slope);
  return cudaGetLastError();
}

}  // namespace

}  // namespace tconv
