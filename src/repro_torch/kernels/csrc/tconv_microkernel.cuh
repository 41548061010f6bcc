// Building blocks shared by the hand-written transpose-conv kernels for
// sm_90a: the epilogue activation, the cp.async copies that stage tiles into
// shared memory (16-byte, or 4-byte for a ragged or unaligned channel run,
// zero-filled past the data), and the register micro-tile of the unified
// kernel-segregated form.
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
#pragma once

#include <cuda_runtime.h>

namespace tconv {

constexpr int kPW = 4;   // positions along a phase-plane row a thread

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

}  // namespace tconv
