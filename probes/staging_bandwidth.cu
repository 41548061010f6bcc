// How fast 16-byte cp.async copies stage a weight stream into shared
// memory, by the order of the destination. Each block streams a 2 MB slice
// of a (16 taps, 1024 Cin, 512 Cout) HWIO fp32 kernel, 32 Cout wide (the
// pair kernel's head producer: 128-byte runs), through a 3-stage ring of
// 64 KB stages, copies only. "contiguous" writes consecutive threads'
// pieces to consecutive 16-byte slots (HWIO's order, [ci][tap][Cout]);
// "quad-major" writes them [Cout quad][ci][tap][4], a line's eight pieces
// 8 KB apart (bank-distinct for each eight threads).
//
// Build and run on the card (prints GB/s an SM at 16 and 112 blocks, one
// block an SM):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/staging_bandwidth probes/staging_bandwidth.cu
//   build/staging_bandwidth
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kCin = 1024, kCout = 512, kTaps = 16, kCi = 32, kCt = 32;
constexpr int kStages = kCin / kCi, kRing = 3;
constexpr int kStage = kCi * kTaps * kCt + 64;   // floats, with room for the pad

__device__ __forceinline__ void cp16(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(a), "l"(g) : "memory");
}

template <bool kQuadMajor>
__global__ void __launch_bounds__(256, 1) stream(const float* w, float* out) {
  extern __shared__ __align__(16) float sm[];
  const int co0 = (blockIdx.x % (kCout / kCt)) * kCt;
  const int tid = threadIdx.x;
  auto stage = [&](int st) {
    float* d = sm + (st % kRing) * kStage;
    for (int i = tid; i < kCi * kTaps * (kCt / 4); i += 256) {
      const int cq = i % (kCt / 4), tap = i / (kCt / 4) % kTaps, ci = i / (kCt / 4) / kTaps;
      const float* src = w + (static_cast<long long>(tap) * kCin + st * kCi + ci) * kCout +
                         co0 + 4 * cq;
      cp16(kQuadMajor ? d + cq * (kCi * kTaps * 4 + 4) + (ci * kTaps + tap) * 4 : d + i * 4,
           src);
    }
  };
  float acc = 0.f;
  for (int s = 0; s < kRing - 1; ++s) {
    stage(s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int k = 0; k < kStages; ++k) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (k + kRing - 1 < kStages) stage(k + kRing - 1);
    asm volatile("cp.async.commit_group;\n");
    acc += sm[(k % kRing) * kStage + tid];
  }
  if (acc == 12345.f) out[0] = acc;   // keeps the copies
}

template <class K>
void run(const char* name, K kernel, const float* w, float* out, int blocks) {
  const int smem = kRing * kStage * 4;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int i = 0; i < 3; ++i) kernel<<<blocks, 256, smem>>>(w, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) kernel<<<blocks, 256, smem>>>(w, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double us = ms * 1e3 / 20;
  const double bytes = static_cast<double>(kCin) * kTaps * kCt * 4;   // a block's slice
  printf("%-11s blocks %3d: %7.1f us, %5.1f GB/s an SM (%s)\n", name, blocks, us,
         bytes / us * 1e-3, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
  float *w, *out;
  const size_t n = static_cast<size_t>(kTaps) * kCin * kCout;
  cudaMalloc(&w, n * 4);
  cudaMalloc(&out, 4);
  cudaMemset(w, 0, n * 4);
  for (int blocks : {16, 112}) {
    run("contiguous", stream<false>, w, out, blocks);
    run("quad-major", stream<true>, w, out, blocks);
  }
  cudaFree(w);
  cudaFree(out);
  return 0;
}
