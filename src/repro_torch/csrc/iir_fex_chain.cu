// Latency probe for the float FEx kernel's recursion (csrc/iir_fex.cu).
//
// One warp runs the kernel's own section step (iir_fex_section.cuh) n
// times on register operands: no shared-memory traffic, no other warp on
// the SM, the inputs fixed in registers.  The cycles and nanoseconds per
// step are then the latency of the loop-carried chain alone (two
// dependent FFMAs), the least time a sample can take, so 4096 steps are
// the chain bound of a 4096-sample chunk.
#include <cuda_runtime.h>

#include "iir_fex_section.cuh"

namespace {

__global__ void chain_kernel(int n, float b0, float a1, float a2,
                             long long* out, float* sink) {
  fex::Section sec;
  sec.b0 = b0;
  sec.na1 = -a1;
  sec.nb0 = -b0;
  sec.a2 = a2;
  sec.r1 = 1e-3f * static_cast<float>(threadIdx.x);
  sec.r2 = 0.0f;
  float v[8];                          // the inputs, fixed
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = 0.01f * static_cast<float>(threadIdx.x % 7 + j) - 0.03f;
  }
  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sec(v[j]);
  }
  const long long c1 = clock64();
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
  }
  sink[threadIdx.x] = sec.r1 + sec.r2;   // keeps the chain
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs n (a multiple of 8) chain steps with coefficients b0, a1, a2 on
// one warp, synchronously; out[0] = cycles, out[1] = nanoseconds.
// Returns the launch's or the copy's error.
extern "C" int iir_fex_chain(int n, float b0, float a1, float a2,
                             long long* out) {
  long long* d = nullptr;
  float* sink = nullptr;
  cudaError_t err = cudaMalloc(&d, 2 * sizeof(long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(&sink, 32 * sizeof(float));
  if (err == cudaSuccess) {
    chain_kernel<<<1, 32>>>(n, b0, a1, a2, d, sink);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    err = cudaMemcpy(out, d, 2 * sizeof(long long), cudaMemcpyDeviceToHost);
  }
  cudaFree(sink);
  cudaFree(d);
  return static_cast<int>(err);
}
