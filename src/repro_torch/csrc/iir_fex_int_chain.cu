// Latency probe for the integer FEx kernel's recursion (csrc/iir_fex_int.cu).
//
// One warp runs the kernel's own section step (iir_fex_int_section.cuh)
// n times on register operands: no shared-memory traffic, no other warp
// on the SM, and the feed-forward operands formed off the chain.  The
// cycles and nanoseconds per step are then the latency of the loop-carried
// chain alone (VIADDMNMX, IMAD, SHF, VIADDMNMX), the least time a sample
// can take, so 4096 steps are the chain bound of a 4096-sample chunk.
#include <cuda_runtime.h>
#include <stdint.h>

#include "iir_fex_int_section.cuh"

namespace {

using namespace fex_int;

__global__ void chain_kernel(int n, int32_t a1, int32_t a2, int s,
                             long long* out) {
  Section<> sec;
  sec.na1 = opaque(-a1);
  sec.na2 = opaque(-a2);
  sec.k1 = off_round(sec.na1, s);
  sec.k2 = off_round(sec.na2, s);
  sec.s = s;
  sec.r1 = kOff + static_cast<int32_t>(threadIdx.x);
  sec.r2 = kOff;
  int2 pq[8];                          // feed-forward operands, fixed
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pq[j] = make_int2(static_cast<int32_t>(threadIdx.x) * 37 + j * 101 - 400,
                      kOff + j * 13);
  }
  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sec(pq[j]);
  }
  const long long c1 = clock64();
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = sec.r1 + sec.r2;           // keeps the chain
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs n (a multiple of 8) chain steps with coefficient codes a1, a2 and
// shift s on one warp, synchronously; out[0] = cycles, out[1] = nanoseconds, out[2] a
// checksum.  Returns the launch's or the copy's error.
extern "C" int iir_fex_int_chain(int n, int a1, int a2, int s,
                                 long long* out) {
  long long* d = nullptr;
  cudaError_t err = cudaMalloc(&d, 3 * sizeof(long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_kernel<<<1, 32>>>(n, a1, a2, s, d);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaMemcpy(out, d, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  }
  cudaFree(d);
  return static_cast<int>(err);
}
