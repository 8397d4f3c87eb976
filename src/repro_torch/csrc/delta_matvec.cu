// Block-sparse delta matvec for Hopper (sm_90a): out = m + Δx·W.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/delta_matvec.py::delta_matvec (pallas_call :73,
//   body _kernel :32; block mask make_block_mask :81).
//
// What it computes.  For a batch of delta vectors Δx (B, I), float32 or
// bfloat16, weights W (I, O) of the same type and a float32 accumulator
// m (B, O): out = m + Σ over the active input blocks of Δx_blk · W_blk.
// The I inputs fall into blocks of block_i; block_mask (one int32 per
// block) marks the blocks with any non-zero delta.  A masked-off block
// adds nothing, even where its deltas are non-zero, and its weight rows
// are never read.  Per active block the partial product is summed from 0
// in ascending input order and then added to the output, the order of
// the TPU kernel's `out += dot(dx_blk, w_blk)`; with one active block
// that is also delta_gru_seq's order, so the ΔGRU's block-sparse fallback
// reproduces the sequence kernel at the model's width.
//
// What bounds it on this card.  At the ΔGRU fallback's shapes (B = 256,
// O = 768) the accumulator in and out (0.8 MB each) bound it at I = 10
// (0.5 µs), and the 2·B·I·O ≈ 0.1 GFLOP on fp32 cores at I = 256
// (1.5 µs).  Skipping inactive blocks is the kernel's point: their
// weight tiles are not fetched and their products not formed.
//
// What the design does about it.  One CTA per (batch tile of 16 rows,
// output tile of 128 columns), one thread per column.  The CTA reads the
// mask from device memory (no host sync), and for each active block
// stages 32-row slices of the weight tile (32 × 128) and of the delta
// block (32 × 16, input-major) in shared memory; each thread keeps its
// 16 row accumulators in registers.  Simple and right first: no tensor
// cores, TMA or wgmma yet.
//
// Numerics.  Built with --fmad=false: every product rounds before its
// add.  bfloat16 operands are widened to float32 exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileB = 16;    // batch rows per CTA
constexpr int kTileO = 128;   // output columns per CTA (= threads)
constexpr int kTileK = 32;    // input rows staged per pass

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kTileO) delta_matvec_kernel(
    const T* __restrict__ dx, const T* __restrict__ w,
    const float* __restrict__ m, const int* __restrict__ mask,
    float* __restrict__ out, int B, int I, int O, int block_i) {
  __shared__ float w_s[kTileK][kTileO];
  // Input-major, so the kTileB deltas of one input are 16 contiguous
  // floats: four broadcast 16-byte loads per input, not sixteen.
  __shared__ __align__(16) float dx_s[kTileK][kTileB];
  const int t = threadIdx.x;
  const int o = blockIdx.x * kTileO + t;
  const int b0 = blockIdx.y * kTileB;
  const int rows = min(kTileB, B - b0);
  const bool col = o < O;

  float res[kTileB];
#pragma unroll
  for (int r = 0; r < kTileB; ++r) {
    res[r] = (col && r < rows) ? m[static_cast<size_t>(b0 + r) * O + o]
                               : 0.0f;
  }
  const int n_blocks = I / block_i;
  for (int blk = 0; blk < n_blocks; ++blk) {
    if (mask[blk] == 0) continue;           // uniform over the CTA
    float acc[kTileB];
#pragma unroll
    for (int r = 0; r < kTileB; ++r) acc[r] = 0.0f;
    const int k_end = (blk + 1) * block_i;
    for (int k0 = blk * block_i; k0 < k_end; k0 += kTileK) {
      const int kn = min(kTileK, k_end - k0);
      for (int kk = 0; kk < kn; ++kk) {
        w_s[kk][t] =
            col ? to_float(w[static_cast<size_t>(k0 + kk) * O + o]) : 0.0f;
      }
      for (int e = t; e < kTileB * kTileK; e += kTileO) {
        const int r = e / kTileK, kk = e - r * kTileK;
        dx_s[kk][r] = (r < rows && kk < kn)
                          ? to_float(dx[static_cast<size_t>(b0 + r) * I +
                                        k0 + kk])
                          : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = w_s[kk][t];
        const float4* d4 = reinterpret_cast<const float4*>(dx_s[kk]);
#pragma unroll
        for (int q = 0; q < kTileB / 4; ++q) {
          const float4 d = d4[q];
          acc[4 * q] += d.x * wv;
          acc[4 * q + 1] += d.y * wv;
          acc[4 * q + 2] += d.z * wv;
          acc[4 * q + 3] += d.w * wv;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kTileB; ++r) res[r] = res[r] + acc[r];
  }
  if (!col) return;
#pragma unroll
  for (int r = 0; r < kTileB; ++r) {
    if (r < rows) out[static_cast<size_t>(b0 + r) * O + o] = res[r];
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dx (B, I) and w (I, O): float32, or bfloat16 when is_bf16; m, out
// (B, O) float32; mask (I / block_i) int32.  All contiguous on the
// current device; I a multiple of block_i.  Launches on `stream` and
// returns the launch's error.
extern "C" int delta_matvec_launch(const void* dx, const void* w,
                                   const float* m, const int* mask,
                                   float* out, int B, int I, int O,
                                   int block_i, int is_bf16, void* stream) {
  const dim3 grid((O + kTileO - 1) / kTileO, (B + kTileB - 1) / kTileB);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    delta_matvec_kernel<__nv_bfloat16><<<grid, kTileO, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dx),
        static_cast<const __nv_bfloat16*>(w), m, mask, out, B, I, O,
        block_i);
  } else {
    delta_matvec_kernel<float><<<grid, kTileO, 0, s>>>(
        static_cast<const float*>(dx), static_cast<const float*>(w), m, mask,
        out, B, I, O, block_i);
  }
  return static_cast<int>(cudaGetLastError());
}
