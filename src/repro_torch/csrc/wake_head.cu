// The cascade's wake head fused over a chunk of frames, for Hopper
// (sm_90a): stage 0's event posterior (softmax of its logits, class 1)
// → the wake / sleep / hangover machine.
//
// No Pallas kernel to replace: in the JAX package this is plain JAX that
// XLA fuses into the cascade step (jax.nn.softmax(...)[..., 1] in
// src/repro/launch/streaming.py::_process_audio_chunk_cascade :712, then
// cascade_wake_scan :197, a lax.scan).  In eager PyTorch the softmax on
// XLA's exp alone costs ~256 launches (each of exp's nine fused
// multiply-adds is ~18 elementwise ops in the plain version) and the
// wake machine ~40 in closed form; this kernel runs both in one.  Its
// plain version is src/repro_torch/kernels/wake_head.py::wake_head_ref.
//
// What it computes, per slot b and frame f (K classes):
//   m = max_k x_k (NaN if any is NaN);  e_k = exp(x_k − m);
//   p = e_1 / Σ_k e_k  (the sum class by class, XLA:CPU's order for
//       K <= 32);
//   wake = p >= W;  hold = awake ∧ p >= S;
//   awake ← wake ∨ hold ∨ (awake ∧ hang > 0);
//   hang ← wake ∨ hold ? HF : max(hang − 1, 0);  trace[f, b] = awake.
//
// What bounds it on this card.  The frames of a slot form one dependent
// chain through (awake, hang), and at the serving widths (B <= 256 slots,
// K = 2) the card is mostly idle: a launch is its chain of F frame steps
// (a max, K exps side by side, the sum, a division and a few compares)
// plus the launch itself.  Bytes (F·B·K floats in, F·B bytes out) are far
// below a microsecond of HBM time.
//
// What the design does about it.  The simple design: one thread per slot,
// K exps of a frame independent of each other, the next frame's logits
// loaded while a frame is computed.  Reads of a frame are coalesced
// across the slots of a warp.
//
// Numerics.  Built with --fmad=false and --ftz=true: exp is XLA's own
// (xla_math.cuh), the division a true IEEE division, every result below
// 2^-126 flushed as XLA:CPU flushes it, the max keeps NaN, and every
// comparison is false on NaN, as in JAX.  The thresholds are compared as
// float32, as JAX compares a float32 posterior with a Python float.  The
// outputs equal the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

constexpr int kMaxClasses = 32;  // XLA:CPU sums up to 32 classes in order
constexpr int kMaxThreads = 128;

struct Args {
  const float* logits;    // (F, B, K)
  const uint8_t* awake0;  // (B,)
  const int* hang0;       // (B,)
  float wake, sleep;
  int hangover;
  uint8_t* trace;         // (F, B)
  uint8_t* awake;         // (B,)
  int* hang;              // (B,)
  int F, B, K;
};

// jnp.max of two values: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// KS > 0: K == KS, known to the compiler (the binary stage-0 head, whose
// logits then stay in registers); KS == 0: any K up to kMaxClasses.
template <int KS>
__global__ void __launch_bounds__(kMaxThreads) wake_head_kernel(
    const Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int K = KS > 0 ? KS : a.K;
  const size_t stride = static_cast<size_t>(a.B) * K;
  const float* row = a.logits + static_cast<size_t>(b) * K;
  bool awake = a.awake0[b] != 0;
  int hang = a.hang0[b];
  float next[kMaxClasses];
#pragma unroll
  for (int k = 0; k < K; ++k) next[k] = a.F > 0 ? row[k] : 0.0f;
  for (int f = 0; f < a.F; ++f) {
    float x[kMaxClasses];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = next[k];
      if (f + 1 < a.F) next[k] = row[(f + 1) * stride + k];
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) m = nan_max(m, x[k]);
    float sum = 0.0f, e1 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = xla_math::exp(x[k] - m);
      sum = k == 0 ? e : sum + e;
      if (k == 1) e1 = e;
    }
    const float p = e1 / sum;
    const bool wake = p >= a.wake;
    const bool hold = awake && p >= a.sleep;
    awake = wake || hold || (awake && hang > 0);
    hang = (wake || hold) ? a.hangover : (hang - 1 > 0 ? hang - 1 : 0);
    a.trace[static_cast<size_t>(f) * a.B + b] = awake ? 1 : 0;
  }
  a.awake[b] = awake ? 1 : 0;
  a.hang[b] = hang;
}

// The launch floor under the kernel: an empty kernel at its launch shape.
__global__ void floor_kernel() {}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// logits (F, B, K) float32; awake0 / awake (B,) and trace (F, B) uint8
// (bool); hang0 / hang (B,) int32; all contiguous on the current device.
// Launches the wrapper's plan (grid CTAs of `block` threads, one thread
// per slot) on `stream` and returns the launch's error, or
// cudaErrorInvalidValue for a shape or plan this kernel cannot run.
extern "C" int wake_head_launch(const float* logits, const uint8_t* awake0,
                                const int* hang0, float wake, float sleep,
                                int hangover, uint8_t* trace, uint8_t* awake,
                                int* hang, int F, int B, int K, int grid,
                                int block, void* stream) {
  if (K < 2 || K > kMaxClasses || F < 0 || B < 1 || hangover < 0 ||
      block < 32 || block > kMaxThreads || block % 32 != 0 ||
      static_cast<long long>(grid) * block < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{logits, awake0, hang0, wake, sleep, hangover,
                  trace, awake, hang, F, B, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2) {
    wake_head_kernel<2><<<grid, block, 0, s>>>(args);
  } else {
    wake_head_kernel<0><<<grid, block, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches floor_kernel with the kernel's launch shape on `stream`.
extern "C" int wake_head_floor_launch(int grid, int block, void* stream) {
  floor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
