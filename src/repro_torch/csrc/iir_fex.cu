// Batched IIR band-pass feature extractor (FEx) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/iir_fex.py::batched_iir_fex (pallas_call :187,
//   body _kernel :124; per-sample math fex_sample_step :59,
//   compression compress_env :82).
//
// What it computes.  For every (stream b, channel c): each audio sample
// advances two DF2T biquads with a symmetric numerator (b1 = 0,
// b2 = -b0) and a full-wave-rectify one-pole envelope; after every
// frame_shift samples the envelope is log2-compressed, normalised and
// quantised to the 12-bit Q0.11 grid (or emitted raw when compress = 0).
// State (B, 5, C) rows = [s0_1, s0_2, s1_1, s1_2, env] goes in and out,
// so chunk boundaries are invisible.
//
// What bounds it on this card.  Not bytes: a 4096-sample chunk of 256
// streams reads 4 MiB and writes 0.1 MiB (about 1.3 us at 3.35 TB/s).
// Not arithmetic: about 18 fp32 operations per sample and channel (about
// 2.8 us at 67 TFLOP/s).  The bound that matters is the recursion: each
// sample of a channel needs the previous sample's registers, so a chunk
// is 4096 dependent steps, each a chain of dependent multiplies and adds.
//
// What the design does about it.  One thread per (stream, channel) keeps
// its 5 state values in registers for the whole chunk and loops over the
// samples inside the kernel: no state traffic between samples or frames,
// one feature store per frame, the final state stored once.  Streams and
// channels are the parallel axes; the TPU kernel's state DMA double
// buffer (_state_pipeline, iir_fex.py:94) has no counterpart because the
// state never leaves registers.
//
// Numerics: those of the JAX reference as XLA compiles it on the CPU.
// Its scan body fuses seven products into the following add or subtract
// (of a difference of two products, the first); those are fmaf() below,
// and the build's --fmad=false keeps every other product rounded on its
// own.  XLA flushes denormals, and so does the build's --ftz=true, so a
// register decaying in silence reaches 0 at the same sample.  The
// compression is XLA's log2 (xla_math.cuh), its scale by 1/ln 2 fused
// with the + 11, and a multiplication by float32(1/11).  rintf rounds half
// to even like torch.round; the clamps propagate NaN like torch.clamp.
// 1 - env_alpha and log_eps arrive as floats rounded on the host, as the
// reference folds its Python constants to float32.
#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace {

constexpr float kFeatStep = 0.00048828125f;  // 2^-11, the 12-bit grid step
constexpr float kLogRange = 11.0f;
constexpr float kInvLogRange = 1.0f / 11.0f;  // correctly rounded

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // min(max(v, lo), hi) that keeps NaN, like torch.clamp / jnp.clip.
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float compress_env(float env, float log_eps) {
  float v = fmaf(xla_math::log(env + log_eps),
                 xla_math::f32(xla_math::kInvLn2Bits), kLogRange) *
            kInvLogRange;
  v = clamp_nan(v, -1.0f, 1.0f - kFeatStep);
  return clamp_nan(rintf(v / kFeatStep) * kFeatStep, -1.0f, 1.0f - kFeatStep);
}

__global__ void iir_fex_kernel(const float* __restrict__ x,
                               const float* __restrict__ coef,
                               const float* __restrict__ state_in,
                               float* __restrict__ feats,
                               float* __restrict__ state_out, int B, int T,
                               int n_frames, int C, int frame_shift,
                               float env_alpha, float one_minus_alpha,
                               float log_eps, int compress) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C;
  const int c = idx - b * C;

  const float b0_0 = coef[0 * C + c], a1_0 = coef[1 * C + c];
  const float a2_0 = coef[2 * C + c], b0_1 = coef[3 * C + c];
  const float a1_1 = coef[4 * C + c], a2_1 = coef[5 * C + c];
  const float nb0_0 = -b0_0, na1_0 = -a1_0, nb0_1 = -b0_1, na1_1 = -a1_1;

  const float* s = state_in + static_cast<size_t>(b) * 5 * C + c;
  float s0_1 = s[0], s0_2 = s[C], s1_1 = s[2 * C], s1_2 = s[3 * C];
  float env = s[4 * C];

  const float* xb = x + static_cast<size_t>(b) * T;
  float* fb = feats + static_cast<size_t>(b) * n_frames * C + c;
  for (int f = 0; f < n_frames; ++f) {
    const float* xf = xb + static_cast<size_t>(f) * frame_shift;
    for (int k = 0; k < frame_shift; ++k) {
      const float xv = xf[k];
      // section 0 (DF2T, symmetric numerator)
      const float y0 = fmaf(b0_0, xv, s0_1);
      const float n0_1 = fmaf(na1_0, y0, s0_2);
      const float n0_2 = fmaf(nb0_0, xv, -(a2_0 * y0));
      // section 1
      const float y1 = fmaf(b0_1, y0, s1_1);
      const float n1_1 = fmaf(na1_1, y1, s1_2);
      const float n1_2 = fmaf(nb0_1, y0, -(a2_1 * y1));
      // envelope: full-wave rectifier + one-pole low-pass
      env = fmaf(one_minus_alpha, env, env_alpha * fabsf(y1));
      s0_1 = n0_1;
      s0_2 = n0_2;
      s1_1 = n1_1;
      s1_2 = n1_2;
    }
    fb[static_cast<size_t>(f) * C] = compress ? compress_env(env, log_eps) : env;
  }

  float* so = state_out + static_cast<size_t>(b) * 5 * C + c;
  so[0] = s0_1;
  so[C] = s0_2;
  so[2 * C] = s1_1;
  so[3 * C] = s1_2;
  so[4 * C] = env;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, T) f32, T >= n_frames * frame_shift; coef (6, C); state_in and
// state_out (B, 5, C); feats (B, n_frames, C).  All contiguous, on the
// current device.  Launches on `stream` and returns the launch's error.
extern "C" int iir_fex_launch(const float* x, const float* coef,
                              const float* state_in, float* feats,
                              float* state_out, int B, int T, int n_frames,
                              int C, int frame_shift, float env_alpha,
                              float one_minus_alpha, float log_eps,
                              int compress, void* stream) {
  const int threads = 128;
  const int blocks = (B * C + threads - 1) / threads;
  iir_fex_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, coef, state_in, feats, state_out, B, T, n_frames, C, frame_shift,
      env_alpha, one_minus_alpha, log_eps, compress);
  return static_cast<int>(cudaGetLastError());
}
