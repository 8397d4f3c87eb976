// Integer-code IIR band-pass feature extractor (FEx) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/iir_fex.py::batched_iir_fex_int (pallas_call :275,
//   body _int_kernel :217; per-sample math
//   src/repro/core/fixed_point.py::int_fex_sample_step :576, compression
//   int_compress_env :605).
//
// What it computes.  The deployed FEx datapath on integer codes: for every
// (stream b, channel c), each Q0.11 audio code is widened to the Q2.13
// signal grid and advances two DF2T biquads with a symmetric numerator
// (b1 = 0, b2 = -b0).  Every product is rounded half up by a right shift
// onto the 16-bit register grid and every register is saturated to 16
// bits, in the order of int_fex_sample_step.  A full-wave rectifier on the
// Q0.15 grid feeds a one-pole low-pass envelope.  After every frame_shift
// samples the envelope code is log2-compressed onto the 12-bit feature
// grid (int_compress_env).  State (B, 5, C) int16 rows = [s0_1, s0_2,
// s1_1, s1_2, env] goes in and out, so chunk boundaries are invisible.
//
// What bounds it on this card.  Not bytes: a 4096-sample chunk of 256
// streams reads 2 MiB of int16 audio and writes 0.06 MiB of features.
// Not operations: about 50 integer operations per sample and channel.
// The recursion is the bound: each sample of a channel needs the previous
// sample's registers, so a chunk is 4096 dependent steps, each a chain of
// dependent multiply, add, shift and clamp instructions.
//
// What the design does about it.  One thread per (stream, channel), as in
// csrc/iir_fex.cu, keeps its five registers in int32 registers for the
// whole chunk and loops over the samples inside the kernel: no state
// traffic between samples or frames, one feature store per frame, the
// final state stored once.  The inner loop is unrolled so the compiler can
// start the next samples' loads ahead of the dependent chain.
//
// Numerics.  All arithmetic is int32 and exact; each value stays inside
// int32 (|b0·x| ≤ 2^11·2^13, the envelope blend is a convex combination
// of two 16-bit values times 2^15), and the additions that could wrap in
// principle are done in unsigned arithmetic, which wraps like XLA's int32
// instead of being undefined.  Right shifts of negative values are
// arithmetic, as in torch and XLA.  The one float step is the compression:
// XLA's log2 (xla_math.cuh) of the exact envelope code times 2^-env_frac,
// its scale by 1/ln 2 fused with the + log_range, a multiplication by
// float32(1 / log_range) (XLA's rewrite of the division by a constant), a
// clamp, rintf (half to even, like torch.round) and a saturation to 16
// bits, as the plain version and the JAX reference do it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Arithmetic right shift by s >= 1 with round-half-up.
__device__ __forceinline__ int32_t rshift_round(int32_t x, int s) {
  return wrap_add(x, 1 << (s - 1)) >> s;
}

__device__ __forceinline__ int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // min(max(v, lo), hi) that keeps NaN, like torch.clamp / jnp.clip.
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int32_t compress_env(int32_t env, int eps_code,
                                                float env_step,
                                                float log_range,
                                                float feat_scale,
                                                float feat_max) {
  const float e = static_cast<float>(wrap_add(env, eps_code)) * env_step;
  const float inv_range = 1.0f / log_range;   // correctly rounded
  float v = fmaf(xla_math::log(e), xla_math::f32(xla_math::kInvLn2Bits),
                 log_range) * inv_range;
  v = clamp_nan(v, -1.0f, feat_max);
  return sat16(static_cast<int32_t>(rintf(v * feat_scale)));
}

__global__ void iir_fex_int_kernel(
    const int16_t* __restrict__ x, const int32_t* __restrict__ coef,
    const int16_t* __restrict__ state_in, int16_t* __restrict__ feats,
    int16_t* __restrict__ state_out, int B, int T, int n_frames, int C,
    int frame_shift, int x_shift, int b_frac, int a_frac, int env_shift,
    int alpha_frac, int alpha_code, int eps_code, float env_step,
    float log_range, float feat_scale, float feat_max) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C;
  const int c = idx - b * C;

  const int32_t b0_0 = coef[0 * C + c], a1_0 = coef[1 * C + c];
  const int32_t a2_0 = coef[2 * C + c], b0_1 = coef[3 * C + c];
  const int32_t a1_1 = coef[4 * C + c], a2_1 = coef[5 * C + c];
  const int32_t nb0_0 = -b0_0, na1_0 = -a1_0, na2_0 = -a2_0;
  const int32_t nb0_1 = -b0_1, na1_1 = -a1_1, na2_1 = -a2_1;
  const int32_t x_mul = 1 << x_shift;      // x << x_shift without UB
  const int32_t env_mul = 1 << env_shift;
  const int32_t keep = (1 << alpha_frac) - alpha_code;

  const int16_t* s = state_in + static_cast<size_t>(b) * 5 * C + c;
  int32_t s0_1 = s[0], s0_2 = s[C], s1_1 = s[2 * C], s1_2 = s[3 * C];
  int32_t env = s[4 * C];

  const int16_t* xb = x + static_cast<size_t>(b) * T;
  int16_t* fb = feats + static_cast<size_t>(b) * n_frames * C + c;
  for (int f = 0; f < n_frames; ++f) {
    const int16_t* xf = xb + static_cast<size_t>(f) * frame_shift;
#pragma unroll 8
    for (int k = 0; k < frame_shift; ++k) {
      const int32_t xv = static_cast<int32_t>(xf[k]) * x_mul;   // Q2.13
      // section 0 (DF2T, symmetric numerator)
      const int32_t y0 = sat16(wrap_add(rshift_round(b0_0 * xv, b_frac),
                                        s0_1));
      const int32_t n0_1 = sat16(wrap_add(rshift_round(na1_0 * y0, a_frac),
                                          s0_2));
      const int32_t n0_2 = sat16(wrap_add(rshift_round(nb0_0 * xv, b_frac),
                                          rshift_round(na2_0 * y0, a_frac)));
      // section 1
      const int32_t y1 = sat16(wrap_add(rshift_round(b0_1 * y0, b_frac),
                                        s1_1));
      const int32_t n1_1 = sat16(wrap_add(rshift_round(na1_1 * y1, a_frac),
                                          s1_2));
      const int32_t n1_2 = sat16(wrap_add(rshift_round(nb0_1 * y0, b_frac),
                                          rshift_round(na2_1 * y1, a_frac)));
      // envelope: full-wave rectify on the Q0.15 grid + one-pole low-pass
      const int32_t y_env = sat16((y1 < 0 ? -y1 : y1) * env_mul);
      env = rshift_round(wrap_add(keep * env, alpha_code * y_env),
                         alpha_frac);
      s0_1 = n0_1;
      s0_2 = n0_2;
      s1_1 = n1_1;
      s1_2 = n1_2;
    }
    fb[static_cast<size_t>(f) * C] = static_cast<int16_t>(compress_env(
        env, eps_code, env_step, log_range, feat_scale, feat_max));
  }

  int16_t* so = state_out + static_cast<size_t>(b) * 5 * C + c;
  so[0] = static_cast<int16_t>(s0_1);
  so[C] = static_cast<int16_t>(s0_2);
  so[2 * C] = static_cast<int16_t>(s1_1);
  so[3 * C] = static_cast<int16_t>(s1_2);
  so[4 * C] = static_cast<int16_t>(env);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, T) int16, T >= n_frames * frame_shift; coef (6, C) int32;
// state_in and state_out (B, 5, C) int16; feats (B, n_frames, C) int16.
// All contiguous, on the current device.  x_shift = sig_frac - feat_frac,
// env_shift = env_frac - sig_frac (both in [0, 15]); b_frac, a_frac,
// alpha_frac >= 1.  env_step = 2^-env_frac, feat_scale = 2^feat_frac,
// feat_max = 1 - 2^-feat_frac.  Launches on `stream` and returns the
// launch's error.
extern "C" int iir_fex_int_launch(
    const int16_t* x, const int32_t* coef, const int16_t* state_in,
    int16_t* feats, int16_t* state_out, int B, int T, int n_frames, int C,
    int frame_shift, int x_shift, int b_frac, int a_frac, int env_shift,
    int alpha_frac, int alpha_code, int eps_code, float env_step,
    float log_range, float feat_scale, float feat_max, void* stream) {
  const int threads = 128;
  const int blocks = (B * C + threads - 1) / threads;
  iir_fex_int_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, coef, state_in, feats, state_out, B, T, n_frames, C, frame_shift,
      x_shift, b_frac, a_frac, env_shift, alpha_frac, alpha_code, eps_code,
      env_step, log_range, feat_scale, feat_max);
  return static_cast<int>(cudaGetLastError());
}
