// The float FEx's per-sample steps, shared by csrc/iir_fex.cu and its
// chain probe csrc/iir_fex_chain.cu.
//
// A DF2T biquad section with a symmetric numerator (b1 = 0, b2 = -b0) in
// the op order of the JAX reference as XLA:CPU compiles it: the products
// marked fmaf are fused into the following add, -(a2·y) is rounded on its
// own (the build's --fmad=false keeps it an FMUL), and denormals flush
// (--ftz=true).  The loop-carried chain is y = fmaf(b0, v, r1) →
// r1' = fmaf(-a1, y, r2): two dependent FFMAs per sample.
#pragma once

#include <cuda_runtime.h>

namespace fex {

struct Section {
  float b0, na1, nb0, a2;   // b0, -a1, -b0, a2
  float r1, r2;             // the DF2T registers s_1, s_2
  // Advance by one input sample v (the audio, or section 0's y0); returns y.
  __device__ __forceinline__ float operator()(float v) {
    const float y = fmaf(b0, v, r1);
    const float n1 = fmaf(na1, y, r2);
    r2 = fmaf(nb0, v, -(a2 * y));
    r1 = n1;
    return y;
  }
};

// The envelope: full-wave rectifier and one-pole low-pass,
// env' = (1 - alpha)·env + (alpha·|y1|), the product in parentheses
// rounded on its own.
__device__ __forceinline__ float envelope_step(float env, float y1,
                                               float one_minus_alpha,
                                               float alpha) {
  return fmaf(one_minus_alpha, env, alpha * fabsf(y1));
}

}  // namespace fex
