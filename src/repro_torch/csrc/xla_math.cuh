// XLA:CPU's float32 transcendentals, op for op, for the port's kernels.
//
// The JAX reference computes sigmoid, tanh, exp and log2 through XLA's own
// expansions (read from `XLA_FLAGS=--xla_dump_to=DIR`: the op sequence and
// constants in `*.ir-with-opt.ll`, the fused multiply-adds in the object
// file); `src/repro_torch/kernels/xla_math.py` is the same code as PyTorch
// ops and says where each piece comes from.  Every fmaf() here is a place
// where XLA's LLVM backend contracts a product into the following add;
// every other product rounds on its own, which needs the kernels built
// with --fmad=false.  XLA:CPU flushes denormals (FTZ + DAZ); the kernels
// are built with --ftz=true, which does the same to every float op.
#pragma once

#include <cuda_runtime.h>

namespace xla_math {

// The float32 with these bits (the constants are XLA's, bit for bit).
__device__ __forceinline__ float f32(unsigned bits) {
  return __uint_as_float(bits);
}

// min(max(v, lo), hi) that keeps NaN, as XLA's clamp.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// jnp.exp: Cephes exp, 2^n built in the exponent bits.
__device__ __forceinline__ float exp(float x) {
  x = clamp(x, f32(0xC2AF999Au), f32(0x42B1999Au));
  float n = floorf(fmaf(x, f32(0x3FB8AA3Bu), 0.5f));
  n = clamp(n, -127.0f, 127.0f);
  x = fmaf(n, -f32(0x3F318000u), x);
  x = fmaf(n, -f32(0xB95E8083u), x);
  float z = fmaf(x, f32(0x39506967u), f32(0x3AB743CEu));
  z = fmaf(z, x, f32(0x3C088908u));
  z = fmaf(z, x, f32(0x3D2AA9C1u));
  z = fmaf(z, x, f32(0x3E2AAAAAu));
  z = fmaf(z, x, 0.5f);
  z = fmaf(z, x * x, x) + 1.0f;
  const int n_int = static_cast<int>(n);  // NaN → 0; z is NaN then anyway
  return z * __int_as_float((n_int + 127) << 23);
}

// jax.nn.sigmoid: 1 / (1 + exp(-x)), a true division.
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (xla_math::exp(-x) + 1.0f);
}

// jnp.tanh: XLA's odd rational approximation on the clamped input.
__device__ __forceinline__ float tanh(float x) {
  const float a = fabsf(x);
  const float c = clamp(x, -f32(0x40FFF644u), f32(0x40FFF644u));
  const float x2 = c * c;
  float num = fmaf(x2, f32(0xA59F25C0u), f32(0x2A61337Eu));
  num = fmaf(x2, num, f32(0xAEBD37FFu));
  num = fmaf(x2, num, f32(0x335C0041u));
  num = fmaf(x2, num, f32(0x3779434Au));
  num = fmaf(x2, num, f32(0x3A270DEDu));
  num = fmaf(x2, num, f32(0x3BA059DCu));
  num = c * num;
  float den = fmaf(x2, f32(0x35A0D3D8u), f32(0x38F895D6u));
  den = fmaf(x2, den, f32(0x3B14AA05u));
  den = fmaf(x2, den, f32(0x3BA059DDu));
  float r = a < f32(0x39D1B717u) ? x : num / den;
  return a >= 20.0f ? copysignf(1.0f, x) : r;
}

// jnp.log: Cephes log on the mantissa in [0.5, 1).
__device__ __forceinline__ float log(float x) {
  const float tiny = f32(0x00800000u);
  const float t = x > tiny ? x : tiny;
  const int bits = __float_as_int(t);
  float e = static_cast<float>((bits >> 23) - 127) + 1.0f;
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool low = m < f32(0x3F3504F3u);
  const float xm = (m - 1.0f) + (low ? m : 0.0f);
  e = e - (low ? 1.0f : 0.0f);
  const float x2 = xm * xm;
  const float x3 = x2 * xm;
  float y = fmaf(fmaf(xm, f32(0x3D9021BBu), f32(0xBDEBD1B8u)), xm,
                 f32(0x3DEF251Au));
  const float y1 = fmaf(fmaf(xm, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)), xm,
                        f32(0xBE2AAE50u));
  const float y2 = fmaf(fmaf(xm, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)), xm,
                        f32(0x3EAAAAAAu));
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, e * f32(0xB95E8083u));
  float r = fmaf(x2, -0.5f, xm) + y;
  r = fmaf(e, f32(0x3F318000u), r);
  if (!(x > 0.0f)) r = f32(0x7FC00000u);  // x <= 0 or NaN
  if (x == 0.0f) r = -f32(0x7F800000u);
  if (x == f32(0x7F800000u)) r = x;
  return r;
}

// 1.44269502f, the constant XLA multiplies log by for jnp.log2.
constexpr unsigned kInvLn2Bits = 0x3FB8AA3B;

__device__ __forceinline__ float log2(float x) {
  return xla_math::log(x) * f32(kInvLn2Bits);
}

}  // namespace xla_math
