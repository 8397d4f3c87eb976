// The integer FEx's section recursion on offset registers, shared by
// csrc/iir_fex_int.cu and its chain probe csrc/iir_fex_int_chain.cu.
//
// A 16-bit register code r is carried as r + 2^15 in [0, 65535], so that
// sat16(a + r) + 2^15 is one instruction: Hopper's VIADDMNMX with a relu
// (add, min with 65535, max with 0).  A product with an offset value,
// a·(y + 2^15), is corrected by the constant -a·2^15 folded into the
// rounding addend of its multiply-add.  All of it is exact modulo 2^32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fex_int {

constexpr int32_t kOff = 32768;    // a register code + 2^15, in [0, 65535]
constexpr int32_t kTop = 65535;

// A constant the compiler must not rewrite: it would otherwise turn
// (-a)·y into a·(-y), a negation on the recursion's chain.
__device__ __forceinline__ int32_t opaque(int32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// (a·v + k) >> s with a wrapping multiply-add: rshift_round(a·y, s) when
// k = 2^(s-1) - a·2^15 and v = y + 2^15 (the product and the add wrap as
// XLA's int32 does, so the bits are the same).
__device__ __forceinline__ int32_t mul_shift(int32_t a, int32_t v, int32_t k,
                                             int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                                  static_cast<uint32_t>(v) +
                              static_cast<uint32_t>(k)) >> s;
}

// sat16(a + b) + 2^15 for an offset operand b + 2^15: one VIADDMNMX
// (add, min with 65535, max with 0).  Exact while the sum does not pass
// 2^31: each operand is a product shifted right by b_frac or a_frac
// bits (plus at most 2^16), so it holds unless both shifts are one bit.
__device__ __forceinline__ int32_t sat_add_off(int32_t a, int32_t b_off) {
  return __viaddmin_s32_relu(a, b_off, kTop);
}

// The same for any a and b in [-2^30, 2^30), the range of products
// shifted by one bit: a + b does not wrap, and is clamped to 16 bits
// before the offset goes back on.
__device__ __forceinline__ int32_t sat_add_off_wide(int32_t a,
                                                    int32_t b_off) {
  return min(max(a + (b_off - kOff), -kOff), kOff - 1) + kOff;
}

// k for mul_shift on an offset input: 2^(s-1) - a·2^15, modulo 2^32.
__device__ __forceinline__ int32_t off_round(int32_t a, int s) {
  return static_cast<int32_t>((1u << (s - 1)) -
                              static_cast<uint32_t>(a) * 32768u);
}

// One DF2T section on offset registers: y = sat16(P + r1), r1' =
// sat16(rshift_round(-a1·y) + r2), r2' = sat16(Q + rshift_round(-a2·y)).
// The loop-carried chain is VIADDMNMX, IMAD, SHF, VIADDMNMX.  kWide: the
// format whose b and a shifts are both one bit, where Q + 2^15 plus a
// shifted product could pass 2^31.
template <bool kWide = false>
struct Section {
  int32_t na1, k1, na2, k2, s;
  int32_t r1, r2;                      // registers + 2^15
  __device__ __forceinline__ int32_t operator()(int2 pq) {
    const int32_t y = sat_add_off(pq.x, r1);
    const int32_t n1 = sat_add_off(mul_shift(na1, y, k1, s), r2);
    const int32_t t2 = mul_shift(na2, y, k2, s);
    r2 = kWide ? sat_add_off_wide(t2, pq.y) : sat_add_off(t2, pq.y);
    r1 = n1;
    return y;
  }
};

}  // namespace fex_int
