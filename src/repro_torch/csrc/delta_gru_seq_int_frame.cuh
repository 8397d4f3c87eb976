// The integer ΔGRU's per-frame steps, shared by csrc/delta_gru_seq_int.cu
// and its chain probe csrc/delta_gru_seq_int_chain.cu: the Δ encoder, a
// thread's share of its four columns' sums over the transmitted rows, the
// reduce-scatter that gives each of four lanes one column's whole sum,
// the alignment and saturation onto the accumulator grid, and the gates.
//
// All integer sums are uint32_t wrapping adds, exact in any order (XLA's
// int32 wraps the same way), so a column's sum may be split over lanes and
// recombined.  The gates are gru_frame_step's (src/repro_torch/core/
// fixed_point.py::int_gru_gates) in its op order, on XLA's σ / tanh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace gru_int {

constexpr int kSplit = 4;    // lanes that share one group of kCols columns
constexpr int kCols = 4;     // adjacent columns per thread: a 32-bit word
                             // of int8 weights

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// align(x, shift): shift >= 0 an exact left shift (wrapping), < 0 a
// round-half-up arithmetic right shift.
__device__ __forceinline__ int32_t align(int32_t x, int shift) {
  if (shift >= 0) {
    return static_cast<int32_t>(static_cast<uint32_t>(x) << shift);
  }
  const int s = -shift;
  return wrap_add(x, 1 << (s - 1)) >> s;
}

__device__ __forceinline__ int32_t sat(int32_t x, int32_t lim) {
  return x < -lim ? -lim : (x > lim - 1 ? lim - 1 : x);
}

// Δ encoder: transmit iff |v - v̂| > th; then v̂ = v and d = v - v̂.
__device__ __forceinline__ bool encode(int32_t v, int32_t& hat, int32_t th,
                                       int32_t& d) {
  const int32_t diff = v - hat;
  const bool sent = (diff < 0 ? -diff : diff) > th;
  d = sent ? diff : 0;
  if (sent) hat = v;
  return sent;
}

// Signed byte i of w as an int32: one PRMT, its selector's high bits
// replicating the byte's sign.
template <int i>
__device__ __forceinline__ int32_t sbyte(uint32_t w) {
  constexpr unsigned sel = i | (0x8u | i) << 4 | (0x8u | i) << 8 |
                           (0x8u | i) << 12;
  int32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "n"(sel));
  return r;
}

// One transmitted row: d times the row's four int8 weights in w, added to
// the four column sums (|d·w| <= 2^16·2^7, exact in int32).
__device__ __forceinline__ void mac4(uint32_t (&p)[kCols], int32_t d,
                                     uint32_t w) {
  p[0] += static_cast<uint32_t>(d * sbyte<0>(w));
  p[1] += static_cast<uint32_t>(d * sbyte<1>(w));
  p[2] += static_cast<uint32_t>(d * sbyte<2>(w));
  p[3] += static_cast<uint32_t>(d * sbyte<3>(w));
}

// This lane's share of its column group's sums over a compacted list of
// n transmitted rows, each entry (Δ, byte offset of the row's weights):
// rows split, rows s, s + kSplit, ... to split s.  `w` points at the
// group's first column of row 0.
__device__ __forceinline__ void row_sums(uint32_t (&p)[kCols],
                                         const int2* list, int n, int s,
                                         const unsigned char* w) {
#pragma unroll 1
  for (int k = s; k < n; k += kSplit) {
    const int2 e = list[k];
    mac4(p, e.x, *reinterpret_cast<const uint32_t*>(w + e.y));
  }
}

// The four lanes of a group (lane % 4 = s) each hold partial sums of the
// same four columns; afterwards lane s holds column s's whole sum.  Two
// exchange steps, three shuffles.
__device__ __forceinline__ uint32_t reduce_scatter(const uint32_t (&p)[kCols],
                                                   int s) {
  const bool hi = s & 2;
  const uint32_t keep0 = hi ? p[2] : p[0], keep1 = hi ? p[3] : p[1];
  const uint32_t send0 = hi ? p[0] : p[2], send1 = hi ? p[1] : p[3];
  const uint32_t k0 = keep0 + __shfl_xor_sync(0xffffffffu, send0, 2);
  const uint32_t k1 = keep1 + __shfl_xor_sync(0xffffffffu, send1, 2);
  const bool odd = s & 1;
  const uint32_t keep = odd ? k1 : k0, send = odd ? k0 : k1;
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}

// m' = sat(m + align(p, shift)) on the acc_bits grid: once per frame,
// after the whole column sum.
__device__ __forceinline__ int32_t accumulate(int32_t m, uint32_t p,
                                              int shift, int32_t lim) {
  return sat(wrap_add(m, align(static_cast<int32_t>(p), shift)), lim);
}

struct GateConsts {
  int hid_frac;
  int32_t one;        // 2^hid_frac
  float one_f, inv_one, step;   // 2^hid_frac, 2^-hid_frac, 2^-acc_frac
};

// Type-2 GRU gates for one unit from its six accumulators (x and h halves
// of r, u and the candidate) and its h code; returns h' (ideal-LUT σ /
// tanh, requantized to the Q0.hid grid).
__device__ __forceinline__ int32_t gates(int32_t mxr, int32_t mhr,
                                         int32_t mxu, int32_t mhu,
                                         int32_t mxc, int32_t mhc, int32_t h,
                                         const GateConsts& g) {
  const float pr = static_cast<float>(wrap_add(mxr, mhr)) * g.step;
  const float pu = static_cast<float>(wrap_add(mxu, mhu)) * g.step;
  const int32_t r =
      static_cast<int32_t>(rintf(xla_math::sigmoid(pr) * g.one_f));
  const int32_t u =
      static_cast<int32_t>(rintf(xla_math::sigmoid(pu) * g.one_f));
  const float c_pre = (static_cast<float>(mxc) +
                       static_cast<float>(r) * static_cast<float>(mhc) *
                           g.inv_one) *
                      g.step;
  const int32_t c =
      static_cast<int32_t>(rintf(xla_math::tanh(c_pre) * g.one_f));
  // |u·h + (one - u)·c| <= 2^hid · 2^15: a convex combination of two
  // values within 2^15, so it stays inside int32 for hid <= 15.
  const int32_t blend = u * h + (g.one - u) * c;
  return sat(wrap_add(blend, 1 << (g.hid_frac - 1)) >> g.hid_frac, 32768);
}

}  // namespace gru_int
