// The float ΔGRU's per-frame steps, shared by csrc/delta_gru_seq.cu, the
// one-frame csrc/delta_gru_cell.cu and the chain probe
// csrc/delta_gru_seq_chain.cu: the Δ encoder, the per-warp compaction of
// the transmitted components into (Δ, weight-row offset) lists, a column's
// sum over such a list, and the type-2 gates (σ in the thread of each
// gate column, then the candidate and the blend).
//
// The sum order is the reference's and delta_matvec's: each column sums
// its transmitted rows in ascending index order, starting from 0.0f, one
// rounded product and one add per row (the libraries are built with
// --fmad=false), the x and h halves apart.  Per-warp segments read in warp
// order keep that order, so a sum may continue from one segment to the
// next.  The gates are XLA's σ / tanh (xla_math.cuh) with r·M_hc and u·h
// fused, as XLA:CPU fuses them (kernels/gru_math.py::gru_gates).
#pragma once

#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace gru_f {

// One transmitted component: its delta and the offset, in floats, of its
// weight row from the weights' base.
struct __align__(8) Row {
  float d;
  int off;
};

// Δ encoder: transmit iff |v - v̂| > th (a NaN never transmits); then
// v̂ = v and d = v - v̂, else d = 0 and v̂ stays.
__device__ __forceinline__ bool encode(float v, float& hat, float th,
                                       float& d) {
  const float diff = v - hat;
  const bool sent = fabsf(diff) > th;
  d = sent ? diff : 0.0f;
  if (sent) hat = v;
  return sent;
}

// Warp-wide: each lane whose component was sent writes (d, off) to
// list[base + r], r the number of sending lanes below it, so the segment
// is in ascending component order.  Returns the warp's count.
__device__ __forceinline__ int compact(bool sent, float d, int off,
                                       Row* list, int base) {
  unsigned below;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(below));
  const unsigned m = __ballot_sync(0xffffffffu, sent);
  if (sent) list[base + __popc(m & below)] = Row{d, off};
  return __popc(m);
}

// acc plus the sum over the n rows of a list, in list order: `w` points at
// this thread's column of row 0 (a product, then an add, per row).
// Unrolled by two, so two rows' loads are in flight at once.
__device__ __forceinline__ float column_sum(float acc, const Row* list,
                                            int n, const float* w) {
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const Row e = list[k];
    acc = acc + e.d * w[e.off];
  }
  return acc;
}

// σ of a gate column's pre-activation (r or u), taken by the thread that
// summed the column.
__device__ __forceinline__ float gate_sigmoid(float mx, float mh) {
  return xla_math::sigmoid(mx + mh);
}

// The rest of the type-2 gates for one unit: the candidate from r and its
// column's two pre-activations, then the blend with u; returns h'.
__device__ __forceinline__ float candidate_blend(float r, float u, float mxc,
                                                 float mhc, float h) {
  const float c = xla_math::tanh(fmaf(r, mhc, mxc));
  return fmaf(u, h, (1.0f - u) * c);
}

}  // namespace gru_f
