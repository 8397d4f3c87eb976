// The detection head fused over a chunk of frames, for Hopper (sm_90a):
// softmax → EMA smoothing → hysteresis / refractory latch.
//
// No Pallas kernel to replace: in the JAX package the head is plain JAX
// that XLA fuses into the serving step (jax.nn.softmax in
// src/repro/launch/streaming.py::_detect_tail :587, then
// src/repro/models/detector.py::detector_scan :162, a lax.scan of
// detector_step :124).  As eager PyTorch the frame loop would cost ~20
// launches per frame; this kernel runs a whole chunk in one.  Its plain
// version is src/repro_torch/kernels/detect_head.py::detect_head_ref.
//
// What it computes, per slot b and frame f (K classes, keywords from
// class first_kw):
//   m = max_k x_k (NaN if any is NaN);  e_k = exp(x_k − m);
//   p_k = e_k / Σ_k e_k  (the sum in XLA:CPU's order: class by class, in
//         windows of 32 when K > 32, windows padded evenly at both ends);
//   s_k = fma(α, p_k − s_k, s_k);
//   exceed_k = s_k > fire_k (keywords only); c = first keyword with the
//   largest exceeding s_k;  fire = idle ∧ refract == 0 ∧ any exceed_k;
//   release = ¬idle ∧ every keyword's s_k < release_k;
//   active ← fire ? c : release ? −1 : active;
//   refract ← fire ? R : max(refract − 1, 0);  event = fire ? c : −1.
//
// What bounds it on this card.  The frames of a slot form one dependent
// chain (the EMA and the latch carry across frames), so at the serving
// widths the card is mostly idle and a launch is its chain of F frame
// steps plus the launch itself; chip_smoke.py measures the floor under it
// (an empty kernel at the same launch shape).  Bytes (F·B·K floats in,
// F·B events out) are far below a microsecond of HBM time.
//
// What the design does about it.  A group of G lanes per slot (G = 16 for
// K <= 16, else 32), one class per lane (two for K > 32), so a frame's
// exps, divisions and EMA updates run side by side instead of in one
// thread's chain (one thread per slot, the first design, ran ~2.1 us per
// frame: its twelve exps and IEEE divisions did not overlap).  Per frame:
// the max by a butterfly over the group (the max is exact in any order);
// the sum in class order, every lane adding the group's values one by one
// from shuffles, so each lane holds the reference's sum; the latch from
// two ballots and a (value, class) butterfly for the first largest
// exceeding keyword.  The next frame's logits are in flight while a frame
// is computed (coalesced: a group reads its slot's K consecutive floats;
// 2, 4 or 8 frames ahead ran slower, the frame loop unrolled that many
// times), and the per-keyword thresholds are staged once in shared
// memory.  A frame is then a chain of ~700 cycles: the max's butterfly,
// exp, the ordered sum, the division, the EMA, the (value, class)
// butterfly and the ballots, each waiting on the one before.
//
// Numerics.  Built with --fmad=false and --ftz=true: the EMA's product is
// fused into its add (fmaf) exactly where XLA:CPU fuses it, nothing else
// is contracted, and every result below 2^-126 is flushed as XLA:CPU
// flushes it; exp is XLA's own (xla_math.cuh), the division a true
// IEEE division, the max keeps NaN, and every comparison is false on NaN
// as in JAX.  The outputs equal the plain version bit for bit.
#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace {

constexpr int kWindow = 32;      // XLA:CPU's reduction window
constexpr int kMaxThreads = 128;
constexpr int kNoClass = 1 << 30;
constexpr int kAhead = 1;        // frames of logits in flight per lane

struct Args {
  const float* logits;   // (F, B, K)
  const float* smooth0;  // (B, K)
  const int* active0;    // (B,)
  const int* refract0;   // (B,)
  const float* fire;     // (K - first_kw,)
  const float* rel;      // (K - first_kw,)
  float alpha;
  int refractory, first_kw;
  float* smooth;         // (B, K)
  int* active;           // (B,)
  int* refract;          // (B,)
  int* events;           // (F, B)
  int F, B, K;
};

// jnp.max of two values: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// G lanes per slot, PER classes per lane (class k on lane k % G, slot
// k / G of the lane's registers).
template <int G, int PER>
__global__ void __launch_bounds__(kMaxThreads)
detect_head_kernel(const Args a) {
  extern __shared__ float th[];  // fire thresholds, then release
  const int K = a.K, fk = a.first_kw;
  for (int i = threadIdx.x; i < K - fk; i += blockDim.x) {
    th[i] = a.fire[i];
    th[K + i] = a.rel[i];
  }
  __syncthreads();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = tid / G, lane = tid % G;
  const bool valid = b < a.B;
  const unsigned group = G == 32 ? 0xffffffffu
                                 : 0xffffu << (threadIdx.x & 16);
  // Window split of the sum: classes [0, split) then [split, K).
  const int split = K <= kWindow ? K : kWindow - (2 * kWindow - K) / 2;

  bool has[PER], kw[PER];
  float s[PER], fire_th[PER], rel_th[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = lane + G * j;
    has[j] = valid && k < K;
    kw[j] = has[j] && k >= fk;
    s[j] = has[j] ? a.smooth0[static_cast<size_t>(b) * K + k] : 0.0f;
    fire_th[j] = kw[j] ? th[k - fk] : 0.0f;
    rel_th[j] = kw[j] ? th[K + k - fk] : 0.0f;
  }
  int active = valid ? a.active0[b] : -1;
  int refract = valid ? a.refract0[b] : 0;
  const size_t stride = static_cast<size_t>(a.B) * K;
  const float* row = a.logits + static_cast<size_t>(b) * K + lane;
  // A ring of the next kAhead frames' logits: frame f's slot is refilled
  // with frame f + kAhead as soon as it is read.
  float ring[kAhead][PER];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      ring[u][j] = has[j] && u < a.F ? row[u * stride + G * j] : 0.0f;
    }
  }

  const auto frame = [&](int f, const float (&x)[PER]) {
    // The max over the slot's classes (absent classes count as −inf,
    // the reference's initial value).
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (has[j]) m = nan_max(m, x[j]);
    }
#pragma unroll
    for (int d = G / 2; d > 0; d /= 2) {
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, d, G));
    }
    float e[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      e[j] = xla_math::exp(x[j] - m);
    }
    // The sum in class order: every lane adds the group's values one by
    // one (two windows above 32 classes).
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int k = 0; k < G * PER; ++k) {
      const float v = __shfl_sync(0xffffffffu, e[k / G], k % G, G);
      if (k < K) {
        if (k < split) {
          p0 = p0 + v;
        } else {
          p1 = p1 + v;
        }
      }
    }
    const float sum = K <= kWindow ? p0 : p0 + p1;
    float best = -INFINITY;
    int cls = kNoClass;
    bool exceed = false, above_rel = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (has[j]) {
        const float post = e[j] / sum;
        s[j] = fmaf(a.alpha, post - s[j], s[j]);
      }
      if (kw[j]) {
        const bool ex = s[j] > fire_th[j];
        const float cand = ex ? s[j] : -INFINITY;
        const int k = lane + G * j;
        if (cand > best || (cand == best && k < cls)) {
          best = cand;
          cls = k;
        }
        exceed |= ex;
        above_rel |= !(s[j] < rel_th[j]);
      }
    }
    // The first class among the largest exceeding keywords.
#pragma unroll
    for (int d = G / 2; d > 0; d /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, d, G);
      const int oc = __shfl_xor_sync(0xffffffffu, cls, d, G);
      if (ob > best || (ob == best && oc < cls)) {
        best = ob;
        cls = oc;
      }
    }
    const bool any_exceed = (__ballot_sync(0xffffffffu, exceed) & group) != 0;
    const bool all_below =
        (__ballot_sync(0xffffffffu, above_rel) & group) == 0;
    const bool idle = active == -1;
    const bool fire = idle && refract == 0 && any_exceed;
    const bool release = !idle && all_below;
    active = fire ? cls : (release ? -1 : active);
    const int down = static_cast<int>(static_cast<unsigned>(refract) - 1u);
    refract = fire ? a.refractory : (down > 0 ? down : 0);
    if (valid && lane == 0) {
      a.events[static_cast<size_t>(f) * a.B + b] = fire ? cls : -1;
    }
  };

  for (int f0 = 0; f0 < a.F; f0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int f = f0 + u;
      if (f < a.F) {             // uniform: every lane takes it or none
        float x[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          x[j] = ring[u][j];
          if (has[j] && f + kAhead < a.F) {
            ring[u][j] = row[(f + kAhead) * stride + G * j];
          }
        }
        frame(f, x);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (has[j]) a.smooth[static_cast<size_t>(b) * K + lane + G * j] = s[j];
  }
  if (valid && lane == 0) {
    a.active[b] = active;
    a.refract[b] = refract;
  }
}

// The launch floor under the kernel: an empty kernel at its launch shape.
__global__ void floor_kernel() {}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for K classes: the fire and the
// release thresholds, K floats each.
extern "C" long long detect_head_smem_bytes(int K) {
  return 2LL * 4 * K;
}

// Lanes per slot for K classes.
extern "C" int detect_head_group(int K) { return K <= 16 ? 16 : 32; }

// logits (F, B, K), smooth0 / smooth (B, K) float32; active0 / refract0 /
// active / refract (B,) and events (F, B) int32; fire / rel one float32
// per keyword (K - first_kw); all contiguous on the current device.
// Launches the wrapper's plan (grid CTAs of `block` threads, a group of
// detect_head_group(K) lanes per slot, `smem` bytes of dynamic shared
// memory) on `stream` and returns the launch's error, or
// cudaErrorInvalidValue for a shape or plan this kernel cannot run.
extern "C" int detect_head_launch(
    const float* logits, const float* smooth0, const int* active0,
    const int* refract0, const float* fire, const float* rel, float alpha,
    int refractory, int first_kw, float* smooth, int* active, int* refract,
    int* events, int F, int B, int K, int grid, int block, int smem,
    void* stream) {
  const long long lanes =
      static_cast<long long>(B) * detect_head_group(K);
  if (K < 1 || K > 64 || first_kw < 0 || first_kw >= K || F < 0 || B < 1 ||
      block < 32 || block > kMaxThreads || block % 32 != 0 ||
      static_cast<long long>(grid) * block < lanes ||
      smem < detect_head_smem_bytes(K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{logits, smooth0, active0, refract0, fire, rel, alpha,
                  refractory, first_kw, smooth, active, refract, events,
                  F, B, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 16) {
    detect_head_kernel<16, 1><<<grid, block, smem, s>>>(args);
  } else if (K <= 32) {
    detect_head_kernel<32, 1><<<grid, block, smem, s>>>(args);
  } else {
    detect_head_kernel<32, 2><<<grid, block, smem, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches floor_kernel with the kernel's launch shape on `stream`.
extern "C" int detect_head_floor_launch(int grid, int block, void* stream) {
  floor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
