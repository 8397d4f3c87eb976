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
// What bounds it on this card.  Not bytes (a 4096-sample chunk of 256
// streams reads 2 MiB of audio) and not the issue of its ~52 integer
// operations per sample and channel (16 µs at B = 256 over the whole
// card).  The recursion does: each sample of a channel needs the previous
// sample's registers.  The longest loop-carried chain is a section's
// y = sat16(P + s1) → s1' = sat16(rshift_round(-a1·y) + s2) → y, which
// this kernel issues as four dependent instructions (VIADDMNMX.RELU,
// IMAD, SHF, VIADDMNMX.RELU in the SASS): csrc/iir_fex_int_chain.cu
// times that step alone on one warp, and 4096 of them are the chain bound
// of a chunk (chip_smoke.py prints it).  Two more limits sit next to it:
// integer instructions issue at half rate (16 lanes per clock per SM
// sub-partition), so a warp's instructions per sample must stay near the
// chain's latency; and the code must stay small, because once it spills
// the SMs' instruction caches the fetch, shared by every busy SM, sets
// the pace (a fully unrolled 64-sample version ran far slower per CTA at
// 80 SMs than at 10).
//
// What the design does about it.
//   * Offset registers: each 16-bit register code r is carried as
//     r + 2^15 (iir_fex_int_section.cuh), so sat16(a + r) is one
//     VIADDMNMX with a relu, and -a·y is one IMAD with the offset folded
//     into its rounding addend: the chain drops from 7 instructions to 4.
//   * Warp specialisation: a CTA serves 32 (stream, channel) pairs with
//     five warps, each a stage of a software pipeline over tiles of kTile
//     samples:
//       warp 0 (feed)      loads the audio (16-byte vectors of 8 samples,
//                          4 vectors ahead, where rows are aligned) and
//                          forms P0 = rshift_round(b0·x), Q0 + 2^15;
//       warp 1 (section 0) runs section 0's recursion, writes y0 + 2^15;
//       warp 4 (mid)       forms section 1's y0-only terms P1, Q1 + 2^15;
//       warp 2 (section 1) runs section 1's recursion, writes y1 + 2^15;
//       warp 3 (envelope)  rectifies y1, runs the envelope and compresses
//                          it at every frame boundary.
//     Warps 0 and 4, the lightest, share an SM sub-partition; the others
//     have one each.  Each hand-over is a 2-slot ring of tiles in shared
//     memory under named barriers (bar.arrive by the producer, bar.sync by
//     the consumer, a "full" and an "empty" barrier per slot).  A consumer
//     writes each ring load kAhead samples before its use, and only 8
//     samples are unrolled.  The grid is one CTA per 32 pairs (the
//     wrapper's launch plan): 10 CTAs at B = 32 and 80 at B = 256, C = 10,
//     each on its own SM.
//
// Launch knobs (the autotuner's, kernels/autotune.py).  block_b: the
// wrapper launches B / block_b times on one stream, each launch over a
// slice of consecutive streams from stream b0 (Args::b0; the arrays keep
// their full-B layout, nothing is copied).  unroll: the library built with
// -DFEX_UNROLL=U (kernels/build.py::variant) runs the mid, section and
// envelope warps' per-sample loop over a tile in a rolled loop of groups
// of U samples, each group's loads issued before its steps, the tile's
// last 64 % U samples after it; U >= 64 unrolls the whole tile.
// FEX_UNROLL 0 (the default build) is the loop described above (8
// samples unrolled, loads 8 ahead).  Neither knob changes an operation or
// its order: every value is bit for bit the default's.
//
// Numerics.  All arithmetic is int32 and exact; each value stays inside
// int32 (|b0·x| ≤ 2^11·2^13, the envelope blend is a convex combination
// of two 16-bit values times 2^15), and the additions that could wrap in
// principle are done in unsigned arithmetic, which wraps like XLA's int32
// instead of being undefined (the hardware add of VIADDMNMX wraps too).
// Right shifts of negative values are arithmetic, as in torch and XLA.
// b0·(x·2^xs) is formed as (b0·2^xs)·x, the same product modulo 2^32.
// The offset registers change no value: a sum of a shifted product and
// an offset register stays below 2^31, and so does Q + 2^15 plus a
// shifted product unless both shifts are a single bit (fmt.b_frac =
// fmt.a_frac = 1), for which the launcher takes the kernel's wide
// instance (iir_fex_int_section.cuh).  The one float step is the
// compression: XLA's log2 (xla_math.cuh) of the
// exact envelope code times 2^-env_frac, its scale by 1/ln 2 fused with
// the + log_range, a multiplication by float32(1 / log_range) (XLA's
// rewrite of the division by a constant), a clamp, rintf (half to even,
// like torch.round) and a saturation to 16 bits, as the plain version and
// the JAX reference do it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "iir_fex_int_section.cuh"
#include "xla_math.cuh"

#ifndef FEX_UNROLL
#define FEX_UNROLL 0   // the default loop, 8 samples ahead
#endif

namespace {

using namespace fex_int;

constexpr int kLanes = 32;     // (stream, channel) pairs per CTA
constexpr int kTile = 64;      // samples per pipeline tile
constexpr int kStages = 2;     // ring slots between two pipeline stages
constexpr int kAhead = 8;      // ring loads issued this many samples ahead
constexpr int kVecAhead = 4;   // audio vectors (8 samples) loaded ahead
constexpr int kWarps = 5;      // feed, section 0, section 1, envelope, mid
constexpr int kThreads = kWarps * 32;

// The rings, each [slot][sample][pair]: a warp's 32 lanes touch 32
// consecutive words (or double words) of one sample, conflict-free.
struct Smem {
  int2 pq0[kStages][kTile][kLanes];     // feed → section 0: (P0, Q0 + 2^15)
  int32_t y0[kStages][kTile][kLanes];   // section 0 → mid: y0 + 2^15
  int2 pq1[kStages][kTile][kLanes];     // mid → section 1: (P1, Q1 + 2^15)
  int32_t y1[kStages][kTile][kLanes];   // section 1 → envelope: y1 + 2^15
};

// Named barriers 0..15 (the kernel never calls __syncthreads): hand-over
// h in 0..3 (feed → section 0 → mid → section 1 → envelope), ring slot
// in {0, 1}; each is met by one producer and one consumer warp.
__device__ __forceinline__ int full_bar(int h, int slot) {
  return h * 2 * kStages + slot;
}
__device__ __forceinline__ int empty_bar(int h, int slot) {
  return h * 2 * kStages + kStages + slot;
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sat16(int32_t x) {
  return min(max(x, -32768), 32767);
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

// Run `step(value, k)` over the n samples of a ring tile, each load
// written kAhead samples before its use on a full tile.  Only kAhead
// samples are unrolled (twice): the kernel's code has to stay small, or
// instruction fetch, not the recursion, sets its pace once many SMs run it.
template <typename In, typename Step>
__device__ __forceinline__ void consume(const In* tile, int n, Step step) {
  if (n == kTile) {
    In q[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) q[j] = tile[j * kLanes];
#pragma unroll 1
    for (int g = 0; g < kTile - kAhead; g += kAhead) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const In v = q[j];
        q[j] = tile[(g + j + kAhead) * kLanes];
        step(v, g + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) step(q[j], kTile - kAhead + j);
  } else {
#pragma unroll 1
    for (int k = 0; k < n; ++k) step(tile[k * kLanes], k);
  }
}

// The -DFEX_UNROLL=kU instance of consume: over a full tile, a rolled
// loop of groups of kU samples (at most the tile), each group's ring
// loads issued before its steps; the last kTile % kU samples after it.
// kU == 0 is consume itself.
template <int kU, typename In, typename Step>
__device__ __forceinline__ void consume_u(const In* tile, int n, Step step) {
  if constexpr (kU == 0) {
    consume(tile, n, step);
  } else {
    constexpr int kG = kU < kTile ? kU : kTile;
    constexpr int kMain = kTile / kG * kG;
    if (n == kTile) {
#pragma unroll 1
      for (int g = 0; g < kMain; g += kG) {
        In q[kG];
#pragma unroll
        for (int j = 0; j < kG; ++j) q[j] = tile[(g + j) * kLanes];
#pragma unroll
        for (int j = 0; j < kG; ++j) step(q[j], g + j);
      }
#pragma unroll
      for (int k = kMain; k < kTile; ++k) step(tile[k * kLanes], k);
    } else {
#pragma unroll 1
      for (int k = 0; k < n; ++k) step(tile[k * kLanes], k);
    }
  }
}

// The feed-forward terms of a section from its input v (x, or y0 + 2^15):
// P = rshift_round(b0·v) and Q + 2^15 = rshift_round(-b0·v) + 2^15.
struct Terms {
  int32_t a, ka, na, kna, s;
  __device__ __forceinline__ int2 operator()(int32_t v) const {
    return make_int2(mul_shift(a, v, ka, s),
                     mul_shift(na, v, kna, s) + kOff);
  }
};

struct Args {
  const int16_t* x;
  const int32_t* coef;
  const int16_t* state_in;
  int16_t* feats;
  int16_t* state_out;
  int B, T, n_frames, C, frame_shift, x_shift, b_frac, a_frac, env_shift,
      alpha_frac, alpha_code, eps_code;
  int x_vec;   // audio rows 16-byte aligned: T % 8 == 0, x aligned
  int b0;      // first stream of this launch (B streams from b0)
  float env_step, log_range, feat_scale, feat_max;
};

template <bool kWide, int kU>
__global__ void __launch_bounds__(kThreads) iir_fex_int_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pairs = a.B * a.C;
  const int p = blockIdx.x * kLanes + lane;
  const bool active = p < n_pairs;
  const int pc = active ? p : n_pairs - 1;   // idle lanes shadow the last
  const int bl = pc / a.C, c = pc - bl * a.C;
  const int b = a.b0 + bl;                   // the stream, of the full B
  const int S = a.n_frames * a.frame_shift;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int16_t* st_in = a.state_in + static_cast<size_t>(b) * 5 * a.C + c;
  int16_t* st_out = a.state_out + static_cast<size_t>(b) * 5 * a.C + c;
  const int32_t coef0 = a.coef[c];                       // b0, section 0
  const int32_t coef3 = a.coef[3 * a.C + c];             // b0, section 1

  if (warp == 0) {                  // feed: P0 and Q0 + 2^15 from the audio
    Terms terms;                    // b0·(x·2^xs) = (b0·2^xs)·x mod 2^32
    terms.a = opaque(static_cast<int32_t>(static_cast<uint32_t>(coef0)
                                          << a.x_shift));
    terms.na = opaque(static_cast<int32_t>(static_cast<uint32_t>(-coef0)
                                           << a.x_shift));
    terms.ka = terms.kna = 1 << (a.b_frac - 1);
    terms.s = a.b_frac;
    const int16_t* xb = a.x + static_cast<size_t>(b) * a.T;
    // With 16-byte aligned rows and whole tiles the audio comes as 16-byte
    // vectors of 8 samples, kVecAhead vectors ahead of their use;
    // otherwise sample by sample.
    const bool vec = a.x_vec && S % kTile == 0;
    const int n_vecs = S / 8;
    const int4* xv = reinterpret_cast<const int4*>(xb);
    int4 q[kVecAhead];
    if (vec) {
#pragma unroll
      for (int u = 0; u < kVecAhead; ++u) q[u] = xv[u];
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages, k0 = t * kTile;
      const int n = min(kTile, S - k0);
      int2* out = &sm.pq0[slot][0][lane];
      if (t >= kStages) bar_sync(empty_bar(0, slot));
      if (vec) {
#pragma unroll 1
        for (int j = 0; j < kTile / 8; j += kVecAhead) {
#pragma unroll
          for (int u = 0; u < kVecAhead; ++u) {
            const int4 v = q[u];
            const int g = k0 / 8 + j + u + kVecAhead;
            if (g < n_vecs) q[u] = xv[g];
            const uint32_t w[4] = {static_cast<uint32_t>(v.x),
                                   static_cast<uint32_t>(v.y),
                                   static_cast<uint32_t>(v.z),
                                   static_cast<uint32_t>(v.w)};
#pragma unroll
            for (int i = 0; i < 8; ++i) {   // little-endian int16 pairs
              const int32_t x16 =
                  static_cast<int16_t>(w[i / 2] >> (16 * (i % 2)));
              out[(8 * (j + u) + i) * kLanes] = terms(x16);
            }
          }
        }
      } else {
        for (int k = 0; k < n; ++k) out[k * kLanes] = terms(xb[k0 + k]);
      }
      bar_arrive(full_bar(0, slot));
    }
  } else if (warp == 4) {           // mid: P1 and Q1 + 2^15 from y0 + 2^15
    Terms terms;
    terms.a = opaque(coef3);
    terms.na = opaque(-coef3);
    terms.ka = off_round(terms.a, a.b_frac);
    terms.kna = off_round(terms.na, a.b_frac);
    terms.s = a.b_frac;
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      int2* out = &sm.pq1[slot][0][lane];
      bar_sync(full_bar(1, slot));
      if (t >= kStages) bar_sync(empty_bar(2, slot));
      consume_u<kU>(&sm.y0[slot][0][lane], n, [&](int32_t y0, int k) {
        out[k * kLanes] = terms(y0);
      });
      if (t + kStages < n_tiles) bar_arrive(empty_bar(1, slot));
      bar_arrive(full_bar(2, slot));
    }
  } else if (warp == 1 || warp == 2) {         // section 0 / section 1
    const bool s0 = warp == 1;
    const int h = s0 ? 0 : 2;                  // the hand-over it drains
    const int row = s0 ? 0 : 2;                // its registers' state rows
    Section<kWide> sec;
    sec.na1 = opaque(-a.coef[(s0 ? 1 : 4) * a.C + c]);
    sec.na2 = opaque(-a.coef[(s0 ? 2 : 5) * a.C + c]);
    sec.k1 = off_round(sec.na1, a.a_frac);
    sec.k2 = off_round(sec.na2, a.a_frac);
    sec.s = a.a_frac;
    sec.r1 = st_in[row * a.C] + kOff;
    sec.r2 = st_in[(row + 1) * a.C] + kOff;
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      bar_sync(full_bar(h, slot));
      if (t >= kStages) bar_sync(empty_bar(h + 1, slot));
      int32_t* out = &(s0 ? sm.y0 : sm.y1)[slot][0][lane];
      consume_u<kU>(&(s0 ? sm.pq0 : sm.pq1)[slot][0][lane], n,
              [&](int2 pq, int k) { out[k * kLanes] = sec(pq); });
      if (t + kStages < n_tiles) bar_arrive(empty_bar(h, slot));
      bar_arrive(full_bar(h + 1, slot));
    }
    if (active) {
      st_out[row * a.C] = static_cast<int16_t>(sec.r1 - kOff);
      st_out[(row + 1) * a.C] = static_cast<int16_t>(sec.r2 - kOff);
    }
  } else {                                              // envelope
    const int32_t env_mul = 1 << a.env_shift;
    const uint32_t keep = (1u << a.alpha_frac) - a.alpha_code;
    const uint32_t alpha = a.alpha_code;
    const uint32_t half = 1u << (a.alpha_frac - 1);
    int32_t env = st_in[4 * a.C];
    int16_t* fb = a.feats + static_cast<size_t>(b) * a.n_frames * a.C + c;
    int f = 0, to_boundary = a.frame_shift;
    const auto step = [&](int32_t y1_off, int) {
      const int32_t y1 = y1_off - kOff;
      const int32_t y_env = min((y1 < 0 ? -y1 : y1) * env_mul, 32767);
      env = static_cast<int32_t>(keep * static_cast<uint32_t>(env) +
                                 alpha * static_cast<uint32_t>(y_env) +
                                 half) >> a.alpha_frac;
    };
    const auto emit = [&]() {
      if (active) {
        fb[static_cast<size_t>(f) * a.C] = static_cast<int16_t>(
            compress_env(env, a.eps_code, a.env_step, a.log_range,
                         a.feat_scale, a.feat_max));
      }
      ++f;
      to_boundary = a.frame_shift;
    };
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      const int32_t* tile = &sm.y1[slot][0][lane];
      bar_sync(full_bar(3, slot));
      if (n == kTile && to_boundary >= kTile) {   // no frame ends inside
        consume_u<kU>(tile, n, step);
        to_boundary -= kTile;
        if (to_boundary == 0) emit();
      } else {
        for (int k = 0; k < n; ++k) {
          step(tile[k * kLanes], k);
          if (--to_boundary == 0) emit();
        }
      }
      if (t + kStages < n_tiles) bar_arrive(empty_bar(3, slot));
    }
    if (active) st_out[4 * a.C] = static_cast<int16_t>(env);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The unroll factor this library was built with (0: the default loop).
extern "C" int iir_fex_int_unroll() { return FEX_UNROLL; }

// x (B_all, T) int16, T >= n_frames * frame_shift, n_frames >= 1; coef
// (6, C) int32; state_in and state_out (B_all, 5, C) int16; feats (B_all,
// n_frames, C) int16.  All contiguous, on the current device.  This
// launch serves the B streams from b0 >= 0 (b0 + B <= B_all).  x_shift = sig_frac -
// feat_frac, env_shift = env_frac - sig_frac (both in [0, 15]); b_frac,
// a_frac, alpha_frac >= 1.  env_step = 2^-env_frac, feat_scale =
// 2^feat_frac, feat_max = 1 - 2^-feat_frac.  The launch follows the
// wrapper's plan (kernels/iir_fex.py::fex_int_launch_plan): `ctas` CTAs
// of `threads` threads with smem_bytes of dynamic shared memory.
// Launches on `stream` and returns the launch's (or the shared-memory
// attribute's) error, or cudaErrorInvalidValue for a plan this kernel
// cannot run (CTAs that miss pairs, too little shared memory).
extern "C" int iir_fex_int_launch(
    const int16_t* x, const int32_t* coef, const int16_t* state_in,
    int16_t* feats, int16_t* state_out, int B, int T, int n_frames, int C,
    int frame_shift, int x_shift, int b_frac, int a_frac, int env_shift,
    int alpha_frac, int alpha_code, int eps_code, float env_step,
    float log_range, float feat_scale, float feat_max, int ctas,
    int threads, int smem_bytes, int b0, void* stream) {
  if (static_cast<long long>(ctas) * kLanes < static_cast<long long>(B) * C ||
      threads != kThreads || smem_bytes < static_cast<int>(sizeof(Smem)) ||
      b0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = b_frac == 1 && a_frac == 1
                          ? iir_fex_int_kernel<true, FEX_UNROLL>
                          : iir_fex_int_kernel<false, FEX_UNROLL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_vec =
      T % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  const Args args{x, coef, state_in, feats, state_out, B, T, n_frames, C,
                  frame_shift, x_shift, b_frac, a_frac, env_shift,
                  alpha_frac, alpha_code, eps_code, x_vec, b0, env_step,
                  log_range, feat_scale, feat_max};
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
