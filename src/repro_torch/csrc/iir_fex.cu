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
// 2.8 us at 67 TFLOP/s).  The recursion does: each sample of a channel
// needs the previous sample's registers, and each section's loop-carried
// chain is two dependent FFMAs per sample (iir_fex_section.cuh).
// csrc/iir_fex_chain.cu times that step alone on one warp; 4096 of them
// are the chain bound of a chunk (chip_smoke.py prints it).  The first
// version (one thread per pair doing everything, the audio loaded on the
// recursion) spent ~10x that.
//
// What the design does about it.  Warp specialisation: a CTA serves 32
// (stream, channel) pairs with four warps, each a stage of a software
// pipeline over tiles of kTile samples, each on its own SM sub-partition:
//   warp 0 (feed)      copies each lane's audio row into shared memory
//                      with cp.async (16-byte vectors where rows are
//                      aligned, single samples otherwise), kXAhead tiles in
//                      flight;
//   warp 1 (section 0) runs section 0 on the audio and writes y0;
//   warp 2 (section 1) runs section 1 on y0 and writes y1;
//   warp 3 (envelope)  rectifies y1, runs the envelope and compresses it
//                      at every frame boundary.
// Each hand-over is a ring of tiles in shared memory under named barriers
// (bar.arrive by the producer, bar.sync by the consumer, a "full" and an
// "empty" barrier per slot).  Rows are read and written as 16-byte
// vectors, 4 samples at a time, in a fully unrolled loop over the tile.
// Measured (chip_variants.py, PERF.md): with section 0 issuing its own
// copies, tiles of 128 samples, more copies in flight, one row per
// stream, section 1 and the envelope in one warp, or all three stages
// in one warp, the kernel ran no faster or slower; the tile loop rolled
// (16 samples per iteration) cost ~12 % more.  The grid is one
// CTA per 32 pairs (the wrapper's launch plan,
// kernels/iir_fex.py::fex_launch_plan): 10 CTAs at B = 32 and 80 at
// B = 256, C = 10.
//
// Launch knobs (the autotuner's, kernels/autotune.py).  block_b: the
// wrapper launches B / block_b times on one stream, each launch over a
// slice of consecutive streams from stream b0 (Args::b0; the arrays keep
// their full-B layout, nothing is copied).  unroll: the library built with
// -DFEX_UNROLL=U (kernels/build.py::variant) runs the three consumer
// warps' per-sample loop over a tile in a rolled loop of groups of U
// samples, each group unrolled (16-byte ring accesses where U % 4 == 0),
// the tile's last 64 % U samples after it; U >= 64 unrolls the whole
// tile.  FEX_UNROLL 0 (the default build) is the fully unrolled tile
// with loads 8 samples ahead described above.  Neither knob changes an
// operation or its order: every value is bit for bit the default's.
//
// Numerics: those of the JAX reference as XLA compiles it on the CPU.
// Its scan body fuses seven products into the following add or subtract
// (of a difference of two products, the first); those are fmaf() in
// iir_fex_section.cuh, and the build's --fmad=false keeps every other
// product rounded on its own.  XLA flushes denormals, and so does the
// build's --ftz=true, so a register decaying in silence reaches 0 at the
// same sample.  y0 and y1 pass between warps as float bits, which is
// exact.  The compression is XLA's log2 (xla_math.cuh), its scale by
// 1/ln 2 fused with the + 11, and a multiplication by float32(1/11).
// rintf rounds half to even like torch.round; the clamps propagate NaN
// like torch.clamp.  1 - env_alpha and log_eps arrive as floats rounded on
// the host, as the reference folds its Python constants to float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "iir_fex_section.cuh"
#include "xla_math.cuh"

#ifndef FEX_UNROLL
#define FEX_UNROLL 0   // the fully unrolled tile (the default instance)
#endif

namespace {

constexpr int kLanes = 32;     // (stream, channel) pairs per CTA
constexpr int kTile = 64;      // samples per pipeline tile
constexpr int kPitch = kTile + 4;    // floats per lane row of a ring tile
constexpr int kXStages = 4;    // audio ring slots
constexpr int kXAhead = 2;     // audio tiles in flight behind the newest
constexpr int kStages = 2;     // y0 / y1 ring slots
constexpr int kWarps = 4;      // feed, section 0, section 1, envelope
constexpr int kThreads = kWarps * 32;

constexpr float kFeatStep = 0.00048828125f;  // 2^-11, the 12-bit grid step
constexpr float kLogRange = 11.0f;
constexpr float kInvLogRange = 1.0f / 11.0f;  // correctly rounded

// Every ring is [slot][pair][sample]: each lane's row of kPitch floats is
// 16-byte aligned and 4 banks on from its neighbour's, so a warp's
// 16-byte accesses to one tile position are conflict-free.
struct Smem {
  float x[kXStages][kLanes][kPitch];   // feed → section 0: audio
  float y0[kStages][kLanes][kPitch];   // section 0 → section 1
  float y1[kStages][kLanes][kPitch];   // section 1 → envelope
};

// Named barriers 0..15 (the kernel never calls __syncthreads), each met by
// one producer warp (bar.arrive) and one consumer warp (bar.sync): the
// audio ring's "full" 0..3 and "empty" 4..7, then y0's full 8, 9 and empty
// 10, 11, then y1's full 12, 13 and empty 14, 15.
__device__ __forceinline__ int x_full(int slot) { return slot; }
__device__ __forceinline__ int x_empty(int slot) { return kXStages + slot; }
__device__ __forceinline__ int y_full(int h, int slot) {
  return 2 * kXStages + h * 2 * kStages + slot;
}
__device__ __forceinline__ int y_empty(int h, int slot) {
  return y_full(h, slot) + kStages;
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

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

// Run fn(4 samples, index of the first) over a full tile of one lane's
// ring row: 16-byte loads, the next 8 samples loaded while the current 8
// run, the whole tile unrolled (every ring access at a constant offset).
template <typename Fn>
__device__ __forceinline__ void run_tile(const float* row, Fn fn) {
  const float4* v = reinterpret_cast<const float4*>(row);
  float4 a0 = v[0], a1 = v[1];
#pragma unroll
  for (int g = 0; g < kTile; g += 16) {
    const float4 b0 = v[g / 4 + 2], b1 = v[g / 4 + 3];
    fn(a0, g);
    fn(a1, g + 4);
    if (g + 16 < kTile) {
      a0 = v[g / 4 + 4];
      a1 = v[g / 4 + 5];
    }
    fn(b0, g + 8);
    fn(b1, g + 12);
  }
}

// The -DFEX_UNROLL=kU instance of run_tile: fn4(4 samples, index of the
// first) or fn1(sample, index) over a full tile, in a rolled loop of
// groups of kU samples (at most the tile), each group unrolled; 16-byte
// accesses where kU % 4 == 0, single ones otherwise; the last
// kTile % kU samples unrolled after the loop.
template <int kU, typename Fn4, typename Fn1>
__device__ __forceinline__ void run_tile_u(const float* row, Fn4 fn4,
                                           Fn1 fn1) {
  constexpr int kG = kU < kTile ? kU : kTile;
  constexpr int kMain = kTile / kG * kG;
  if constexpr (kG % 4 == 0) {
    const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll 1
    for (int g = 0; g < kMain; g += kG) {
#pragma unroll
      for (int i = 0; i < kG / 4; ++i) fn4(v[g / 4 + i], g + 4 * i);
    }
#pragma unroll
    for (int k = kMain; k < kTile; k += 4) fn4(v[k / 4], k);
  } else {
#pragma unroll 1
    for (int g = 0; g < kMain; g += kG) {
#pragma unroll
      for (int j = 0; j < kG; ++j) fn1(row[g + j], g + j);
    }
#pragma unroll
    for (int k = kMain; k < kTile; ++k) fn1(row[k], k);
  }
}

// The tile loop of the kernel's instance: run_tile, or run_tile_u<kU>.
template <int kU, typename Fn4, typename Fn1>
__device__ __forceinline__ void tile_loop(const float* row, Fn4 fn4,
                                          Fn1 fn1) {
  if constexpr (kU == 0) {
    run_tile(row, fn4);
  } else {
    run_tile_u<kU>(row, fn4, fn1);
  }
}

// A section's step on 4 samples of its input, written to its output row.
__device__ __forceinline__ void section4(fex::Section& sec, float4 v,
                                         float* out) {
  const float y0 = sec(v.x);         // one statement each: the steps are
  const float y1 = sec(v.y);         // sequential in the state
  const float y2 = sec(v.z);
  const float y3 = sec(v.w);
  *reinterpret_cast<float4*>(out) = make_float4(y0, y1, y2, y3);
}

struct Args {
  const float* x;
  const float* coef;
  const float* state_in;
  float* feats;
  float* state_out;
  int B, T, n_frames, C, frame_shift, compress;
  int x_vec;   // audio rows 16-byte aligned: T % 4 == 0, x aligned
  int b0;      // first stream of this launch (B streams from b0)
  float env_alpha, one_minus_alpha, log_eps;
};

template <int kU>
__global__ void __launch_bounds__(kThreads) iir_fex_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pairs = a.B * a.C;
  const int p = blockIdx.x * kLanes + lane;
  const bool active = p < n_pairs;
  const int pc = active ? p : n_pairs - 1;   // idle lanes shadow the last
  const int bl = pc / a.C, c = pc - bl * a.C;
  const int b = a.b0 + bl;                   // the stream, of the full B
  const int C = a.C;
  const int S = a.n_frames * a.frame_shift;
  const int n_tiles = (S + kTile - 1) / kTile;
  const float* st_in = a.state_in + static_cast<size_t>(b) * 5 * C + c;
  float* st_out = a.state_out + static_cast<size_t>(b) * 5 * C + c;

  if (warp == 0) {                 // feed: the audio of this lane's pair
    const float* xb = a.x + static_cast<size_t>(b) * a.T;
    // Iteration t copies tile t into slot t % kXStages (once section 0
    // has released it) and publishes tile t - kXAhead, whose copies are
    // then the oldest in flight.  A group is committed every iteration,
    // empty past the end, so the wait count is always kXAhead.
    for (int t = 0; t < n_tiles + kXAhead; ++t) {
      if (t < n_tiles) {
        const int slot = t % kXStages;
        const int k0 = t * kTile;
        const int n = min(kTile, S - k0);
        float* dst = &sm.x[slot][lane][0];
        if (t >= kXStages) bar_sync(x_empty(slot));
        if (a.x_vec) {
          for (int v = 0; v < n; v += 4) cp_async16(dst + v, xb + k0 + v);
        } else {
          for (int k = 0; k < n; ++k) cp_async4(dst + k, xb + k0 + k);
        }
      }
      cp_async_commit();
      const int done = t - kXAhead;
      if (done >= 0) {
        cp_async_wait<kXAhead>();
        bar_arrive(x_full(done % kXStages));
      }
    }
  } else if (warp == 1) {          // section 0, on the audio
    fex::Section sec;
    sec.b0 = a.coef[c];
    sec.na1 = -a.coef[C + c];
    sec.nb0 = -sec.b0;
    sec.a2 = a.coef[2 * C + c];
    sec.r1 = st_in[0];
    sec.r2 = st_in[C];
    for (int t = 0; t < n_tiles; ++t) {
      const int xslot = t % kXStages, slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      const float* in = &sm.x[xslot][lane][0];
      float* out = &sm.y0[slot][lane][0];
      bar_sync(x_full(xslot));
      if (t >= kStages) bar_sync(y_empty(0, slot));
      if (n == kTile) {
        tile_loop<kU>(
            in, [&](float4 v, int k) { section4(sec, v, out + k); },
            [&](float v, int k) { out[k] = sec(v); });
      } else {
#pragma unroll 1
        for (int k = 0; k < n; ++k) out[k] = sec(in[k]);
      }
      if (t + kXStages < n_tiles) bar_arrive(x_empty(xslot));
      bar_arrive(y_full(0, slot));
    }
    if (active) {
      st_out[0] = sec.r1;
      st_out[C] = sec.r2;
    }
  } else if (warp == 2) {          // section 1, on y0
    fex::Section sec;
    sec.b0 = a.coef[3 * C + c];
    sec.na1 = -a.coef[4 * C + c];
    sec.nb0 = -sec.b0;
    sec.a2 = a.coef[5 * C + c];
    sec.r1 = st_in[2 * C];
    sec.r2 = st_in[3 * C];
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      const float* in = &sm.y0[slot][lane][0];
      float* out = &sm.y1[slot][lane][0];
      bar_sync(y_full(0, slot));
      if (t >= kStages) bar_sync(y_empty(1, slot));
      if (n == kTile) {
        tile_loop<kU>(
            in, [&](float4 v, int k) { section4(sec, v, out + k); },
            [&](float v, int k) { out[k] = sec(v); });
      } else {
#pragma unroll 1
        for (int k = 0; k < n; ++k) out[k] = sec(in[k]);
      }
      if (t + kStages < n_tiles) bar_arrive(y_empty(0, slot));
      bar_arrive(y_full(1, slot));
    }
    if (active) {
      st_out[2 * C] = sec.r1;
      st_out[3 * C] = sec.r2;
    }
  } else {                         // envelope and compression, on y1
    float env = st_in[4 * C];
    float* fb = a.feats + static_cast<size_t>(b) * a.n_frames * C + c;
    int f = 0, to_boundary = a.frame_shift;
    const auto step = [&](float y1) {
      env = fex::envelope_step(env, y1, a.one_minus_alpha, a.env_alpha);
    };
    const auto emit = [&]() {
      if (active) {
        fb[static_cast<size_t>(f) * C] =
            a.compress ? compress_env(env, a.log_eps) : env;
      }
      ++f;
      to_boundary = a.frame_shift;
    };
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const int n = min(kTile, S - t * kTile);
      const float* in = &sm.y1[slot][lane][0];
      bar_sync(y_full(1, slot));
      if (n == kTile && to_boundary >= kTile) {   // no frame ends inside
        tile_loop<kU>(
            in,
            [&](float4 v, int) {
              step(v.x);
              step(v.y);
              step(v.z);
              step(v.w);
            },
            [&](float v, int) { step(v); });
        to_boundary -= kTile;
        if (to_boundary == 0) emit();
      } else {
        for (int k = 0; k < n; ++k) {
          step(in[k]);
          if (--to_boundary == 0) emit();
        }
      }
      if (t + kStages < n_tiles) bar_arrive(y_empty(1, slot));
    }
    if (active) st_out[4 * C] = env;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The unroll factor this library was built with (0: the default tile).
extern "C" int iir_fex_unroll() { return FEX_UNROLL; }

// x (B_all, T) f32, T >= n_frames * frame_shift, n_frames >= 1; coef
// (6, C); state_in and state_out (B_all, 5, C); feats (B_all, n_frames,
// C).  All contiguous, on the current device.  This launch serves the B
// streams from b0 (b0 + B <= B_all; the others are left alone).  The
// launch follows the wrapper's plan (kernels/iir_fex.py::fex_launch_plan
// for B streams): `ctas` CTAs of `threads` threads with smem_bytes of
// dynamic shared memory.  Launches on `stream` and returns the launch's
// (or the shared-memory attribute's) error, or cudaErrorInvalidValue for
// a plan this kernel cannot run (CTAs that miss pairs, another thread
// count, too little shared memory, a negative b0).
extern "C" int iir_fex_launch(const float* x, const float* coef,
                              const float* state_in, float* feats,
                              float* state_out, int B, int T, int n_frames,
                              int C, int frame_shift, float env_alpha,
                              float one_minus_alpha, float log_eps,
                              int compress, int ctas, int threads,
                              int smem_bytes, int b0, void* stream) {
  if (static_cast<long long>(ctas) * kLanes < static_cast<long long>(B) * C ||
      threads != kThreads || smem_bytes < static_cast<int>(sizeof(Smem)) ||
      b0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      iir_fex_kernel<FEX_UNROLL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_vec =
      T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
  const Args args{x, coef, state_in, feats, state_out, B, T, n_frames, C,
                  frame_shift, compress, x_vec, b0, env_alpha,
                  one_minus_alpha, log_eps};
  iir_fex_kernel<FEX_UNROLL><<<static_cast<unsigned>(ctas), kThreads,
                               smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
