// Full-sequence delta-gated GRU (ΔGRU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/delta_gru_seq.py::delta_gru_seq (pallas_call :159,
//   body _kernel :53; step math kernels/gru_math.py delta_branch :16,
//   gru_gates :31).
//
// What it computes.  T frames of the ΔGRU for each stream: Δ-encode x and
// h against x̂/ĥ at Δ_TH (strict >; x̂/ĥ advance only on transmitted
// components), M_x += Δx·W_x and M_h += Δh·W_h, then the type-2 gates
// (reset gate on the candidate's hidden pre-activation).  It emits hs
// (T, B, H) and the per-frame transmit counts nz_dx/nz_dh (T, B), and
// returns the final h, x̂, ĥ, M_x, M_h.
//
// What bounds it on this card.  Not bytes (weights 57 kB, one chunk of
// 256 streams moves about 3 MB) and not arithmetic (at most 14,208 MACs
// per frame and stream, fewer with sparse deltas): the frames form a
// dependency chain, each frame needs the previous frame's h, and inside a
// frame the Δ-encode, the column sums and the gates depend on each other.
// csrc/delta_gru_seq_chain.cu times that chain (one h component's
// Δ-encode and compaction, a column's sum over the transmitted rows, σ of
// the column, tanh and the blend) on one warp; 32 frames of it are the
// chain bound of a chunk (chip_smoke.py prints it).
//
// What the design does about it.  One persistent CTA per stream runs all
// T frames in-kernel, with one thread per pre-activation column (3H,
// rounded up to a warp).  The prologue stages W_x|W_h (56,832 bytes at
// I = 10, H = 64, hence dynamic shared memory and cudaFuncSetAttribute)
// with 16-byte asynchronous copies where the rows allow it.  Each x
// encoder thread loads its component one frame ahead into a register, so
// the load's latency hides behind a frame's work and no global load sits
// on the per-frame chain.  x̂, ĥ, h and thread j's M_x[j], M_h[j] stay in
// registers across frames.  Per frame (delta_gru_seq_frame.cuh holds the
// steps):
//   1. the Δ encoders (thread j < H owns h component j; x component i
//      belongs to lane i % 32 of the (i / 32)-th of the last ceil(I / 32)
//      warps, so x and h are encoded side by side in different warps)
//      compact their transmitted components per warp — a ballot and a
//      population count, no prefix across warps — into (Δ, weight-row
//      offset) lists, one segment per warp, x and h apart, and add the
//      warp's count to the frame's transmit count with a global atomic
//      (zeroed in the prologue);                           __syncthreads
//   2. the paper's per-column skip: thread j sums column j over the x
//      segments, then over the h segments, in warp order — ascending row
//      order, from 0, one rounded product and one add per row, the order
//      delta_matvec and the reference sum in; two rows' loads in flight —
//      and adds each sum to its M; the threads of the r and u columns
//      take σ of theirs, side by side;                      __syncthreads
//   3. the candidate's tanh and the blend on threads j < H; h' stays in
//      the thread that encodes it next frame.
// Two CTA-wide barriers per frame (the design before had four and a
// serial loop over the warp counts).  Per frame only hs and the two
// counts go to device memory.  Slower in the variants measured beside
// this design (chip_variants.py, PERF.md): row sums rolled, unrolled by
// four or in predicated batches; rows as ballot masks over dense deltas;
// σ(r) and σ(u) after the second barrier in the gate threads; x encoders
// in the first warps; weights staged by plain loads; x staged for 32
// frames in the prologue (the int twin's way; the prologue grew more than
// the frames gained); the counts summed by one thread instead of the
// atomics.
//
// The masked instantiation (kMasked, the stage-1 half of the two-stage
// wake cascade; no Pallas counterpart: it replaces the XLA-fused
// src/repro/core/delta_gru.py::masked_delta_gru_scan :376) runs a frame
// only where the stream's wake bit is set (wake_bits.cuh).  An asleep
// frame stores the frozen h row into hs and leaves the prologue's zero
// counts; the x prefetch still advances, so the next awake frame encodes
// its own x against the x̂ that the asleep frames left frozen.  It skips
// the encoders, the row sums, the gates and both barriers: its cost is
// the h row's store.  Awake everywhere, it does the unmasked arithmetic.
//
// Launch knobs (the autotuner's, kernels/autotune.py).  block_b: the
// wrapper launches B / block_b times on one stream, each launch's CTAs
// serving consecutive streams from b0 (Args::b0; xs stays (T, B, I) with
// its full-B strides, nothing is copied).  block_t: with x_frames >= 2
// (the staged instance, kStaged) each x encoder copies its component for
// the next x_frames frames into shared memory at once, all loads issued
// before the first store, and reads it back frame by frame: the variant
// measured and set aside above, kept as a knob.  x_frames 0 (block_t 1,
// the default) is the one-frame-ahead register load.  The masked
// instantiation keeps the default launch.  No knob changes an operation
// or its order: every value is bit for bit the default's.
//
// Numerics.  Compiled with --fmad=false (multiply then add, as PyTorch's
// eager ops) and --ftz=true (XLA:CPU flushes denormals).  σ and tanh are
// XLA's own float32 expansions (xla_math.cuh), and the gates fuse the two
// products that XLA fuses: r·M_hc into the candidate's pre-activation and
// u·h into the blend.
#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_gru_seq_frame.cuh"
#include "wake_bits.cuh"

namespace {

using namespace gru_f;

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// Shared-memory layout, in bytes, for input width I and hidden H (N = 3H
// columns): W_x (I rows) then W_h (H rows) at a row pitch of N rounded up
// to 4 floats; the compacted (Δ, row offset) lists, warp w's segment from
// entry 32w (SX segments for x, SH for h); the rows the gates read (σ(u)
// and the candidate's M_x; its M_h); the segment counts; with x_frames >
// 0 (the staged instance) x for x_frames frames ([frame][component]).
struct Layout {
  int pitch, sx, sh;
  size_t lx, lh, mxs, mhs, cnt, xst, total;
};

__host__ __device__ inline Layout layout(int I, int H, int x_frames = 0) {
  Layout L;
  const int N = 3 * H;
  L.pitch = (N + 3) / 4 * 4;
  L.sx = (I + 31) / 32;
  L.sh = (H + 31) / 32;
  L.lx = round16(4 * static_cast<size_t>(I + H) * L.pitch);
  L.lh = L.lx + sizeof(Row) * 32 * L.sx;
  L.mxs = L.lh + sizeof(Row) * 32 * L.sh;
  L.mhs = L.mxs + 4 * static_cast<size_t>(L.pitch);
  L.cnt = L.mhs + 4 * static_cast<size_t>(L.pitch);
  L.xst = L.cnt + round16(4 * static_cast<size_t>(L.sx + L.sh));
  L.total = L.xst + round16(4 * static_cast<size_t>(x_frames) * I);
  return L;
}

struct Args {
  const float* xs;
  const float* h0;
  const float* xh0;
  const float* hh0;
  const float* mx0;
  const float* mh0;
  const float* wx;
  const float* wh;
  float* hs;
  int* nz_dx;
  int* nz_dh;
  float* h_out;
  float* xh_out;
  float* hh_out;
  float* mx_out;
  float* mh_out;
  float threshold;
  int T, B, I, H;
  int w_vec;   // 3H % 4 == 0 and both weight arrays 16-byte aligned
  const uint8_t* awake;   // (T, B) wake trace; the masked instantiation's
  int b0;        // first stream of this launch (gridDim.x streams from b0)
  int x_frames;  // frames of x staged at a time (the staged instance's)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Copy a float weight matrix of `rows` rows of N into shared memory at
// `pitch` floats per row, as asynchronous copies (waited for by the
// caller): 16 bytes each when vec (then pitch == N), else 4.
__device__ __forceinline__ void stage_weights(float* dst, const float* src,
                                              int rows, int N, int pitch,
                                              bool vec) {
  if (vec) {
    const int n = rows * N / 4;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      cp_async16(dst + 4 * k, src + 4 * k);
    }
  } else {
    const int n = rows * N;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int r = k / N;
      cp_async4(dst + r * pitch + (k - r * N), src + k);
    }
  }
}

template <bool kMasked, bool kStaged>
__global__ void delta_gru_seq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int I = a.I, H = a.H, N = 3 * H, B = a.B, T = a.T;
  const Layout L = layout(I, H, kStaged ? a.x_frames : 0);
  float* w = reinterpret_cast<float*>(smem);       // W_x rows, then W_h
  Row* lx = reinterpret_cast<Row*>(smem + L.lx);
  Row* lh = reinterpret_cast<Row*>(smem + L.lh);
  float* mxs = reinterpret_cast<float*>(smem + L.mxs);
  float* mhs = reinterpret_cast<float*>(smem + L.mhs);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);  // x, then h segments
  float* xst = reinterpret_cast<float*>(smem + L.xst);  // staged x

  const int b = a.b0 + blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int xwarp = warp - (static_cast<int>(blockDim.x >> 5) - L.sx);
  const int xj = xwarp * 32 + lane;   // this thread's x component
  const bool x_enc = xwarp >= 0 && xj < I;
  // The staged instance: the encoder of x component xj copies it for the
  // block's frames from t0 (all loads issued before the first store) and
  // is the only thread to read it back.
  const auto stage_x = [&](int t0) {
    const int nf = min(a.x_frames, T - t0);
    const float* src = a.xs + (static_cast<size_t>(t0) * B + b) * I + xj;
#pragma unroll 32
    for (int f = 0; f < nf; ++f) {
      xst[f * I + xj] = src[static_cast<size_t>(f) * B * I];
    }
  };

  stage_weights(w, a.wx, I, N, L.pitch, a.w_vec);
  stage_weights(w + I * L.pitch, a.wh, H, N, L.pitch, a.w_vec);
  for (int f = j; f < T; f += blockDim.x) {
    a.nz_dx[static_cast<size_t>(f) * B + b] = 0;
    a.nz_dh[static_cast<size_t>(f) * B + b] = 0;
  }
  float xhat = 0.0f, hhat = 0.0f, hcur = 0.0f, mx = 0.0f, mh = 0.0f;
  float xnext = 0.0f;              // x of the coming frame
  if (x_enc) {
    xhat = a.xh0[b * I + xj];
    if (T > 0) {
      if (kStaged) {
        stage_x(0);
      } else {
        xnext = a.xs[static_cast<size_t>(b) * I + xj];
      }
    }
  }
  if (j < H) {
    hhat = a.hh0[b * H + j];
    hcur = a.h0[b * H + j];
  }
  if (j < N) {
    mx = a.mx0[static_cast<size_t>(b) * N + j];
    mh = a.mh0[static_cast<size_t>(b) * N + j];
  }
  wake::Bits wb{0u, 0};
  if (kMasked) wb = wake::first(a.awake, T, B, b, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  int tf = 0;                      // frame within the staged block
  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    float xv = xnext;
    if (kStaged) {
      if (tf == a.x_frames) {
        tf = 0;
        if (x_enc) stage_x(t);
      }
      if (x_enc) xv = xst[tf * I + xj];
      ++tf;
    } else if (x_enc && t + 1 < T) {
      xnext = a.xs[(row + B) * I + xj];
    }
    if (kMasked && !wake::is_awake(wb, a.awake, t, T, B, b, lane)) {
      if (j < H) a.hs[row * H + j] = hcur;        // asleep: h frozen
      continue;
    }
    // 1. Δ encoders, each warp compacting its own transmitted components.
    if (xwarp >= 0) {
      float d = 0.0f;
      const bool sent = x_enc && encode(xv, xhat, a.threshold, d);
      const int n = compact(sent, d, xj * L.pitch, lx, 32 * xwarp);
      if (lane == 0) cnt[xwarp] = n;
      if (lane == 0 && n != 0) atomicAdd(&a.nz_dx[row], n);
    }
    if (warp < L.sh) {
      float d = 0.0f;
      const bool sent = j < H && encode(hcur, hhat, a.threshold, d);
      const int n = compact(sent, d, (I + j) * L.pitch, lh, 32 * warp);
      if (lane == 0) cnt[L.sx + warp] = n;
      if (lane == 0 && n != 0) atomicAdd(&a.nz_dh[row], n);
    }
    __syncthreads();

    // 2. Column j of M_x and M_h over the transmitted rows only; then the
    //    r and u columns' threads take their σ, the candidate's keep M.
    float r = 0.0f;
    if (j < N) {
      float ax = 0.0f, ah = 0.0f;
      for (int s = 0; s < L.sx; ++s) {
        ax = column_sum(ax, lx + 32 * s, cnt[s], w + j);
      }
      for (int s = 0; s < L.sh; ++s) {
        ah = column_sum(ah, lh + 32 * s, cnt[L.sx + s], w + j);
      }
      mx = mx + ax;
      mh = mh + ah;
      if (j < H) {
        r = gate_sigmoid(mx, mh);
      } else if (j < 2 * H) {
        mxs[j] = gate_sigmoid(mx, mh);              // u
      } else {
        mxs[j] = mx;
        mhs[j] = mh;
      }
    }
    __syncthreads();

    // 3. The candidate and the blend on threads j < H.
    if (j < H) {
      hcur = candidate_blend(r, mxs[H + j], mxs[2 * H + j], mhs[2 * H + j],
                             hcur);
      a.hs[row * H + j] = hcur;
    }
  }

  if (x_enc) a.xh_out[b * I + xj] = xhat;
  if (j < H) {
    a.h_out[b * H + j] = hcur;
    a.hh_out[b * H + j] = hhat;
  }
  if (j < N) {
    a.mx_out[static_cast<size_t>(b) * N + j] = mx;
    a.mh_out[static_cast<size_t>(b) * N + j] = mh;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for input width I and hidden H.
extern "C" long long delta_gru_seq_smem_bytes(int I, int H) {
  return static_cast<long long>(layout(I, H).total);
}

// The same for the staged instance with x_frames >= 2 staged frames.
extern "C" long long delta_gru_seq_staged_smem_bytes(int I, int H,
                                                     int x_frames) {
  return static_cast<long long>(layout(I, H, x_frames).total);
}

// xs (T, B, I); h0, hh0, h_out, hh_out (B, H); xh0, xh_out (B, I);
// mx0, mh0, mx_out, mh_out (B, 3H); wx (I, 3H); wh (H, 3H); hs (T, B, H);
// nz_dx, nz_dh (T, B) int32; awake null, or the (T, B) uint8 wake trace of
// the masked instantiation.  All contiguous float32 (counts int32) on the
// current device.  The launch follows the wrapper's plan
// (kernels/delta_gru_seq.py::gru_launch_plan): one CTA per stream of the
// `ctas` streams from b0 (b0 + ctas <= B) of `threads` threads, a warp
// multiple that covers 3H and I, with smem_bytes of dynamic shared memory
// for x_frames staged frames (0 or 1: the unstaged default; >= 2: the
// staged instance, which the masked one never takes).  Launches on
// `stream` and returns the launch's (or the shared-memory attribute's)
// error, or cudaErrorInvalidValue for a plan this kernel cannot run.
extern "C" int delta_gru_seq_launch(
    const float* xs, const float* h0, const float* xh0, const float* hh0,
    const float* mx0, const float* mh0, const float* wx, const float* wh,
    float threshold, float* hs, int* nz_dx, int* nz_dh, float* h_out,
    float* xh_out, float* hh_out, float* mx_out, float* mh_out, int T, int B,
    int I, int H, int ctas, int threads, int smem_bytes, int x_frames,
    int b0, const uint8_t* awake, void* stream) {
  const bool staged = x_frames >= 2;
  if (ctas < 1 || b0 < 0 || b0 + ctas > B || threads % 32 != 0 ||
      threads > 1024 || threads < 3 * H || threads < I || x_frames < 0 ||
      (staged && awake != nullptr) ||
      static_cast<size_t>(smem_bytes) <
          layout(I, H, staged ? x_frames : 0).total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(Args) = awake != nullptr
                             ? delta_gru_seq_kernel<true, false>
                             : staged ? delta_gru_seq_kernel<false, true>
                                      : delta_gru_seq_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w_vec = (3 * H) % 4 == 0 &&
                            (reinterpret_cast<uintptr_t>(wx) & 15) == 0 &&
                            (reinterpret_cast<uintptr_t>(wh) & 15) == 0
                        ? 1
                        : 0;
  const Args args{xs, h0, xh0, hh0, mx0, mh0, wx, wh, hs, nz_dx, nz_dh,
                  h_out, xh_out, hh_out, mx_out, mh_out, threshold, T, B, I,
                  H, w_vec, awake, b0, staged ? x_frames : 0};
  kernel<<<ctas, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
