// Integer delta-gated GRU (ΔGRU) over a whole sequence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/delta_gru_seq.py::delta_gru_seq_int (pallas_call
//   :332, body _int_kernel :178; frame math
//   src/repro/core/fixed_point.py::gru_frame_step :314, gates
//   int_gru_gates :215).
//
// What it computes.  T frames of the deployed ΔGRU for each stream, on
// integer codes: int16 x / h / x̂ / ĥ, int8 weights, and the fused
// [m_x | m_h] accumulator on the 24-bit saturating grid.  Per frame, in
// gru_frame_step's order: Δ-encode x and h with |v - v̂| > th (x̂ / ĥ
// advance only on transmitted components); form each of the 6H product
// columns Δx·W_x and Δh·W_h as an exact int32 sum; align each half onto
// the accumulator grid (shift_x, shift_h: a left shift when >= 0, a
// round-half-up right shift when < 0); add to m and saturate ONCE to
// acc_bits; then the gates with the ideal-LUT σ / tanh on the dequantized
// accumulators, requantized to the Q0.hid grid, and
// h' = sat16((u·h + (2^hid - u)·c + 2^(hid-1)) >> hid).  It emits hs (T, B, H)
// int16 and the per-frame transmit counts, and returns the final state.
//
// What bounds it on this card.  Not bytes (14,208 B of int8 weights, one
// chunk of 256 streams moves about 1.3 MB) and not operations (at most
// 14,208 multiply-adds per frame and stream, fewer with sparse deltas):
// the frames form a dependency chain, and inside a frame the Δ-encode,
// the products and the gates depend on each other.  csrc/
// delta_gru_seq_int_chain.cu times that chain (one h component's
// Δ-encode, a column's sum over 74 rows reduced as here, the alignment,
// σ(r), the candidate, tanh and the blend) on one warp; 32 frames of it
// are the chain bound of a chunk (chip_smoke.py prints it).
//
// What the design does about it.  One persistent CTA per stream runs all
// T frames in-kernel.  The prologue
// stages the int8 weights into shared memory once, as 16-byte
// asynchronous copies where the rows allow it, while each x encoder
// thread loads its component's codes for a block of up to x_frames
// frames (all loads issued before the first store; the next block's at
// its first frame), so no global load sits on the per-frame chain.
// x̂, ĥ, h and thread j's accumulator columns m_x[j], m_h[j] stay in
// registers across frames.  Per frame:
//   1. the Δ encoders (thread j < H owns h component j; x component i
//      belongs to lane i % 32 of the (i / 32)-th of the last ceil(I / 32)
//      warps, so x and h are encoded side by side in different warps)
//      compact their transmitted components per warp — a ballot and a
//      population count, no prefix across warps — into (Δ, weight-row
//      offset) lists, one segment per warp, and add the warp's count to
//      the frame's transmit count with a global atomic (zeroed in the
//      prologue), so no thread sums the counts;          __syncthreads
//   2. the paper's per-column skip: each thread sums a register tile of
//      4 adjacent columns over every 4th transmitted row (one 32-bit
//      shared load of 4 int8 weights feeds four IMADs), the 4 lanes of a
//      column group combine their sums with three shuffles so that lane
//      j ends with column j's whole sum, then align, accumulate and
//      saturate once;                                     __syncthreads
//   3. the gates on threads j < H; h' stays in the thread that encodes it
//      next frame.
// Two CTA-wide barriers per frame (the first version had four and a
// serial loop over the warp counts).  Per frame only hs and the two
// counts go to device memory (buffering them in shared memory for a
// block of frames was slower; so were thread 0 summing the warp counts,
// row sums unrolled by two and the x encoders in the first warps, after
// the h encoders' turn: chip_variants.py, PERF.md).
//
// The masked instantiation (kMasked, the stage-1 half of the two-stage
// wake cascade; no Pallas counterpart: it replaces the XLA-fused
// src/repro/core/fixed_point.py::masked_int_gru_scan :476) runs a frame
// only where the stream's wake bit is set (wake_bits.cuh).  An asleep
// frame stores the frozen h codes into hs and leaves the prologue's zero
// counts; the x staging still advances by blocks, so the next awake frame
// encodes its own x codes against the frozen x̂.  It skips the encoders,
// the row sums, the gates and both barriers.  Awake everywhere, it does
// the unmasked arithmetic.
//
// Launch knobs (the autotuner's, kernels/autotune.py).  block_b: the
// wrapper launches B / block_b times on one stream, each launch's CTAs
// serving consecutive streams from b0 (Args::b0; xs stays (T, B, I) with
// its full-B strides, nothing is copied).  block_t: the frames of x codes
// staged at a time (x_frames; the default min(32, T)), clipped to what
// shared memory holds.  The masked instantiation keeps the default
// launch.  No knob changes an operation or its order: every value is bit
// for bit the default's.
//
// Numerics.  Products |Δ|·|w| <= 2^16·2^7 = 2^23 are exact int32; the
// column sums (up to K·2^23 for K terms), their combination across lanes,
// the alignment left shift and the accumulator add are done in unsigned
// arithmetic, which wraps like XLA's int32 (and the plain version's
// float64 → int64 → int32 product) instead of being undefined, and is
// exact in any order.  Saturation happens once per frame, after the whole
// column sum and its alignment.  Right shifts of negative values are
// arithmetic.  σ and tanh are XLA's own float32 expansions
// (xla_math.cuh), so the codes equal the JAX reference's; no fast math;
// the r·m_hc product is one rounded float32 multiply, then the exact
// power-of-two scalings, in the plain version's order (XLA contracts
// nothing there).  rintf rounds half to even like torch.round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_gru_seq_int_frame.cuh"
#include "wake_bits.cuh"

namespace {

using namespace gru_int;

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// Shared-memory layout for input width I, hidden H (N = 3H columns) and a
// block of x_frames frames: int8 W_x (I rows) and W_h (H rows) at a row
// pitch of N rounded up to 4 bytes; the compacted (Δ, row offset) lists,
// warp w's segment from entry 32w (SX segments for x, SH for h); the m_x and
// m_h rows the gates read; the segment counts; the block's x codes (int16,
// [frame][component]).
struct Layout {
  int pitch, sx, sh;
  size_t wh, lx, lh, mxs, mhs, cnt, xst, total;
};

__host__ __device__ inline Layout layout(int I, int H, int x_frames) {
  Layout L;
  const int N = 3 * H;
  const size_t xf = static_cast<size_t>(x_frames);
  L.pitch = (N + 3) / 4 * 4;
  L.sx = (I + 31) / 32;
  L.sh = (H + 31) / 32;
  L.wh = static_cast<size_t>(I) * L.pitch;
  L.lx = round16(static_cast<size_t>(I + H) * L.pitch);
  L.lh = L.lx + sizeof(int2) * I;
  L.mxs = L.lh + sizeof(int2) * H;
  L.mhs = L.mxs + 4 * static_cast<size_t>(L.pitch);
  L.cnt = L.mhs + 4 * static_cast<size_t>(L.pitch);
  L.xst = L.cnt + round16(4 * static_cast<size_t>(L.sx + L.sh));
  L.total = L.xst + round16(2 * xf * I);
  return L;
}

struct Args {
  const int16_t* xs;
  const int16_t* h0;
  const int16_t* xh0;
  const int16_t* hh0;
  const int32_t* mx0;
  const int32_t* mh0;
  const int8_t* wx;
  const int8_t* wh;
  int16_t* hs;
  int32_t* nz_dx;
  int32_t* nz_dh;
  int16_t* h_out;
  int16_t* xh_out;
  int16_t* hh_out;
  int32_t* mx_out;
  int32_t* mh_out;
  int th_x, th_h, shift_x, shift_h, acc_bits, acc_frac, hid_frac;
  int T, B, I, H, x_frames;
  int w_vec;   // 3H % 16 == 0 and both weight arrays 16-byte aligned
  const uint8_t* awake;   // (T, B) wake trace; the masked instantiation's
  int b0;      // first stream of this launch (gridDim.x streams from b0)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Copy an int8 weight matrix of `rows` rows of N bytes into shared memory
// at `pitch` bytes per row (zero padding): 16-byte asynchronous copies
// when vec (waited for by the caller), bytes otherwise.
__device__ __forceinline__ void stage_weights(unsigned char* dst,
                                              const int8_t* src, int rows,
                                              int N, int pitch, bool vec) {
  if (vec) {                       // pitch == N, N % 16 == 0
    const int n = rows * N / 16;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      cp_async16(dst + 16 * k, src + 16 * k);
    }
  } else {
    const int n = rows * pitch;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int r = k / pitch, c = k - r * pitch;
      dst[k] = c < N ? static_cast<unsigned char>(src[r * N + c]) : 0;
    }
  }
}

template <bool kMasked>
__global__ void delta_gru_seq_int_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int I = a.I, H = a.H, N = 3 * H, B = a.B, T = a.T;
  const Layout L = layout(I, H, a.x_frames);
  unsigned char* wx = smem;
  unsigned char* wh = smem + L.wh;
  int2* lx = reinterpret_cast<int2*>(smem + L.lx);
  int2* lh = reinterpret_cast<int2*>(smem + L.lh);
  int32_t* mxs = reinterpret_cast<int32_t*>(smem + L.mxs);
  int32_t* mhs = reinterpret_cast<int32_t*>(smem + L.mhs);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + L.cnt);  // x, then h
  int16_t* xst = reinterpret_cast<int16_t*>(smem + L.xst);

  const int b = a.b0 + blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int xwarp = warp - (static_cast<int>(blockDim.x >> 5) - L.sx);
  const int xj = xwarp * 32 + lane;   // this thread's x component
  const unsigned lanes_below = (1u << lane) - 1u;
  // Column group and row split: lanes 4q..4q+3 share the group's four
  // columns, and after the reduce-scatter lane j holds column j.  Threads
  // past the last group repeat it and keep nothing.
  const int s = j % kSplit;
  const int group = min(j / kSplit, L.pitch / kCols - 1);
  const int col_off = group * kCols;

  const int32_t lim = 1 << (a.acc_bits - 1);
  GateConsts gc;
  gc.hid_frac = a.hid_frac;
  gc.one = 1 << a.hid_frac;
  gc.one_f = static_cast<float>(gc.one);
  gc.inv_one = ldexpf(1.0f, -a.hid_frac);   // exact powers of two
  gc.step = ldexpf(1.0f, -a.acc_frac);

  // The encoder of x component xj stages it for the block's frames from
  // t0 (all loads issued before the first store) and is the only thread
  // to read it back.
  const auto stage_x = [&](int t0) {
    const int nf = min(a.x_frames, T - t0);
    const int16_t* src = a.xs + (static_cast<size_t>(t0) * B + b) * I + xj;
#pragma unroll 32
    for (int f = 0; f < nf; ++f) {
      xst[f * I + xj] = src[static_cast<size_t>(f) * B * I];
    }
  };
  stage_weights(wx, a.wx, I, N, L.pitch, a.w_vec);
  stage_weights(wh, a.wh, H, N, L.pitch, a.w_vec);
  for (int f = j; f < T; f += blockDim.x) {
    a.nz_dx[static_cast<size_t>(f) * B + b] = 0;
    a.nz_dh[static_cast<size_t>(f) * B + b] = 0;
  }
  int32_t xhat = 0, hhat = 0, hcur = 0, mx = 0, mh = 0;
  if (xwarp >= 0 && xj < I) {
    xhat = a.xh0[b * I + xj];
    if (T > 0) stage_x(0);
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

  int tf = 0;                      // frame within the block
  for (int t = 0; t < T; ++t, tf = tf + 1 == a.x_frames ? 0 : tf + 1) {
    const size_t row = static_cast<size_t>(t) * B + b;
    if (tf == 0 && t > 0 && xwarp >= 0 && xj < I) stage_x(t);
    if (kMasked && !wake::is_awake(wb, a.awake, t, T, B, b, lane)) {
      if (j < H) a.hs[row * H + j] = static_cast<int16_t>(hcur);  // frozen
      continue;
    }
    // 1. Δ encoders, each warp compacting its own transmitted components.
    if (xwarp >= 0) {
      int32_t d = 0;
      const bool sent = xj < I && encode(xst[tf * I + xj], xhat, a.th_x, d);
      const unsigned m = __ballot_sync(0xffffffffu, sent);
      if (sent) lx[xwarp * 32 + __popc(m & lanes_below)] = make_int2(d, xj * L.pitch);
      if (lane == 0) cnt[xwarp] = __popc(m);
      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dx[row], __popc(m));
    }
    if (warp < L.sh) {
      int32_t d = 0;
      const bool sent = j < H && encode(hcur, hhat, a.th_h, d);
      const unsigned m = __ballot_sync(0xffffffffu, sent);
      if (sent) lh[warp * 32 + __popc(m & lanes_below)] = make_int2(d, j * L.pitch);
      if (lane == 0) cnt[L.sx + warp] = __popc(m);
      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dh[row], __popc(m));
    }
    __syncthreads();

    // 2. Column sums over the transmitted rows only, combined across the
    //    group's lanes, then align, accumulate and saturate once.
    uint32_t px[kCols] = {0u, 0u, 0u, 0u}, ph[kCols] = {0u, 0u, 0u, 0u};
    for (int w = 0; w < L.sx; ++w) {
      row_sums(px, lx + w * 32, cnt[w], s, wx + col_off);
    }
    for (int w = 0; w < L.sh; ++w) {
      row_sums(ph, lh + w * 32, cnt[L.sx + w], s, wh + col_off);
    }
    const uint32_t sum_x = reduce_scatter(px, s);
    const uint32_t sum_h = reduce_scatter(ph, s);
    if (j < N) {
      mx = accumulate(mx, sum_x, a.shift_x, lim);
      mh = accumulate(mh, sum_h, a.shift_h, lim);
      mxs[j] = mx;
      mhs[j] = mh;
    }
    __syncthreads();

    // 3. Type-2 GRU gates on threads j < H (ideal-LUT σ / tanh).
    if (j < H) {
      hcur = gates(mxs[j], mhs[j], mxs[H + j], mhs[H + j], mxs[2 * H + j],
                   mhs[2 * H + j], hcur, gc);
      a.hs[row * H + j] = static_cast<int16_t>(hcur);
    }
  }

  if (xwarp >= 0 && xj < I) a.xh_out[b * I + xj] = static_cast<int16_t>(xhat);
  if (j < H) {
    a.h_out[b * H + j] = static_cast<int16_t>(hcur);
    a.hh_out[b * H + j] = static_cast<int16_t>(hhat);
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

// Dynamic shared memory one CTA needs for input width I and hidden H with
// one staged frame of x codes (the least it runs with).
extern "C" long long delta_gru_seq_int_smem_bytes(int I, int H) {
  return static_cast<long long>(layout(I, H, 1).total);
}

// xs (T, B, I) int16; h0, hh0, h_out, hh_out (B, H) int16; xh0, xh_out
// (B, I) int16; mx0, mh0, mx_out, mh_out (B, 3H) int32; wx (I, 3H) and wh
// (H, 3H) int8; hs (T, B, H) int16; nz_dx, nz_dh (T, B) int32; awake null,
// or the (T, B) uint8 wake trace of the masked instantiation.  All
// contiguous on the current device.  Needs 2 <= acc_bits <= 31,
// 1 <= hid_frac <= 15 and |shift_x|, |shift_h| <= 30.  The launch follows
// the wrapper's plan (kernels/delta_gru_seq.py::gru_int_launch_plan): one
// CTA per stream of the `ctas` streams from b0 (b0 + ctas <= B) of
// `threads` threads, a warp multiple that covers 3H rounded up to 4
// columns and I, with smem_bytes of dynamic shared memory for x_frames >=
// 1 staged frames.  Launches on `stream`
// and returns the launch's (or the shared-memory attribute's) error, or
// cudaErrorInvalidValue for a plan this kernel cannot run.
extern "C" int delta_gru_seq_int_launch(
    const int16_t* xs, const int16_t* h0, const int16_t* xh0,
    const int16_t* hh0, const int32_t* mx0, const int32_t* mh0,
    const int8_t* wx, const int8_t* wh, int th_x, int th_h, int shift_x,
    int shift_h, int acc_bits, int acc_frac, int hid_frac, int16_t* hs,
    int32_t* nz_dx, int32_t* nz_dh, int16_t* h_out, int16_t* xh_out,
    int16_t* hh_out, int32_t* mx_out, int32_t* mh_out, int T, int B, int I,
    int H, int ctas, int threads, int smem_bytes, int x_frames, int b0,
    const uint8_t* awake, void* stream) {
  const Layout L = layout(I, H, x_frames > 0 ? x_frames : 1);
  if (ctas < 1 || b0 < 0 || b0 + ctas > B || threads % 32 != 0 ||
      threads > 1024 ||
      threads < L.pitch || threads < I || x_frames < 1 ||
      static_cast<size_t>(smem_bytes) < L.total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(Args) = awake != nullptr
                              ? delta_gru_seq_int_kernel<true>
                              : delta_gru_seq_int_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w_vec = (3 * H) % 16 == 0 &&
                            (reinterpret_cast<uintptr_t>(wx) & 15) == 0 &&
                            (reinterpret_cast<uintptr_t>(wh) & 15) == 0
                        ? 1
                        : 0;
  const Args args{xs, h0, xh0, hh0, mx0, mh0, wx, wh, hs, nz_dx, nz_dh,
                  h_out, xh_out, hh_out, mx_out, mh_out, th_x, th_h,
                  shift_x, shift_h, acc_bits, acc_frac, hid_frac, T, B, I,
                  H, x_frames, w_vec, awake, b0};
  kernel<<<ctas, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
