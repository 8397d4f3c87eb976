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
// the products and the gates depend on each other.
//
// What the design does about it.  One persistent CTA per stream runs all
// T frames in-kernel (as csrc/delta_gru_seq.cu).  W_x and W_h load into
// shared memory once per launch as int8; x̂, ĥ, h stay in shared memory
// and thread j keeps accumulator columns m_x[j] and m_h[j] in registers
// across frames.  Per frame only hs and the two counts go to device
// memory.  The paper's per-column skip: the transmitted deltas are
// compacted each frame (warp ballot + prefix over warps), and thread j of
// 3H sums column j over those entries only.  Integer sums do not depend on
// order, so the skip is exact.
//
// Numerics.  Products |Δ|·|w| <= 2^16·2^7 = 2^23 are exact int32; the
// column sums (up to K·2^23 for K terms), the alignment left shift and
// the accumulator add are done in unsigned arithmetic, which wraps like
// XLA's int32 (and the plain version's float64 → int64 → int32 product)
// instead of being undefined.  Right shifts of negative values are
// arithmetic.  σ and tanh are XLA's own float32 expansions
// (xla_math.cuh), so the codes equal the JAX reference's; no fast math;
// the r·m_hc product is one rounded float32 multiply, then the exact
// power-of-two scalings, in the plain version's order (XLA contracts
// nothing there).  rintf rounds half to even like torch.round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

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

// Shared-memory layout for input width I, hidden H, N = 3H columns: int8
// W_x (I×N) and W_h (H×N), padded to 4 bytes; then 32-bit words: x̂, ĥ,
// h, compacted Δx (values, indices), compacted Δh (values, indices), the
// m_x and m_h staging rows, 64 warp counts.
__host__ __device__ inline size_t weight_bytes(int I, int H) {
  return (static_cast<size_t>(I + H) * 3 * H + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_bytes(int I, int H) {
  const size_t N = 3 * static_cast<size_t>(H);
  return weight_bytes(I, H) + 4 * (I + 2 * H + 2 * I + 2 * H + 2 * N + 64);
}

__global__ void delta_gru_seq_int_kernel(
    const int16_t* __restrict__ xs, const int16_t* __restrict__ h0,
    const int16_t* __restrict__ xh0, const int16_t* __restrict__ hh0,
    const int32_t* __restrict__ mx0, const int32_t* __restrict__ mh0,
    const int8_t* __restrict__ wx_g, const int8_t* __restrict__ wh_g,
    int th_x, int th_h, int shift_x, int shift_h, int acc_bits, int acc_frac,
    int hid_frac, int16_t* __restrict__ hs, int32_t* __restrict__ nz_dx,
    int32_t* __restrict__ nz_dh, int16_t* __restrict__ h_out,
    int16_t* __restrict__ xh_out, int16_t* __restrict__ hh_out,
    int32_t* __restrict__ mx_out, int32_t* __restrict__ mh_out, int T, int B,
    int I, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = 3 * H;
  int8_t* wx = reinterpret_cast<int8_t*>(smem);
  int8_t* wh = wx + I * N;
  int32_t* xhat = reinterpret_cast<int32_t*>(smem + weight_bytes(I, H));
  int32_t* hhat = xhat + I;
  int32_t* hcur = hhat + H;
  int32_t* lx_val = hcur + H;
  int32_t* lx_idx = lx_val + I;
  int32_t* lh_val = lx_idx + I;
  int32_t* lh_idx = lh_val + H;
  int32_t* mxs = lh_idx + H;
  int32_t* mhs = mxs + N;
  int32_t* wcnt = mhs + N;  // [0,32): Δx, [32,64): Δh

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  const int32_t acc_lim = 1 << (acc_bits - 1);
  const int32_t one = 1 << hid_frac;
  const float one_f = static_cast<float>(one);
  const float inv_one = ldexpf(1.0f, -hid_frac);   // exact powers of two
  const float step = ldexpf(1.0f, -acc_frac);

  for (int k = j; k < I * N; k += blockDim.x) wx[k] = wx_g[k];
  for (int k = j; k < H * N; k += blockDim.x) wh[k] = wh_g[k];
  if (j < I) xhat[j] = xh0[b * I + j];
  if (j < H) {
    hhat[j] = hh0[b * H + j];
    hcur[j] = h0[b * H + j];
  }
  int32_t mx = 0, mh = 0;
  if (j < N) {
    mx = mx0[static_cast<size_t>(b) * N + j];
    mh = mh0[static_cast<size_t>(b) * N + j];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    // Δ encoders: thread j owns x component j (j < I) and h component j
    // (j < H).  Only the owner reads or writes x̂[j], ĥ[j] and h[j].
    bool fx = false, fh = false;
    int32_t dx = 0, dh = 0;
    if (j < I) {
      const int32_t v = xs[row * I + j];
      const int32_t diff = v - xhat[j];
      fx = (diff < 0 ? -diff : diff) > th_x;
      if (fx) {
        dx = diff;
        xhat[j] = v;
      }
    }
    if (j < H) {
      const int32_t v = hcur[j];
      const int32_t diff = v - hhat[j];
      fh = (diff < 0 ? -diff : diff) > th_h;
      if (fh) {
        dh = diff;
        hhat[j] = v;
      }
    }
    // Compact the transmitted components in index order.
    const unsigned bx = __ballot_sync(0xffffffffu, fx);
    const unsigned bh = __ballot_sync(0xffffffffu, fh);
    if (lane == 0) {
      wcnt[warp] = __popc(bx);
      wcnt[32 + warp] = __popc(bh);
    }
    __syncthreads();
    int off_x = 0, off_h = 0, nx = 0, nh = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) {
        off_x += wcnt[w];
        off_h += wcnt[32 + w];
      }
      nx += wcnt[w];
      nh += wcnt[32 + w];
    }
    if (fx) {
      const int p = off_x + __popc(bx & lanes_below);
      lx_val[p] = dx;
      lx_idx[p] = j;
    }
    if (fh) {
      const int p = off_h + __popc(bh & lanes_below);
      lh_val[p] = dh;
      lh_idx[p] = j;
    }
    __syncthreads();

    // Column j of both products over the transmitted rows only, then
    // align, accumulate and saturate once.
    if (j < N) {
      uint32_t px = 0u, ph = 0u;
      for (int k = 0; k < nx; ++k) {
        px += static_cast<uint32_t>(
            lx_val[k] * static_cast<int32_t>(wx[lx_idx[k] * N + j]));
      }
      for (int k = 0; k < nh; ++k) {
        ph += static_cast<uint32_t>(
            lh_val[k] * static_cast<int32_t>(wh[lh_idx[k] * N + j]));
      }
      mx = sat(wrap_add(mx, align(static_cast<int32_t>(px), shift_x)),
               acc_lim);
      mh = sat(wrap_add(mh, align(static_cast<int32_t>(ph), shift_h)),
               acc_lim);
      mxs[j] = mx;
      mhs[j] = mh;
    }
    if (j == 0) {
      nz_dx[row] = nx;
      nz_dh[row] = nh;
    }
    __syncthreads();

    // Type-2 GRU gates on threads j < H (ideal-LUT σ / tanh).
    if (j < H) {
      const float pr = static_cast<float>(wrap_add(mxs[j], mhs[j])) * step;
      const float pu =
          static_cast<float>(wrap_add(mxs[H + j], mhs[H + j])) * step;
      const int32_t r =
          static_cast<int32_t>(rintf(xla_math::sigmoid(pr) * one_f));
      const int32_t u =
          static_cast<int32_t>(rintf(xla_math::sigmoid(pu) * one_f));
      const float c_pre =
          (static_cast<float>(mxs[2 * H + j]) +
           static_cast<float>(r) * static_cast<float>(mhs[2 * H + j]) *
               inv_one) *
          step;
      const int32_t c =
          static_cast<int32_t>(rintf(xla_math::tanh(c_pre) * one_f));
      // |u·h + (one - u)·c| <= 2^hid · 2^15: a convex combination of two
      // values within 2^15, so it stays inside int32 for hid <= 15.
      const int32_t blend = u * hcur[j] + (one - u) * c;
      const int32_t h_new =
          sat(wrap_add(blend, 1 << (hid_frac - 1)) >> hid_frac, 32768);
      hcur[j] = h_new;
      hs[row * H + j] = static_cast<int16_t>(h_new);
    }
    __syncthreads();
  }

  if (j < I) xh_out[b * I + j] = static_cast<int16_t>(xhat[j]);
  if (j < H) {
    h_out[b * H + j] = static_cast<int16_t>(hcur[j]);
    hh_out[b * H + j] = static_cast<int16_t>(hhat[j]);
  }
  if (j < N) {
    mx_out[static_cast<size_t>(b) * N + j] = mx;
    mh_out[static_cast<size_t>(b) * N + j] = mh;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for input width I and hidden H.
extern "C" long long delta_gru_seq_int_smem_bytes(int I, int H) {
  return static_cast<long long>(smem_bytes(I, H));
}

// xs (T, B, I) int16; h0, hh0, h_out, hh_out (B, H) int16; xh0, xh_out
// (B, I) int16; mx0, mh0, mx_out, mh_out (B, 3H) int32; wx (I, 3H) and wh
// (H, 3H) int8; hs (T, B, H) int16; nz_dx, nz_dh (T, B) int32.  All
// contiguous on the current device.  Needs I <= 3H rounded up to a warp
// multiple, 3H <= 1024, 2 <= acc_bits <= 31, 1 <= hid_frac <= 15 and
// |shift_x|, |shift_h| <= 30.  Launches on `stream` and returns the first
// error.
extern "C" int delta_gru_seq_int_launch(
    const int16_t* xs, const int16_t* h0, const int16_t* xh0,
    const int16_t* hh0, const int32_t* mx0, const int32_t* mh0,
    const int8_t* wx, const int8_t* wh, int th_x, int th_h, int shift_x,
    int shift_h, int acc_bits, int acc_frac, int hid_frac, int16_t* hs,
    int32_t* nz_dx, int32_t* nz_dh, int16_t* h_out, int16_t* xh_out,
    int16_t* hh_out, int32_t* mx_out, int32_t* mh_out, int T, int B, int I,
    int H, void* stream) {
  const int threads = ((3 * H + 31) / 32) * 32;
  const size_t smem = smem_bytes(I, H);
  cudaError_t err = cudaFuncSetAttribute(
      delta_gru_seq_int_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  delta_gru_seq_int_kernel<<<B, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      xs, h0, xh0, hh0, mx0, mh0, wx, wh, th_x, th_h, shift_x, shift_h,
      acc_bits, acc_frac, hid_frac, hs, nz_dx, nz_dh, h_out, xh_out, hh_out,
      mx_out, mh_out, T, B, I, H);
  return static_cast<int>(cudaGetLastError());
}
