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
// frame the Δ-encode, the matvec and the gates depend on each other.
//
// What the design does about it.  One persistent CTA per stream runs all
// T frames in-kernel.  W_x (I×3H) and W_h (H×3H) load into shared memory
// once per launch (56,832 bytes at I=10, H=64, above the 48 KB static
// limit, hence dynamic shared memory and cudaFuncSetAttribute); x̂, ĥ, h
// stay in shared memory and each thread keeps its M_x/M_h column in
// registers across frames.  Per frame only hs and the two counts go to
// device memory.  The paper's per-column skip: each frame the transmitted
// deltas are compacted (warp ballot + prefix over warps, in index order),
// and thread j of 3H accumulates column j over those entries only.  Zero
// deltas add nothing, and the non-zero terms are summed in index order
// starting from 0, so the sum is what a sequential dense dot would give.
// The gates run on threads j < H after a barrier.
//
// Numerics.  Compiled with --fmad=false (multiply then add, as PyTorch's
// eager ops) and --ftz=true (XLA:CPU flushes denormals).  σ and tanh are
// XLA's own float32 expansions (xla_math.cuh), and the gates fuse the two
// products that XLA fuses: r·M_hc into the candidate's pre-activation and
// u·h into the blend.
#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace {

// Shared-memory layout, in 4-byte words, for input width I, hidden H,
// N = 3H columns: W_x, W_h, x̂, ĥ, h, compacted Δx (values, indices),
// compacted Δh (values, indices), M_x and M_h staging, 64 warp counts.
__host__ __device__ inline size_t smem_words(int I, int H) {
  const size_t N = 3 * static_cast<size_t>(H);
  return (I + H) * N + I + 2 * H + 2 * I + 2 * H + 2 * N + 64;
}

__global__ void delta_gru_seq_kernel(
    const float* __restrict__ xs, const float* __restrict__ h0,
    const float* __restrict__ xh0, const float* __restrict__ hh0,
    const float* __restrict__ mx0, const float* __restrict__ mh0,
    const float* __restrict__ wx_g, const float* __restrict__ wh_g,
    float threshold, float* __restrict__ hs, int* __restrict__ nz_dx,
    int* __restrict__ nz_dh, float* __restrict__ h_out,
    float* __restrict__ xh_out, float* __restrict__ hh_out,
    float* __restrict__ mx_out, float* __restrict__ mh_out, int T, int B,
    int I, int H) {
  extern __shared__ float smem[];
  const int N = 3 * H;
  float* wx = smem;
  float* wh = wx + I * N;
  float* xhat = wh + H * N;
  float* hhat = xhat + I;
  float* hcur = hhat + H;
  float* lx_val = hcur + H;
  int* lx_idx = reinterpret_cast<int*>(lx_val + I);
  float* lh_val = reinterpret_cast<float*>(lx_idx + I);
  int* lh_idx = reinterpret_cast<int*>(lh_val + H);
  float* mxs = reinterpret_cast<float*>(lh_idx + H);
  float* mhs = mxs + N;
  int* wcnt = reinterpret_cast<int*>(mhs + N);  // [0,32): Δx, [32,64): Δh

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int k = j; k < I * N; k += blockDim.x) wx[k] = wx_g[k];
  for (int k = j; k < H * N; k += blockDim.x) wh[k] = wh_g[k];
  if (j < I) xhat[j] = xh0[b * I + j];
  if (j < H) {
    hhat[j] = hh0[b * H + j];
    hcur[j] = h0[b * H + j];
  }
  float mx = 0.0f, mh = 0.0f;
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
    float dx = 0.0f, dh = 0.0f;
    if (j < I) {
      const float v = xs[row * I + j];
      const float diff = v - xhat[j];
      fx = fabsf(diff) > threshold;
      if (fx) {
        dx = diff;
        xhat[j] = v;
      }
    }
    if (j < H) {
      const float v = hcur[j];
      const float diff = v - hhat[j];
      fh = fabsf(diff) > threshold;
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

    // Column j of M_x and M_h over the transmitted rows only.
    if (j < N) {
      float ax = 0.0f, ah = 0.0f;
      for (int k = 0; k < nx; ++k) ax += lx_val[k] * wx[lx_idx[k] * N + j];
      for (int k = 0; k < nh; ++k) ah += lh_val[k] * wh[lh_idx[k] * N + j];
      mx = mx + ax;
      mh = mh + ah;
      mxs[j] = mx;
      mhs[j] = mh;
    }
    if (j == 0) {
      nz_dx[row] = nx;
      nz_dh[row] = nh;
    }
    __syncthreads();

    // Type-2 GRU gates on threads j < H.
    if (j < H) {
      const float r = xla_math::sigmoid(mxs[j] + mhs[j]);
      const float u = xla_math::sigmoid(mxs[H + j] + mhs[H + j]);
      const float c = xla_math::tanh(fmaf(r, mhs[2 * H + j], mxs[2 * H + j]));
      const float h_new = fmaf(u, hcur[j], (1.0f - u) * c);
      hcur[j] = h_new;
      hs[row * H + j] = h_new;
    }
    __syncthreads();
  }

  if (j < I) xh_out[b * I + j] = xhat[j];
  if (j < H) {
    h_out[b * H + j] = hcur[j];
    hh_out[b * H + j] = hhat[j];
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
extern "C" long long delta_gru_seq_smem_bytes(int I, int H) {
  return static_cast<long long>(smem_words(I, H) * 4);
}

// xs (T, B, I); h0, hh0, h_out, hh_out (B, H); xh0, xh_out (B, I);
// mx0, mh0, mx_out, mh_out (B, 3H); wx (I, 3H); wh (H, 3H); hs (T, B, H);
// nz_dx, nz_dh (T, B) int32.  All contiguous float32 (counts int32) on
// the current device.  Needs I <= 3H rounded up to a warp multiple and
// 3H <= 1024.  Launches on `stream` and returns the first error.
extern "C" int delta_gru_seq_launch(
    const float* xs, const float* h0, const float* xh0, const float* hh0,
    const float* mx0, const float* mh0, const float* wx, const float* wh,
    float threshold, float* hs, int* nz_dx, int* nz_dh, float* h_out,
    float* xh_out, float* hh_out, float* mx_out, float* mh_out, int T, int B,
    int I, int H, void* stream) {
  const int threads = ((3 * H + 31) / 32) * 32;
  const size_t smem = smem_words(I, H) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      delta_gru_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  delta_gru_seq_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      xs, h0, xh0, hh0, mx0, mh0, wx, wh, threshold, hs, nz_dx, nz_dh, h_out,
      xh_out, hh_out, mx_out, mh_out, T, B, I, H);
  return static_cast<int>(cudaGetLastError());
}
