// One fused delta-gated GRU (ΔGRU) step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/delta_gru_cell.py::delta_gru_cell (pallas_call :62,
//   body _kernel :23; step math kernels/gru_math.py delta_branch :16,
//   gru_gates :31).
//
// What it computes.  One frame of the ΔGRU for each of B streams, with no
// bias (the TPU kernel adds none; M_x carries it when the caller wants
// one): Δ-encode x and h against x̂/ĥ at Δ_TH (strict >; x̂/ĥ advance
// only on transmitted components), M_x += Δx·W_x and M_h += Δh·W_h, then
// the type-2 gates.  Returns h', x̂', ĥ', M_x', M_h'.
//
// What bounds it on this card.  Bytes: one step reads the weight rows of
// the transmitted deltas (at most 57 kB at I = 10, H = 64) and the
// state, writes the state, and does at most (I + H)·3H multiply-adds per
// stream — 14,208 at full width, fewer with sparse deltas.  Per stream
// the Δ-encode, the matvec and the gates depend on each other, so a
// launch is a short dependent chain.
//
// What the design does about it.  One CTA per stream, one thread per
// pre-activation column (3H, rounded up to a warp).  x̂, ĥ, h sit in
// dynamic shared memory.  The transmitted deltas are compacted in index
// order (warp ballot + prefix over warps), and only their weight rows
// are fetched: staged, coalesced, into a tile of R rows in dynamic
// shared memory (R as many as the card's 227 KB hold, all I + H rows at
// the paper's width; wider models take several passes).  Thread j sums
// column j over the staged rows in index order, from 0, then adds the
// sum to M[j]: the paper's per-column skip, and the order of
// csrc/delta_gru_seq.cu.  The gates run on threads j < H.
//
// Numerics.  Built with --fmad=false and --ftz=true; σ and tanh are XLA's
// own float32 expansions (xla_math.cuh), and the gates fuse exactly the
// products XLA fuses (r·M_hc, u·h), as csrc/delta_gru_seq.cu does.
#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace {

// Shared-memory layout, in 4-byte words, for input width I, hidden H,
// N = 3H columns and a tile of R weight rows: x̂, ĥ, h, compacted Δx
// (values, indices), compacted Δh (values, indices), M_x and M_h
// staging, 64 warp counts, then the R × N weight tile.
__host__ __device__ inline size_t smem_words(int I, int H, int R) {
  const size_t N = 3 * static_cast<size_t>(H);
  return I + 2 * H + 2 * I + 2 * H + 2 * N + 64 + R * N;
}

__global__ void delta_gru_cell_kernel(
    const float* __restrict__ x, const float* __restrict__ h0,
    const float* __restrict__ xh0, const float* __restrict__ hh0,
    const float* __restrict__ mx0, const float* __restrict__ mh0,
    const float* __restrict__ wx_g, const float* __restrict__ wh_g,
    float threshold, float* __restrict__ h_out, float* __restrict__ xh_out,
    float* __restrict__ hh_out, float* __restrict__ mx_out,
    float* __restrict__ mh_out, int I, int H, int R) {
  extern __shared__ float smem[];
  const int N = 3 * H;
  float* xhat = smem;
  float* hhat = xhat + I;
  float* hcur = hhat + H;
  float* lx_val = hcur + H;
  int* lx_idx = reinterpret_cast<int*>(lx_val + I);
  float* lh_val = reinterpret_cast<float*>(lx_idx + I);
  int* lh_idx = reinterpret_cast<int*>(lh_val + H);
  float* mxs = reinterpret_cast<float*>(lh_idx + H);
  float* mhs = mxs + N;
  int* wcnt = reinterpret_cast<int*>(mhs + N);  // [0,32): Δx, [32,64): Δh
  float* tile = reinterpret_cast<float*>(wcnt + 64);  // R × N weight rows

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  if (j < I) xhat[j] = xh0[b * I + j];
  if (j < H) {
    hhat[j] = hh0[b * H + j];
    hcur[j] = h0[b * H + j];
  }
  __syncthreads();

  // Δ encoders: thread j owns x component j (j < I) and h component j
  // (j < H).
  bool fx = false, fh = false;
  float dx = 0.0f, dh = 0.0f;
  if (j < I) {
    const float v = x[b * I + j];
    const float diff = v - xhat[j];
    fx = fabsf(diff) > threshold;
    if (fx) {
      dx = diff;
      xhat[j] = v;
    }
    xh_out[b * I + j] = xhat[j];
  }
  if (j < H) {
    const float v = hcur[j];
    const float diff = v - hhat[j];
    fh = fabsf(diff) > threshold;
    if (fh) {
      dh = diff;
      hhat[j] = v;
    }
    hh_out[b * H + j] = hhat[j];
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

  // Column j of M_x and M_h over the transmitted rows only: the list of
  // nx Δx rows then nh Δh rows, staged R rows at a time.
  float ax = 0.0f, ah = 0.0f;
  for (int base = 0; base < nx + nh; base += R) {
    const int n = min(R, nx + nh - base);
    for (int e = j; e < n * N; e += blockDim.x) {
      const int k = base + e / N;
      const int c = e - (e / N) * N;
      tile[e] = k < nx ? wx_g[static_cast<size_t>(lx_idx[k]) * N + c]
                       : wh_g[static_cast<size_t>(lh_idx[k - nx]) * N + c];
    }
    __syncthreads();
    if (j < N) {
      for (int k = 0; k < n; ++k) {
        const int g = base + k;
        if (g < nx) {
          ax += lx_val[g] * tile[k * N + j];
        } else {
          ah += lh_val[g - nx] * tile[k * N + j];
        }
      }
    }
    __syncthreads();
  }
  if (j < N) {
    const size_t col = static_cast<size_t>(b) * N + j;
    const float mx = mx0[col] + ax;
    const float mh = mh0[col] + ah;
    mxs[j] = mx;
    mhs[j] = mh;
    mx_out[col] = mx;
    mh_out[col] = mh;
  }
  __syncthreads();

  // Type-2 GRU gates on threads j < H.
  if (j < H) {
    const float r = xla_math::sigmoid(mxs[j] + mhs[j]);
    const float u = xla_math::sigmoid(mxs[H + j] + mhs[H + j]);
    const float c = xla_math::tanh(fmaf(r, mhs[2 * H + j], mxs[2 * H + j]));
    h_out[b * H + j] = fmaf(u, hcur[j], (1.0f - u) * c);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for input width I, hidden H and a
// tile of R weight rows.
extern "C" long long delta_gru_cell_smem_bytes(int I, int H, int R) {
  return static_cast<long long>(smem_words(I, H, R) * 4);
}

// x, xh0, xh_out (B, I); h0, hh0, h_out, hh_out (B, H); mx0, mh0, mx_out,
// mh_out (B, 3H); wx (I, 3H); wh (H, 3H).  All contiguous float32 on the
// current device.  Needs I <= 3H rounded up to a warp multiple, 3H <= 1024
// and R >= 1 weight rows in the shared-memory tile.  Launches on `stream`
// and returns the first error.
extern "C" int delta_gru_cell_launch(
    const float* x, const float* h0, const float* xh0, const float* hh0,
    const float* mx0, const float* mh0, const float* wx, const float* wh,
    float threshold, float* h_out, float* xh_out, float* hh_out,
    float* mx_out, float* mh_out, int B, int I, int H, int R, void* stream) {
  const int threads = ((3 * H + 31) / 32) * 32;
  const size_t smem = smem_words(I, H, R) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      delta_gru_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  delta_gru_cell_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, h0, xh0, hh0, mx0, mh0, wx, wh, threshold, h_out, xh_out, hh_out,
      mx_out, mh_out, I, H, R);
  return static_cast<int>(cudaGetLastError());
}
