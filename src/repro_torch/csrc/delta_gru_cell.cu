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
// the type-2 gates.  Returns h', x̂', ĥ', M_x', M_h'.  It is one frame of
// csrc/delta_gru_seq.cu, through the same steps
// (delta_gru_seq_frame.cuh).
//
// What bounds it on this card.  Bytes, by the shapes: one step reads the
// weight rows of the transmitted deltas (at most 57 kB at I = 10,
// H = 64) and the state, writes the state, and does at most
// (I + H)·3H multiply-adds per stream.  At the paper's width that is well
// under a microsecond of either, so a launch is its chain of dependent
// steps: the launch itself, the state loads, the encode, the weight
// reads, the gates.  chip_smoke.py measures the floor under that chain
// (delta_gru_cell_floor_launch: an empty kernel, and one global round
// trip, at the cell's launch shape).
//
// What the design does about it.  One CTA per stream, one thread per
// pre-activation column (3H, rounded up to a warp); x component i belongs
// to lane i % 32 of the (i / 32)-th of the last ceil(I / 32) warps, h
// component j to thread j.  Every input (x, x̂, h, ĥ, M_x, M_h) is
// loaded in the first round trip.  The encoders compact their transmitted
// components per warp into (Δ, weight-row offset) lists; after one
// barrier thread j reads its column's entries of those rows straight from
// global memory (coalesced across j, L2-resident), up to kChunk rows of a
// warp's segment in flight before the first add, and sums them in
// ascending row order from 0 — the order of csrc/delta_gru_seq.cu; the
// threads of the r and u columns take σ of theirs.  After a second
// barrier the candidate and the blend run on threads j < H.  The design
// before staged the rows in a shared-memory tile first (twice as slow);
// 16 or 32 reads in flight ran slower than 8, 4 no faster
// (chip_variants.py).
//
// Numerics.  Built with --fmad=false and --ftz=true; σ and tanh are XLA's
// own float32 expansions (xla_math.cuh), and the gates fuse exactly the
// products XLA fuses (r·M_hc, u·h), as csrc/delta_gru_seq.cu does.
#include <cuda_runtime.h>

#include "delta_gru_seq_frame.cuh"

namespace {

using namespace gru_f;

constexpr int kChunk = 8;    // weight reads in flight per thread

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// Shared-memory layout, in bytes, for input width I and hidden H (N = 3H
// columns): the compacted (Δ, row offset) lists, warp w's segment from
// entry 32w (SX segments for x, SH for h); the segment counts; the M_x
// and M_h rows the gates read.
struct Layout {
  int sx, sh;
  size_t lh, cnt, mxs, mhs, total;
};

__host__ __device__ inline Layout layout(int I, int H) {
  Layout L;
  const size_t N = 3 * static_cast<size_t>(H);
  L.sx = (I + 31) / 32;
  L.sh = (H + 31) / 32;
  L.lh = sizeof(Row) * 32 * L.sx;
  L.cnt = L.lh + sizeof(Row) * 32 * L.sh;
  L.mxs = L.cnt + round16(4 * static_cast<size_t>(L.sx + L.sh));
  L.mhs = L.mxs + 4 * N;
  L.total = L.mhs + 4 * N;
  return L;
}

struct Args {
  const float* x;
  const float* h0;
  const float* xh0;
  const float* hh0;
  const float* mx0;
  const float* mh0;
  const float* wx;
  const float* wh;
  float* h_out;
  float* xh_out;
  float* hh_out;
  float* mx_out;
  float* mh_out;
  float threshold;
  int I, H;
};

// acc plus column j's sum over one segment's n rows, read from global
// memory at w + row offset: kChunk reads issued, then their adds in order.
__device__ __forceinline__ float segment_sum(float acc, const Row* list,
                                             int n, const float* w) {
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < n) v[u] = __ldg(w + list[k0 + u].off);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < n) acc = acc + list[k0 + u].d * v[u];
    }
  }
  return acc;
}

__global__ void __launch_bounds__(1024) delta_gru_cell_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int I = a.I, H = a.H, N = 3 * H;
  const Layout L = layout(I, H);
  Row* lx = reinterpret_cast<Row*>(smem);
  Row* lh = reinterpret_cast<Row*>(smem + L.lh);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);  // x, then h segments
  float* mxs = reinterpret_cast<float*>(smem + L.mxs);
  float* mhs = reinterpret_cast<float*>(smem + L.mhs);

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int xwarp = warp - (static_cast<int>(blockDim.x >> 5) - L.sx);
  const int xj = xwarp * 32 + lane;   // this thread's x component
  const bool x_enc = xwarp >= 0 && xj < I;
  const size_t col = static_cast<size_t>(b) * N + j;

  // Every input in one round trip.
  float xv = 0.0f, xhat = 0.0f, hcur = 0.0f, hhat = 0.0f, mx = 0.0f,
        mh = 0.0f;
  if (x_enc) {
    xv = a.x[b * I + xj];
    xhat = a.xh0[b * I + xj];
  }
  if (j < H) {
    hcur = a.h0[b * H + j];
    hhat = a.hh0[b * H + j];
  }
  if (j < N) {
    mx = a.mx0[col];
    mh = a.mh0[col];
  }

  // Δ encoders, each warp compacting its own transmitted components.
  if (xwarp >= 0) {
    float d = 0.0f;
    const bool sent = x_enc && encode(xv, xhat, a.threshold, d);
    const int n = compact(sent, d, xj * N, lx, 32 * xwarp);
    if (lane == 0) cnt[xwarp] = n;
    if (x_enc) a.xh_out[b * I + xj] = xhat;
  }
  if (warp < L.sh) {
    float d = 0.0f;
    const bool sent = j < H && encode(hcur, hhat, a.threshold, d);
    const int n = compact(sent, d, j * N, lh, 32 * warp);
    if (lane == 0) cnt[L.sx + warp] = n;
    if (j < H) a.hh_out[b * H + j] = hhat;
  }
  __syncthreads();

  // Column j of M_x and M_h over the transmitted rows only; then the r
  // and u columns' threads take their σ, the candidate's keep M.
  float r = 0.0f;
  if (j < N) {
    float ax = 0.0f, ah = 0.0f;
    for (int s = 0; s < L.sx; ++s) {
      ax = segment_sum(ax, lx + 32 * s, cnt[s], a.wx + j);
    }
    for (int s = 0; s < L.sh; ++s) {
      ah = segment_sum(ah, lh + 32 * s, cnt[L.sx + s], a.wh + j);
    }
    mx = mx + ax;
    mh = mh + ah;
    a.mx_out[col] = mx;
    a.mh_out[col] = mh;
    if (j < H) {
      r = gate_sigmoid(mx, mh);
    } else if (j < 2 * H) {
      mxs[j] = gate_sigmoid(mx, mh);                // u
    } else {
      mxs[j] = mx;
      mhs[j] = mh;
    }
  }
  __syncthreads();

  // The candidate and the blend on threads j < H.
  if (j < H) {
    a.h_out[b * H + j] = candidate_blend(r, mxs[H + j], mxs[2 * H + j],
                                         mhs[2 * H + j], hcur);
  }
}

// The launch floor under the cell: with `dependent`, each thread loads one
// float and stores it plus one (one dependent global round trip); without,
// nothing.
__global__ void floor_kernel(float* buf, int dependent) {
  if (dependent) {
    const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
    buf[i] = buf[i] + 1.0f;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for input width I and hidden H.
extern "C" long long delta_gru_cell_smem_bytes(int I, int H) {
  return static_cast<long long>(layout(I, H).total);
}

// x, xh0, xh_out (B, I); h0, hh0, h_out, hh_out (B, H); mx0, mh0, mx_out,
// mh_out (B, 3H); wx (I, 3H); wh (H, 3H).  All contiguous float32 on the
// current device.  Needs I <= 3H rounded up to a warp multiple and
// 3H <= 1024.  Launches on `stream` and returns the launch's error, or
// cudaErrorInvalidValue for a shape this kernel cannot run.
extern "C" int delta_gru_cell_launch(
    const float* x, const float* h0, const float* xh0, const float* hh0,
    const float* mx0, const float* mh0, const float* wx, const float* wh,
    float threshold, float* h_out, float* xh_out, float* hh_out,
    float* mx_out, float* mh_out, int B, int I, int H, void* stream) {
  const int threads = ((3 * H + 31) / 32) * 32;
  if (H < 1 || threads > 1024 || I > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(I, H).total;
  const Args args{x, h0, xh0, hh0, mx0, mh0, wx, wh, h_out, xh_out, hh_out,
                  mx_out, mh_out, threshold, I, H};
  delta_gru_cell_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Launches floor_kernel with the cell's launch shape at hidden H (B CTAs
// of 3H rounded up to a warp) on `stream`; buf holds one float per thread
// when `dependent`.  Returns the launch's error.
extern "C" int delta_gru_cell_floor_launch(float* buf, int dependent, int B,
                                           int H, void* stream) {
  const int threads = ((3 * H + 31) / 32) * 32;
  floor_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, dependent);
  return static_cast<int>(cudaGetLastError());
}
