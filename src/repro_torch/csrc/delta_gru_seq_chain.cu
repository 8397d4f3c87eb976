// Latency probe for the float ΔGRU kernel's frame (csrc/delta_gru_seq.cu).
//
// One warp runs the kernel's own per-frame critical path
// (delta_gru_seq_frame.cuh) `frames` times: each lane Δ-encodes its h
// component and the warp compacts them with a ballot; each lane sums its
// column over the transmitted rows, laid out as the serving model's
// (I = 10, H = 64) are: one x segment of rows_x <= 10 rows, then two h
// segments, the first the rows just encoded (up to 32), the second fixed
// ones, rows_h <= 64 in all; one rounded product and one add per row, in
// row order; then σ of the lane's own column (the kernel takes σ of the r
// and the u columns side by side, in different threads), and the
// candidate's tanh and the blend, from the next lane's σ as u and a third
// column's pre-activations read back from shared memory, give each lane
// its next h.  With rows_x = 10 and rows_h = 64 every row is sent, the
// densest frame.  The CTA-wide barriers are __syncwarp here and no other
// warp competes for the SM, so the time per frame is the latency of the
// frame's chain as compiled, and `frames` of them the least time a chunk
// of that many frames can take.
#include <cuda_runtime.h>

#include "delta_gru_seq_frame.cuh"

namespace {

using namespace gru_f;

constexpr int kXRows = 10, kHRows = 64, kCols = 32;

__global__ void chain_kernel(int frames, int rows_x, int rows_h,
                             long long* out, float* sink) {
  __shared__ float w[(kXRows + kHRows) * kCols];
  __shared__ Row lx[32], lh[64];
  __shared__ float mxs[kCols], mhs[kCols], sig[kCols];
  __shared__ int cnt[3];
  const int lane = threadIdx.x;
  for (int k = lane; k < (kXRows + kHRows) * kCols; k += 32) {
    w[k] = static_cast<float>((k * 37 + 11) % 255 - 127) * (1.0f / 1024.0f);
  }
  if (lane < kXRows) lx[lane] = Row{0.01f * (lane - 5), lane * kCols};
  lh[32 + lane] = Row{0.02f * (lane - 16), (kXRows + 32 + lane) * kCols};
  if (lane == 0) {
    cnt[0] = rows_x;
    cnt[2] = max(rows_h - 32, 0);
  }
  float hcur = 0.03f * (lane - 16), hhat = 0.0f;
  float mx = 0.01f * lane, mh = -0.01f * lane;
  __syncwarp();

  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int f = 0; f < frames; ++f) {
    float d = 0.0f;
    const bool sent = encode(hcur, hhat, -1.0f, d);
    const int n = compact(sent, d, (kXRows + lane) * kCols, lh, 0);
    if (lane == 0) cnt[1] = min(n, rows_h);
    __syncwarp();
    const float ax = column_sum(0.0f, lx, cnt[0], w + lane);
    float ah = column_sum(0.0f, lh, cnt[1], w + lane);
    ah = column_sum(ah, lh + 32, cnt[2], w + lane);
    mx = mx + ax;
    mh = mh + ah;
    const float r = gate_sigmoid(mx, mh);   // this column as r, and as u
    sig[lane] = r;                          // for the lane below
    mxs[lane] = mx;
    mhs[lane] = mh;
    __syncwarp();
    const int c = (lane + 2) & 31;
    hcur = candidate_blend(r, sig[(lane + 1) & 31], mxs[c], mhs[c], hcur);
    __syncwarp();
  }
  const long long c1 = clock64();
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
  }
  sink[lane] = hcur;                    // keeps the chain
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs `frames` frames of the chain on one warp with rows_x (<= 10) x
// rows and rows_h (<= 64) h rows transmitted per frame, synchronously;
// out[0] = cycles, out[1] = nanoseconds.  Returns the launch's or the
// copy's error, or cudaErrorInvalidValue for row counts out of range.
extern "C" int delta_gru_seq_chain(int frames, int rows_x, int rows_h,
                                   long long* out) {
  if (rows_x < 0 || rows_x > kXRows || rows_h < 0 || rows_h > kHRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* d = nullptr;
  float* sink = nullptr;
  cudaError_t err = cudaMalloc(&d, 2 * sizeof(long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(&sink, 32 * sizeof(float));
  if (err == cudaSuccess) {
    chain_kernel<<<1, 32>>>(frames, rows_x, rows_h, d, sink);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    err = cudaMemcpy(out, d, 2 * sizeof(long long), cudaMemcpyDeviceToHost);
  }
  cudaFree(sink);
  cudaFree(d);
  return static_cast<int>(err);
}
