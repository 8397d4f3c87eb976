// Latency probe for the integer ΔGRU kernel's frame (csrc/delta_gru_seq_int.cu).
//
// One warp runs the kernel's own per-frame critical path
// (delta_gru_seq_int_frame.cuh) `frames` times: each lane Δ-encodes its h
// component and the warp compacts them with a ballot; each lane sums its
// share of its column group over the transmitted rows, laid out as the
// serving model's (I = 10, H = 64) are: one x segment of rows_x <= 10
// rows, then two h segments, the first the rows just encoded (up to 32),
// the second fixed ones, rows_h <= 64 in all; the group's four lanes
// combine their sums by the reduce-scatter, then align, accumulate and
// saturate; then the gates — σ(r), σ(u), the candidate, tanh and the
// blend — give each lane its next h.  With rows_x = 10 and rows_h = 64
// every row is sent, the densest frame.  The CTA-wide barriers are
// __syncwarp here and no other warp competes for the SM, so the time per
// frame is the latency of the frame's chain as compiled, and `frames` of
// them the least time a chunk of that many frames can take.
#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_gru_seq_int_frame.cuh"

namespace {

using namespace gru_int;

constexpr int kXRows = 10, kHRows = 64, kPitch = 32;   // 32 columns

__global__ void chain_kernel(int frames, int rows_x, int rows_h,
                             int shift_x, int shift_h,
                             int acc_bits, int acc_frac, int hid_frac,
                             long long* out, int32_t* sink) {
  __shared__ __align__(16) unsigned char w[(kXRows + kHRows) * kPitch];
  __shared__ int2 lx[32], lh[64];
  __shared__ int32_t mxs[32], mhs[32], cnt[3];
  const int lane = threadIdx.x;
  const int s = lane % kSplit, col_off = lane / kSplit * kCols;
  for (int k = lane; k < (kXRows + kHRows) * kPitch; k += 32) {
    w[k] = static_cast<unsigned char>((k * 37 + 11) % 255 - 127);
  }
  if (lane < kXRows) lx[lane] = make_int2(lane * 5 - 20, lane * kPitch);
  lh[32 + lane] = make_int2(lane * 3 - 40, (kXRows + 32 + lane) * kPitch);
  if (lane == 0) {
    cnt[0] = rows_x;
    cnt[2] = max(rows_h - 32, 0);
  }
  GateConsts gc;
  gc.hid_frac = hid_frac;
  gc.one = 1 << hid_frac;
  gc.one_f = static_cast<float>(gc.one);
  gc.inv_one = ldexpf(1.0f, -hid_frac);
  gc.step = ldexpf(1.0f, -acc_frac);
  const int32_t lim = 1 << (acc_bits - 1);
  int32_t hcur = lane * 1000 - 16000, hhat = 0, mx = lane * 97, mh = -lane;
  const unsigned lanes_below = (1u << lane) - 1u;
  __syncwarp();

  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int f = 0; f < frames; ++f) {
    int32_t d = 0;
    const bool sent = encode(hcur, hhat, -1, d);
    const unsigned m = __ballot_sync(0xffffffffu, sent);
    if (sent) {
      lh[__popc(m & lanes_below)] = make_int2(d, (kXRows + lane) * kPitch);
    }
    if (lane == 0) cnt[1] = min(__popc(m), rows_h);
    __syncwarp();
    uint32_t px[kCols] = {0u, 0u, 0u, 0u}, ph[kCols] = {0u, 0u, 0u, 0u};
    row_sums(px, lx, cnt[0], s, w + col_off);
    row_sums(ph, lh, cnt[1], s, w + col_off);
    row_sums(ph, lh + 32, cnt[2], s, w + col_off);
    mx = accumulate(mx, reduce_scatter(px, s), shift_x, lim);
    mh = accumulate(mh, reduce_scatter(ph, s), shift_h, lim);
    mxs[lane] = mx;
    mhs[lane] = mh;
    __syncwarp();
    const int u = (lane + 1) & 31, c = (lane + 2) & 31;
    hcur = gates(mxs[lane], mhs[lane], mxs[u], mhs[u], mxs[c], mhs[c], hcur,
                 gc);
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
// rows and rows_h (<= 64) h rows transmitted per frame and the given
// formats, synchronously; out[0] = cycles, out[1] = nanoseconds.  Returns
// the launch's or the copy's error, or cudaErrorInvalidValue for row
// counts out of range.
extern "C" int delta_gru_seq_int_chain(int frames, int rows_x, int rows_h,
                                       int shift_x, int shift_h,
                                       int acc_bits, int acc_frac,
                                       int hid_frac, long long* out) {
  if (rows_x < 0 || rows_x > kXRows || rows_h < 0 || rows_h > kHRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* d = nullptr;
  int32_t* sink = nullptr;
  cudaError_t err = cudaMalloc(&d, 2 * sizeof(long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(&sink, 32 * sizeof(int32_t));
  if (err == cudaSuccess) {
    chain_kernel<<<1, 32>>>(frames, rows_x, rows_h, shift_x, shift_h,
                            acc_bits, acc_frac, hid_frac, d, sink);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    err = cudaMemcpy(out, d, 2 * sizeof(long long), cudaMemcpyDeviceToHost);
  }
  cudaFree(sink);
  cudaFree(d);
  return static_cast<int>(err);
}
