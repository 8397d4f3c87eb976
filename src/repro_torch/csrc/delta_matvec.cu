// Block-sparse delta matvec for Hopper (sm_90a): out = m + Δx·W.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/delta_matvec.py::delta_matvec (pallas_call :73,
//   body _kernel :32; block mask make_block_mask :81).
//
// What it computes.  For a batch of delta vectors Δx (B, I), float32 or
// bfloat16, weights W (I, O) of the same type and a float32 accumulator
// m (B, O): out = m + Σ over the active input blocks of Δx_blk · W_blk.
// The I inputs fall into blocks of block_i; block_mask (one int32 per
// block) marks the blocks with any non-zero delta.  A masked-off block
// adds nothing, even where its deltas are non-zero, and its weight rows
// are never read.  Per active block the partial product is summed from 0
// in ascending input order and then added to the output, the order of
// the TPU kernel's `out += dot(dx_blk, w_blk)`; with one active block
// that is also delta_gru_seq's order, so the ΔGRU's block-sparse fallback
// reproduces the sequence kernel bit for bit at the model's width.
//
// What bounds it on this card.  At the ΔGRU fallback's shapes (B = 256,
// O = 768) the accumulator in and out (0.8 MB each) bound it at I = 10
// (0.5 µs).  At I = 256 the arithmetic does: the numerics contract above
// needs each product rounded before its add, so the build's --fmad=false
// turns every multiply-add into an FMUL and an FADD, 2·B·I·O = 1e8
// instructions, and the card issues 132 SMs × 128 lanes of them per clock:
// ≈ 3.0 µs at 1.98 GHz (twice the 1.5 µs that 67 TFLOP/s of FFMA gives).
// No split-K, TF32 or tensor-core MMA: each changes the order of the sum.
//
// What the design does about it.
//   * Register micro-tile: each thread owns 3 rows × 4 columns of the
//     output.  Per group of four inputs it reads one 16-byte vector of
//     deltas per row and one of weights per input from shared memory and
//     issues 48 FMULs and 48 FADDs.
//   * Fill the card: a CTA covers 12 rows × 64 columns with 64 threads, so
//     B = 256, O = 768 is 22 × 12 = 264 CTAs, 528 warps: one per SM
//     sub-partition of the 132 SMs.  (16-row tiles of 4 × 4 left 27 % of
//     the sub-partitions idle; 8-row tiles of 2 × 4 doubled the
//     shared-memory loads per product.  Both measured slower.)
//   * Weight pipeline: slices of kTileK input rows of W (32 × 64) and of
//     Δx (12 × 32) go through a kStages-deep ring in shared memory.  Where
//     the tensors allow it (float32, I and O multiples of 4, block_i a
//     multiple of kTileK, 16-byte aligned) one thread issues the slice as
//     two TMA tile copies (cp.async.bulk.tensor) completing on the stage's
//     mbarrier; the copies of the next two slices are in flight while the
//     current one is summed.  Otherwise cp.async (W in 16-byte chunks, Δx
//     in words) or, for bfloat16 and unaligned rows, plain loads that widen
//     to float32 fill the same ring.  Issuing per-thread cp.async for both
//     tiles took a large share of every warp's time; TMA takes it off the
//     warps.  Where TMA cannot serve (block_i = 10: 40-byte Δx rows),
//     cp.async still halves the time of plain loads (chip_smoke.py times
//     both).
//   * The ring runs over the active blocks' slices only: an inactive block
//     issues no copy and no arithmetic.  The mask is read by every CTA
//     from device memory (no host sync); the branch on it is uniform.
//
// Numerics.  Built with --fmad=false: every product rounds before its
// add.  bfloat16 operands are widened to float32 exactly.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileB = 12;    // batch rows per CTA
constexpr int kTileO = 64;    // output columns per CTA
constexpr int kTileK = 32;    // input rows per pipeline stage
constexpr int kStages = 3;    // slices in flight
constexpr int kMicroB = 3;    // a thread's rows
constexpr int kMicroO = 4;    // a thread's columns
constexpr int kColGroups = kTileO / kMicroO;                 // 16
constexpr int kThreads = (kTileB / kMicroB) * kColGroups;    // 64
constexpr int kSliceBytes = (kTileK * kTileO + kTileB * kTileK) * 4;

// How the slices reach shared memory (the wrapper's launch plan picks it).
enum Copy : int {
  kPlain = 0,   // loads through registers (bfloat16, unaligned float32)
  kCpAsync = 1, // cp.async: W in 16-byte chunks, Δx in 4-byte words
  kTma = 2,     // one thread, two cp.async.bulk.tensor per slice
};

struct __align__(128) Smem {
  float w[kStages][kTileK][kTileO];    // weight slice, row-major
  float dx[kStages][kTileB][kTileK];   // delta slice, row-major
  unsigned long long full[kStages];    // TMA completion, one per stage
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (4 or 16); with `pred` false it writes zeros and
// reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool pred) {
  const int n = pred ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_wait(const unsigned long long* bar,
                                          uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The ring walks the active blocks' slices in ascending input order.
struct Slice {
  int blk;   // == n_blocks when the walk is over
  int k0;    // first input row of the slice
};

__device__ __forceinline__ int next_active(const int* __restrict__ mask,
                                           int blk, int n_blocks) {
  while (blk < n_blocks && __ldg(mask + blk) == 0) ++blk;
  return blk;
}

__device__ __forceinline__ Slice advance(Slice s, const int* mask,
                                         int n_blocks, int block_i) {
  s.k0 += kTileK;
  if (s.k0 >= (s.blk + 1) * block_i) {
    s.blk = next_active(mask, s.blk + 1, n_blocks);
    s.k0 = s.blk * block_i;
  }
  return s;
}

// Fill stage `st` with rows k0 .. k0 + kn of the slice: W's rows × the
// CTA's 64 columns and Δx's 16 rows × those inputs.  Rows past B and
// columns past O arrive as zeros.
template <typename T, int kCopy>
__device__ __forceinline__ void load_slice(
    Smem& s, int st, int k0, int kn, const T* __restrict__ dx,
    const T* __restrict__ w, const CUtensorMap* tw, const CUtensorMap* tx,
    int B, int I, int O, int b0, int o0) {
  const int t = threadIdx.x;
  if constexpr (kCopy == kTma) {       // every slice is full here
    if (t == 0) {
      const uint32_t bar = smem_addr(&s.full[st]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(kSliceBytes) : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
          ::"r"(smem_addr(&s.w[st][0][0])),
            "l"(reinterpret_cast<uint64_t>(tw)), "r"(bar), "r"(o0), "r"(k0)
          : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
          ::"r"(smem_addr(&s.dx[st][0][0])),
            "l"(reinterpret_cast<uint64_t>(tx)), "r"(bar), "r"(k0), "r"(b0)
          : "memory");
    }
  } else if constexpr (kCopy == kCpAsync) {   // float32, O % 4 == 0
    const int c = (t % kColGroups) * 4;
    const bool col_in = o0 + c < O;
    const float* wp = reinterpret_cast<const float*>(w) +
                      static_cast<size_t>(k0) * O + (col_in ? o0 + c : 0);
#pragma unroll
    for (int kk = t / kColGroups; kk < kTileK; kk += kThreads / kColGroups) {
      if (kk < kn) {
        cp_async<16>(smem_addr(&s.w[st][kk][c]),
                     wp + static_cast<size_t>(kk) * O, col_in);
      }
    }
    const float* xp = reinterpret_cast<const float*>(dx) + k0;
#pragma unroll
    for (int e = t; e < kTileB * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      if (kk < kn) {
        const bool in = b0 + r < B;
        cp_async<4>(smem_addr(&s.dx[st][r][kk]),
                    xp + static_cast<size_t>(in ? b0 + r : 0) * I + kk, in);
      }
    }
  } else {
    for (int e = t; e < kTileK * kTileO; e += kThreads) {
      const int kk = e / kTileO, c = e % kTileO;
      if (kk < kn) {
        s.w[st][kk][c] =
            o0 + c < O
                ? to_float(w[static_cast<size_t>(k0 + kk) * O + o0 + c])
                : 0.0f;
      }
    }
    for (int e = t; e < kTileB * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      if (kk < kn) {
        s.dx[st][r][kk] =
            b0 + r < B
                ? to_float(dx[static_cast<size_t>(b0 + r) * I + k0 + kk])
                : 0.0f;
      }
    }
  }
}

// acc[r][c] += Δx[row r][k] · W[k][col c] for the four inputs k .. k + 3,
// in ascending k, each product rounded before its add (--fmad=false):
// one 16-byte vector of deltas per row, one of weights per input.
__device__ __forceinline__ void mac4(const Smem& s, int st, int k, int tx,
                                     int ty,
                                     float (&acc)[kMicroB][kMicroO]) {
  float d[kMicroB][4];
#pragma unroll
  for (int r = 0; r < kMicroB; ++r) {
    const float4 v =
        *reinterpret_cast<const float4*>(&s.dx[st][ty * kMicroB + r][k]);
    d[r][0] = v.x, d[r][1] = v.y, d[r][2] = v.z, d[r][3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 wv =
        *reinterpret_cast<const float4*>(&s.w[st][k + j][tx * kMicroO]);
    const float v[kMicroO] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int r = 0; r < kMicroB; ++r) {
#pragma unroll
      for (int c = 0; c < kMicroO; ++c) acc[r][c] += d[r][j] * v[c];
    }
  }
}

// The same over the slice's first kn inputs.
__device__ __forceinline__ void mac(const Smem& s, int st, int kn, int tx,
                                    int ty, float (&acc)[kMicroB][kMicroO]) {
  if (kn == kTileK) {
#pragma unroll
    for (int k = 0; k < kTileK; k += 4) mac4(s, st, k, tx, ty, acc);
    return;
  }
  const int full = kn & ~3;
  for (int k = 0; k < full; k += 4) mac4(s, st, k, tx, ty, acc);
  for (int k = full; k < kn; ++k) {
    const float4 wv =
        *reinterpret_cast<const float4*>(&s.w[st][k][tx * kMicroO]);
    const float v[kMicroO] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int r = 0; r < kMicroB; ++r) {
      const float d = s.dx[st][ty * kMicroB + r][k];
#pragma unroll
      for (int c = 0; c < kMicroO; ++c) acc[r][c] += d * v[c];
    }
  }
}

template <typename T, int kCopy>
__global__ void __launch_bounds__(kThreads) delta_matvec_kernel(
    const T* __restrict__ dx, const T* __restrict__ w,
    const float* __restrict__ m, const int* __restrict__ mask,
    float* __restrict__ out, int B, int I, int O, int block_i, int vec,
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx) {
  __shared__ Smem s;
  const int tx_ = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const int b0 = blockIdx.y * kTileB, o0 = blockIdx.x * kTileO;
  const int n_blocks = I / block_i;
  if (kCopy == kTma && threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&s.full[st])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kCopy == kTma) __syncthreads();

  // Prologue: put the first kStages - 1 slices in flight.
  const int first = next_active(mask, 0, n_blocks);
  Slice ld{first, first * block_i};
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ld.blk < n_blocks) {
      load_slice<T, kCopy>(s, st, ld.k0,
                           min(kTileK, (ld.blk + 1) * block_i - ld.k0), dx,
                           w, &tw, &tx, B, I, O, b0, o0);
      ld = advance(ld, mask, n_blocks, block_i);
    }
    cp_async_commit();
  }

  // The accumulator tile, read while the first slices arrive.
  const int row0 = b0 + ty * kMicroB, col0 = o0 + tx_ * kMicroO;
  float res[kMicroB][kMicroO], acc[kMicroB][kMicroO];
#pragma unroll
  for (int r = 0; r < kMicroB; ++r) {
    const bool row_in = row0 + r < B;
    const float* mr = m + static_cast<size_t>(row_in ? row0 + r : 0) * O;
    if (vec && row_in && col0 + kMicroO <= O) {
      const float4 v = *reinterpret_cast<const float4*>(mr + col0);
      res[r][0] = v.x, res[r][1] = v.y, res[r][2] = v.z, res[r][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kMicroO; ++c)
        res[r][c] = row_in && col0 + c < O ? mr[col0 + c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kMicroO; ++c) acc[r][c] = 0.0f;
  }

  Slice cur{first, first * block_i};
  for (int it = 0; cur.blk < n_blocks; ++it) {
    const int st = it % kStages;
    if (kCopy != kTma) cp_async_wait<kStages - 2>();
    __syncthreads();   // stage st - 1 is free again (and, without TMA, st
                       // is full)
    if (ld.blk < n_blocks) {
      load_slice<T, kCopy>(s, (st + kStages - 1) % kStages, ld.k0,
                           min(kTileK, (ld.blk + 1) * block_i - ld.k0), dx,
                           w, &tw, &tx, B, I, O, b0, o0);
      ld = advance(ld, mask, n_blocks, block_i);
    }
    cp_async_commit();
    if (kCopy == kTma) mbar_wait(&s.full[st], (it / kStages) & 1);

    mac(s, st, min(kTileK, (cur.blk + 1) * block_i - cur.k0), tx_, ty, acc);
    const Slice nx = advance(cur, mask, n_blocks, block_i);
    if (nx.blk != cur.blk) {   // the block's sum is done: out += dot
#pragma unroll
      for (int r = 0; r < kMicroB; ++r) {
#pragma unroll
        for (int c = 0; c < kMicroO; ++c) {
          res[r][c] = res[r][c] + acc[r][c];
          acc[r][c] = 0.0f;
        }
      }
    }
    cur = nx;
  }

#pragma unroll
  for (int r = 0; r < kMicroB; ++r) {
    if (row0 + r >= B) continue;
    float* orow = out + static_cast<size_t>(row0 + r) * O + col0;
    if (vec && col0 + kMicroO <= O) {
      *reinterpret_cast<float4*>(orow) =
          make_float4(res[r][0], res[r][1], res[r][2], res[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kMicroO; ++c)
        if (col0 + c < O) orow[c] = res[r][c];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, cols) float32 matrix cut into (box_rows, box_cols)
// tiles; out-of-range elements arrive as zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dx (B, I) and w (I, O): float32, or bfloat16 when is_bf16; m, out
// (B, O) float32; mask (I / block_i) int32.  All contiguous on the
// current device; I a multiple of block_i.  The launch follows the
// wrapper's plan (kernels/delta_matvec.py::matvec_launch_plan): a
// grid_x × grid_y grid of `threads`-thread CTAs whose static shared
// memory is smem_bytes, slices copied by TMA (copy = 2), cp.async (1) or
// plain loads (0).  Launches on `stream` and returns the launch's error,
// or cudaErrorInvalidValue for a plan this kernel cannot run (a grid
// that misses outputs, another CTA size or shared-memory size, a copy
// path the tensors do not allow) or a tensor map that cannot be made.
extern "C" int delta_matvec_launch(const void* dx, const void* w,
                                   const float* m, const int* mask,
                                   float* out, int B, int I, int O,
                                   int block_i, int is_bf16, int grid_x,
                                   int grid_y, int threads, int copy,
                                   int smem_bytes, void* stream) {
  const bool f32 = !is_bf16 && O % 4 == 0 && aligned16(w);
  const bool copy_ok =
      copy == kPlain || (copy == kCpAsync && f32) ||
      (copy == kTma && f32 && block_i % kTileK == 0);
  if (static_cast<long long>(grid_x) * kTileO < O ||
      static_cast<long long>(grid_y) * kTileB < B || threads != kThreads ||
      smem_bytes != static_cast<int>(sizeof(Smem)) || !copy_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  const int vec = (O % 4 == 0 && aligned16(m) && aligned16(out)) ? 1 : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap tw{}, tx{};
  if (is_bf16) {
    const auto* d = static_cast<const __nv_bfloat16*>(dx);
    const auto* v = static_cast<const __nv_bfloat16*>(w);
    delta_matvec_kernel<__nv_bfloat16, kPlain><<<grid, kThreads, 0, s>>>(
        d, v, m, mask, out, B, I, O, block_i, vec, tw, tx);
    return static_cast<int>(cudaGetLastError());
  }
  const auto* d = static_cast<const float*>(dx);
  const auto* v = static_cast<const float*>(w);
  if (copy == kTma) {
    if (!make_map(&tw, w, I, O, kTileK, kTileO) ||
        !make_map(&tx, dx, B, I, kTileB, kTileK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    delta_matvec_kernel<float, kTma><<<grid, kThreads, 0, s>>>(
        d, v, m, mask, out, B, I, O, block_i, vec, tw, tx);
  } else if (copy == kCpAsync) {
    delta_matvec_kernel<float, kCpAsync><<<grid, kThreads, 0, s>>>(
        d, v, m, mask, out, B, I, O, block_i, vec, tw, tx);
  } else {
    delta_matvec_kernel<float, kPlain><<<grid, kThreads, 0, s>>>(
        d, v, m, mask, out, B, I, O, block_i, vec, tw, tx);
  }
  return static_cast<int>(cudaGetLastError());
}
