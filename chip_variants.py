#!/usr/bin/env python3
"""Time variants of the FEx, ΔGRU, ΔGRU cell and detection head kernels.

    python3 chip_variants.py

Each variant is the committed kernel source (``src/repro_torch/csrc``)
with a few textual replacements, listed below with what they change:
design alternatives, which must give the committed kernel's outputs bit
for bit, and ablations, which drop one stage's work to show what that
stage costs (their outputs are wrong by construction and only timed).
A variant that changes the kernel's shared-memory layout also names the
wrapper constants its launch plan needs, set while it runs, or patches
the kernel's C launch function to add the bytes it needs.
Every variant is built with the repository's nvcc flags, swapped in for
the committed library behind the same wrapper, and timed on the device
(20 calls in a CUDA graph, the median of 20 replays, as in
``chip_smoke.py``) in the order committed, variants, variants reversed,
committed, at the serving shapes: the float FEx on B = 32 and 256 streams
of a 4096-sample chunk, both ΔGRU kernels on 32 frames of B = 32 and 256
streams at Δ_TH 0.1, the ΔGRU cell on one frame of B = 32 and 256 streams
halfway through a chunk, the detection head on 32 frames of B = 32 and
256 slots of 12 classes.  Then each kernel but the cell and the head
once more with
clock64() stamps: in the FEx each warp's cycles and those it waits at
barriers and for its copies, in each ΔGRU thread 0's cycles in each step
of the frame (the stamps themselves add a little).  Prints one line per timing
and a JSON summary as the last line.  Needs one CUDA GPU and nvcc; exits
2 without a GPU.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# ------------------------------------------------------- FEx variants --
_FEED_LOOP = """        float* dst = &sm.x[slot][lane][0];
        if (t >= kXStages) bar_sync(x_empty(slot));
        if (a.x_vec) {
          for (int v = 0; v < n; v += 4) cp_async16(dst + v, xb + k0 + v);
        } else {
          for (int k = 0; k < n; ++k) cp_async4(dst + k, xb + k0 + k);
        }"""
_FEED_PER_STREAM = """        if (t >= kXStages) bar_sync(x_empty(slot));
        const int b_first = (blockIdx.x * kLanes) / C;
        const int ns = min(a.B - 1, (blockIdx.x * kLanes + kLanes - 1) / C)
                       - b_first + 1;
        const int per = a.x_vec ? (n + 3) / 4 : n, w = a.x_vec ? 4 : 1;
        for (int i = lane; i < ns * per; i += kLanes) {
          const int r = i / per, v = (i - r * per) * w;
          const float* src = a.x + static_cast<size_t>(b_first + r) * a.T
                             + k0 + v;
          if (a.x_vec) cp_async16(&sm.x[slot][r][v], src);
          else cp_async4(&sm.x[slot][r][v], src);
        }"""
_SEC0_LOOP = """    for (int t = 0; t < n_tiles; ++t) {
      const int xslot = t % kXStages, slot = t % kStages;"""
_SEC0_OWN_COPIES = """    const float* xb = a.x + static_cast<size_t>(b) * a.T;
    const auto issue = [&](int t) {
      if (t < n_tiles) {
        const int k0 = t * kTile, n = min(kTile, S - k0);
        float* dst = &sm.x[t % kXStages][lane][0];
        if (a.x_vec) {
          for (int v = 0; v < n; v += 4) cp_async16(dst + v, xb + k0 + v);
        } else {
          for (int k = 0; k < n; ++k) cp_async4(dst + k, xb + k0 + k);
        }
      }
      cp_async_commit();
    };
    issue(0);
    issue(1);
    for (int t = 0; t < n_tiles; ++t) {
      const int xslot = t % kXStages, slot = t % kStages;
      issue(t + 2);
      cp_async_wait<2>();"""
_ENV_RUN = """        tile_loop<kU>(
            in,
            [&](float4 v, int) {
              step(v.x);
              step(v.y);
              step(v.z);
              step(v.w);
            },
            [&](float v, int) { step(v); });"""
_SECTION4 = """  const float y0 = sec(v.x);         // one statement each: the steps are
  const float y1 = sec(v.y);         // sequential in the state
  const float y2 = sec(v.z);
  const float y3 = sec(v.w);
  *reinterpret_cast<float4*>(out) = make_float4(y0, y1, y2, y3);"""


def _no_feed_warp(src: str) -> str:
    """Warp 0 idles; section 0 copies its own audio, two tiles ahead."""
    start = src.index("  if (warp == 0) {")
    end = src.index("  } else if (warp == 1) {")
    src = src[:start] + "  if (warp == 0) {\n" + src[end:]
    src = src.replace(_SEC0_LOOP, _SEC0_OWN_COPIES)
    src = src.replace("      bar_sync(x_full(xslot));\n", "")
    return src.replace(
        "      if (t + kXStages < n_tiles) bar_arrive(x_empty(xslot));\n", "")


def _fex_consts(tile: int, ahead: int):
    """Tiles of `tile` samples with `ahead` audio tiles in flight (at most
    kXStages - 1 = 3: the feed must not wait for a slot whose tile it has
    not yet published)."""
    return lambda s: s.replace(
        "constexpr int kTile = 64;", f"constexpr int kTile = {tile};").replace(
        "constexpr int kXAhead = 2;", f"constexpr int kXAhead = {ahead};")


# clock64() in lane 0 of each warp, summed over the CTAs in g_fex: [0]
# the warp's whole run, [1] its time in bar.sync, [2] in cp.async.wait_group.
FEX_ROLES = ("feed", "section 0", "section 1", "envelope")
_FEX_STAMPS = (
    ("__device__ __forceinline__ void bar_sync(int id) {\n"
     '  asm volatile("bar.sync %0, 64;\\n" ::"r"(id) : "memory");\n}\n',
     "__device__ unsigned long long g_fex[3][4];\n"
     "__device__ __forceinline__ void stamp(int k, long long c0) {\n"
     "  if ((threadIdx.x & 31) == 0) {\n"
     "    atomicAdd(&g_fex[k][threadIdx.x / 32],\n"
     "              static_cast<unsigned long long>(clock64() - c0));\n"
     "  }\n}\n"
     "__device__ __forceinline__ void bar_sync(int id) {\n"
     "  const long long c0 = clock64();\n"
     '  asm volatile("bar.sync %0, 64;\\n" ::"r"(id) : "memory");\n'
     "  stamp(1, c0);\n}\n"),
    ('  asm volatile("cp.async.wait_group %0;\\n" ::"n"(kPending) : '
     '"memory");\n',
     "  const long long c0 = clock64();\n"
     '  asm volatile("cp.async.wait_group %0;\\n" ::"n"(kPending) : '
     '"memory");\n  stamp(2, c0);\n'),
    ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
     "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
     "  const long long k_start = clock64();\n"),
    ("    if (active) st_out[4 * C] = env;\n  }\n}\n",
     "    if (active) st_out[4 * C] = env;\n  }\n  stamp(0, k_start);\n}\n"),
)
_READ_FEX = """
extern "C" int read_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_fex, sizeof(g_fex));
  if (e != cudaSuccess) return static_cast<int>(e);
  static const unsigned long long zero[12] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_fex, zero, sizeof(zero)));
}
"""


def _fex_stamps(src: str) -> str:
    for old, new in _FEX_STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"FEx stamps: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + _READ_FEX


_RUN_TILE = """  float4 a0 = v[0], a1 = v[1];
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
  }"""
_RUN_TILE_16_AHEAD = """  float4 a0 = v[0], a1 = v[1], a2 = v[2], a3 = v[3];
#pragma unroll
  for (int g = 0; g < kTile; g += 32) {
    const float4 b0 = v[g / 4 + 4], b1 = v[g / 4 + 5], b2 = v[g / 4 + 6],
                 b3 = v[g / 4 + 7];
    fn(a0, g);
    fn(a1, g + 4);
    fn(a2, g + 8);
    fn(a3, g + 12);
    if (g + 32 < kTile) {
      a0 = v[g / 4 + 8];
      a1 = v[g / 4 + 9];
      a2 = v[g / 4 + 10];
      a3 = v[g / 4 + 11];
    }
    fn(b0, g + 16);
    fn(b1, g + 20);
    fn(b2, g + 24);
    fn(b3, g + 28);
  }"""
_FEED_COPIES = """        if (a.x_vec) {
          for (int v = 0; v < n; v += 4) cp_async16(dst + v, xb + k0 + v);
        } else {
          for (int k = 0; k < n; ++k) cp_async4(dst + k, xb + k0 + k);
        }"""


def _ahead16(src: str) -> str:
    """Ring rows read 16 samples before their use (32-sample iterations)
    instead of 8."""
    return src.replace(_RUN_TILE, _RUN_TILE_16_AHEAD)


_MERGED = """  } else {                         // @WHAT and the envelope
@SETUP
    float env = st_in[4 * C];
    float* fb = a.feats + static_cast<size_t>(b) * a.n_frames * C + c;
    int f = 0, to_boundary = a.frame_shift;
    const auto step = [&](float v) {
      env = fex::envelope_step(env, @CHAIN, a.one_minus_alpha, a.env_alpha);
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
      const int slot = t % @SLOTS;
      const int n = min(kTile, S - t * kTile);
      const float* in = &sm.@RING[slot][lane][0];
      bar_sync(@FULL(slot));
      if (n == kTile && to_boundary >= kTile) {   // no frame ends inside
        run_tile(in, [&](float4 v, int) {
          step(v.x);
          step(v.y);
          step(v.z);
          step(v.w);
        });
        to_boundary -= kTile;
        if (to_boundary == 0) emit();
      } else {
        for (int k = 0; k < n; ++k) {
          step(in[k]);
          if (--to_boundary == 0) emit();
        }
      }
      if (t + @SLOTS < n_tiles) bar_arrive(@EMPTY(slot));
    }
    if (active) {
@STORE
      st_out[4 * C] = env;
    }
  }
}
"""


def _section_code(name: str, k: int) -> tuple[str, str]:
    """Set-up and state store of section k (0 or 1) held in `name`."""
    setup = (f"    fex::Section {name};\n"
             f"    {name}.b0 = a.coef[{3 * k} * C + c];\n"
             f"    {name}.na1 = -a.coef[{3 * k + 1} * C + c];\n"
             f"    {name}.nb0 = -{name}.b0;\n"
             f"    {name}.a2 = a.coef[{3 * k + 2} * C + c];\n"
             f"    {name}.r1 = st_in[{2 * k} * C];\n"
             f"    {name}.r2 = st_in[{2 * k + 1} * C];")
    store = (f"      st_out[{2 * k} * C] = {name}.r1;\n"
             f"      st_out[{2 * k + 1} * C] = {name}.r2;")
    return setup, store


def _merged(first: int):
    """One warp runs the sections from section `first` on, and the
    envelope: all three on the audio ring (two warps in all, no y0 / y1
    rings) for first = 0, section 1 and the envelope on the y0 ring
    (three warps, no y1 ring) for first = 1."""
    secs = [_section_code(f"s{k}", k) for k in range(first, 2)]
    fields = {
        "@WHAT": "sections 0 and 1" if first == 0 else "section 1",
        "@SETUP": "\n".join(setup for setup, _ in secs),
        "@STORE": "\n".join(store for _, store in secs),
        "@CHAIN": "s1(s0(v))" if first == 0 else "s1(v)",
        "@SLOTS": "kXStages" if first == 0 else "kStages",
        "@RING": "x" if first == 0 else "y0",
        "@FULL": "x_full" if first == 0 else "y_full(0, ",
        "@EMPTY": "x_empty" if first == 0 else "y_empty(0, "}
    code = _MERGED
    for key, value in fields.items():
        code = code.replace(key, value)
    code = code.replace("y_full(0, (slot)", "y_full(0, slot)").replace(
        "y_empty(0, (slot)", "y_empty(0, slot)")

    def patch(src: str) -> str:
        start = src.index("  } else if (warp == %d) {" % (first + 1))
        end_mark = "    if (active) st_out[4 * C] = env;\n  }\n}\n"
        end = src.index(end_mark) + len(end_mark)
        src = src[:start] + code + src[end:]
        src = src.replace("constexpr int kWarps = 4; ",
                          f"constexpr int kWarps = {first + 2}; ")
        for ring in ("y0", "y1")[first:]:
            line = next(ln for ln in src.splitlines(True)
                        if ln.startswith(f"  float {ring}[kStages]"))
            src = src.replace(line, "")
        return src
    return patch


# name: (must equal the committed kernel bit for bit, source patch[,
# wrapper constants for the launch plan]).
FEX_VARIANTS = {
    "tile loop rolled (16 samples per iteration)": (True, lambda s: s.replace(
        "#pragma unroll\n  for (int g = 0; g < kTile; g += 16) {",
        "#pragma unroll 1\n  for (int g = 0; g < kTile; g += 16) {")),
    "tile loop unrolled by two": (True, lambda s: s.replace(
        "#pragma unroll\n  for (int g = 0; g < kTile; g += 16) {",
        "#pragma unroll 2\n  for (int g = 0; g < kTile; g += 16) {")),
    "section 1 and the envelope in one warp": (
        True, _merged(1), {"FEX_THREADS": 96, "FEX_STAGES": 1}),
    "one warp runs both sections and the envelope": (
        True, _merged(0), {"FEX_THREADS": 64, "FEX_STAGES": 0}),
    "ring loads 16 samples ahead": (True, _ahead16),
    "ring loads 16 samples ahead, tiles of 128": (
        True, lambda s: _ahead16(_fex_consts(128, 2)(s)), {"FEX_TILE": 128}),
    "ablation: feed copies nothing": (
        False, lambda s: s.replace(_FEED_COPIES, "        (void)dst;")),
    "tiles of 128 samples": (True, _fex_consts(128, 2), {"FEX_TILE": 128}),
    "3 audio tiles in flight": (True, _fex_consts(64, 3)),
    "tiles of 128, 3 in flight": (True, _fex_consts(128, 3),
                                  {"FEX_TILE": 128}),
    "feed copies one row per stream": (True, lambda s: s.replace(
        _FEED_LOOP, _FEED_PER_STREAM).replace(
        "const float* in = &sm.x[xslot][lane][0];",
        "const float* in = &sm.x[xslot][b - (blockIdx.x * kLanes) / C][0];")),
    "no feed warp: section 0 copies its audio": (True, _no_feed_warp),
    "ablation: envelope does no per-sample work": (
        False, lambda s: s.replace(_ENV_RUN, "{}")),
    "ablation: sections pass samples through, envelope idle": (
        False, lambda s: s.replace(_ENV_RUN, "{}").replace(
            _SECTION4, "  *reinterpret_cast<float4*>(out) = v;")),
}

# ------------------------------------------------------ ΔGRU variants --
_GATES = """      hcur = gates(mxs[j], mhs[j], mxs[H + j], mhs[H + j], mxs[2 * H + j],
                   mhs[2 * H + j], hcur, gc);"""
_TRIVIAL_GATES = """      hcur = (mxs[j] + mhs[j] + mxs[H + j] + mhs[H + j] + mxs[2 * H + j]
              + mhs[2 * H + j]) >> 12;"""
_ROW_SUMS = """    for (int w = 0; w < L.sx; ++w) {
      row_sums(px, lx + w * 32, cnt[w], s, wx + col_off);
    }
    for (int w = 0; w < L.sh; ++w) {
      row_sums(ph, lh + w * 32, cnt[L.sx + w], s, wh + col_off);
    }"""
_REDUCE = """    const uint32_t sum_x = reduce_scatter(px, s);
    const uint32_t sum_h = reduce_scatter(ph, s);"""


_ATOMIC_COUNTS = (
    "      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dx[row], __popc(m));\n",
    "      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dh[row], __popc(m));\n",
    "  for (int f = j; f < T; f += blockDim.x) {\n"
    "    a.nz_dx[static_cast<size_t>(f) * B + b] = 0;\n"
    "    a.nz_dh[static_cast<size_t>(f) * B + b] = 0;\n"
    "  }\n")
_SUMMED_COUNTS = """    if (COUNTER) {      // the transmit counts
      int nx = 0, nh = 0;
      for (int w = 0; w < L.sx; ++w) nx += cnt[w];
      for (int w = 0; w < L.sh; ++w) nh += cnt[L.sx + w];
      a.nz_dx[row] = nx;
      a.nz_dh[row] = nh;
    }
"""


def _summed_counts(counter: str):
    """The transmit counts summed from the warp counts by one thread after
    the first barrier and stored, instead of added by the encoding warps'
    atomics."""
    def patch(src: str) -> str:
        for line in _ATOMIC_COUNTS:
            if src.count(line) != 1:
                raise SystemExit(f"summed counts: not found once: {line!r}")
            src = src.replace(line, "")
        anchor = "    __syncthreads();\n\n    // 2. Column sums"
        return src.replace(anchor, "    __syncthreads();\n" + _SUMMED_COUNTS
                           .replace("COUNTER", counter) + "\n    // 2. Column sums")
    return patch


_X_LAST = (          # (first warps, last warps)
    ("  const int warp = j >> 5;\n",
     "  const int warp = j >> 5;\n"
     "  const int xwarp = warp - (static_cast<int>(blockDim.x >> 5) - L.sx);\n"
     "  const int xj = xwarp * 32 + lane;   // this thread's x component\n"),
    ("(static_cast<size_t>(t0) * B + b) * I + j;",
     "(static_cast<size_t>(t0) * B + b) * I + xj;"),
    ("      xst[f * I + j] = src[", "      xst[f * I + xj] = src["),
    ("  if (j < I) {\n    xhat = a.xh0[b * I + j];",
     "  if (xwarp >= 0 && xj < I) {\n    xhat = a.xh0[b * I + xj];"),
    ("    if (tf == 0 && t > 0 && j < I) stage_x(t);",
     "    if (tf == 0 && t > 0 && xwarp >= 0 && xj < I) stage_x(t);"),
    ("""    if (warp < L.sx) {
      int32_t d = 0;
      const bool sent = j < I && encode(xst[tf * I + j], xhat, a.th_x, d);
      const unsigned m = __ballot_sync(0xffffffffu, sent);
      if (sent) lx[warp * 32 + __popc(m & lanes_below)] = make_int2(d, j * L.pitch);
      if (lane == 0) cnt[warp] = __popc(m);""",
     """    if (xwarp >= 0) {
      int32_t d = 0;
      const bool sent = xj < I && encode(xst[tf * I + xj], xhat, a.th_x, d);
      const unsigned m = __ballot_sync(0xffffffffu, sent);
      if (sent) lx[xwarp * 32 + __popc(m & lanes_below)] = make_int2(d, xj * L.pitch);
      if (lane == 0) cnt[xwarp] = __popc(m);"""),
    ("  if (j < I) a.xh_out[b * I + j] =",
     "  if (xwarp >= 0 && xj < I) a.xh_out[b * I + xj] ="),
)


def _x_first(src: str) -> str:
    """The x encoders in the CTA's first warps (thread j < I encodes x
    component j), where the h encoders run too, one after the other."""
    for new, old in _X_LAST:
        if src.count(old) != 1:
            raise SystemExit(f"x encoders first: not found once: {old!r}")
        src = src.replace(old, new)
    return src


GRU_VARIANTS = {
    "x encoders in the first warps": (True, _x_first),
    "row sums unrolled by two": (True, lambda s: s.replace(
        "#pragma unroll 1\n  for (int k = s; k < n; k += kSplit) {",
        "#pragma unroll 2\n  for (int k = s; k < n; k += kSplit) {")),
    "thread 0 sums the warp counts": (True, _summed_counts("j == 0")),
    "the last thread sums the warp counts": (
        True, _summed_counts("j == blockDim.x - 1")),
    "ablation: trivial gates": (False, lambda s: s.replace(_GATES,
                                                           _TRIVIAL_GATES)),
    "ablation: no row sums": (False, lambda s: s.replace(
        _ROW_SUMS, "    px[0] = cnt[0];\n    ph[1] = cnt[1];")),
    "ablation: no reduce-scatter": (False, lambda s: s.replace(_REDUCE, (
        "    const uint32_t sum_x = px[s & 3];\n"
        "    const uint32_t sum_h = ph[s & 3];"))),
    "ablation: trivial gates, no row sums": (False, lambda s: s.replace(
        _GATES, _TRIVIAL_GATES).replace(
        _ROW_SUMS, "    px[0] = cnt[0];\n    ph[1] = cnt[1];")),
}


# ---------------------------------------------- float ΔGRU variants --
def _patches(pairs):
    """Apply (old, new) replacements, each of which must match once."""
    def patch(src: str) -> str:
        for old, new in pairs:
            if src.count(old) != 1:
                raise SystemExit(f"patch: not found once: {old!r}")
            src = src.replace(old, new)
        return src
    return patch


_F_SIGMA = """      if (j < H) {
        r = gate_sigmoid(mx, mh);
      } else if (j < 2 * H) {
        mxs[j] = gate_sigmoid(mx, mh);              // u
      } else {
        mxs[j] = mx;
        mhs[j] = mh;
      }"""
_F_BLEND = """      hcur = candidate_blend(r, mxs[H + j], mxs[2 * H + j], mhs[2 * H + j],
                             hcur);"""
_F_SIGMA_LATE = ((_F_SIGMA, "      mxs[j] = mx;\n      mhs[j] = mh;"),
                 (_F_BLEND, """      hcur = candidate_blend(gate_sigmoid(mx, mh),
                             gate_sigmoid(mxs[H + j], mhs[H + j]),
                             mxs[2 * H + j], mhs[2 * H + j], hcur);"""))
_F_TRIVIAL_GATES = (
    ("        r = gate_sigmoid(mx, mh);", "        r = mx + mh;"),
    ("        mxs[j] = gate_sigmoid(mx, mh);              // u",
     "        mxs[j] = mx - mh;"),
    (_F_BLEND, "      hcur = (r + mxs[H + j] + mxs[2 * H + j] - mhs[2 * H + j])"
               " * 0.125f;"))
_F_ROW_SUMS = """      for (int s = 0; s < L.sx; ++s) {
        ax = column_sum(ax, lx + 32 * s, cnt[s], w + j);
      }
      for (int s = 0; s < L.sh; ++s) {
        ah = column_sum(ah, lh + 32 * s, cnt[L.sx + s], w + j);
      }"""
_F_NO_ROW_SUMS = ((_F_ROW_SUMS, """      ax = static_cast<float>(cnt[0]);
      ah = static_cast<float>(cnt[L.sx]);"""),)
_F_X_AHEAD = """    float xv = xnext;
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
"""
_F_X_GLOBAL = ((_F_X_AHEAD,
                "    const float xv = x_enc ? a.xs[row * I + xj] : 0.0f;\n"),)
# The int twin's way: each x encoder stages its component for blocks of 32
# frames in shared memory (all loads of a block issued before its first
# store), the first block in the prologue.  The tree keeps this design as
# its staged instance (the block_t knob): the variant launches it with 32
# frames where the wrapper asks for the default.
_F_X_STAGED = ((
    "  const bool staged = x_frames >= 2;\n",
    "  if (awake == nullptr && x_frames == 0 && T >= 2) {\n"
    "    x_frames = T < 32 ? T : 32;\n"
    "    smem_bytes += static_cast<int>(round16(4 * static_cast<size_t>("
    "x_frames) * I));\n"
    "  }\n"
    "  const bool staged = x_frames >= 2;\n"),)
# Rows summed in predicated batches of `k` (the cell's loop): the batch's
# entries and weights all load before its first add, with no remainder
# loop for the last few rows.
_F_COLUMN_SUM = """#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const Row e = list[k];
    acc = acc + e.d * w[e.off];
  }
  return acc;"""


def _f_batched(k: int):
    return _patches(((_F_COLUMN_SUM, f"""  for (int k0 = 0; k0 < n; k0 += {k}) {{
    float d[{k}], v[{k}];
#pragma unroll
    for (int u = 0; u < {k}; ++u) {{
      if (k0 + u < n) {{
        const Row e = list[k0 + u];
        d[u] = e.d;
        v[u] = w[e.off];
      }}
    }}
#pragma unroll
    for (int u = 0; u < {k}; ++u) {{
      if (k0 + u < n) acc = acc + d[u] * v[u];
    }}
  }}
  return acc;"""),))


_F_PLAIN_WEIGHTS = (("  if (vec) {\n    const int n = rows * N / 4;",
                     "  if (false) {\n    const int n = rows * N / 4;"),
                    ("      cp_async4(dst + r * pitch + (k - r * N), src + k);",
                     "      dst[r * pitch + (k - r * N)] = src[k];"))
# Rows as each warp's ballot mask over its dense deltas: a set bit's delta
# and weight both load from its index, one shared round trip per row
# instead of an entry and then the weight it points at.
_MASK_SUM = """
__device__ __forceinline__ float mask_sum(float acc, unsigned m,
                                          const float* d, const float* w,
                                          int pitch) {
  while (m != 0u) {
    const int u0 = __ffs(m) - 1;
    m &= m - 1u;
    const float p0 = d[u0] * w[u0 * pitch];
    if (m == 0u) {
      acc = acc + p0;
      break;
    }
    const int u1 = __ffs(m) - 1;
    m &= m - 1u;
    const float p1 = d[u1] * w[u1 * pitch];
    acc = acc + p0;
    acc = acc + p1;
  }
  return acc;
}

template <bool kMasked, bool kStaged>
__global__ void delta_gru_seq_kernel(Args a) {"""
_F_MASKS = (
    ("\ntemplate <bool kMasked, bool kStaged>\n"
     "__global__ void delta_gru_seq_kernel(Args a) {", _MASK_SUM),
    ("""      const int n = compact(sent, d, xj * L.pitch, lx, 32 * xwarp);
      if (lane == 0) cnt[xwarp] = n;
      if (lane == 0 && n != 0) atomicAdd(&a.nz_dx[row], n);""",
     """      const unsigned m = __ballot_sync(0xffffffffu, sent);
      reinterpret_cast<float*>(lx)[32 * xwarp + lane] = d;
      if (lane == 0) cnt[xwarp] = static_cast<int>(m);
      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dx[row], __popc(m));"""),
    ("""      const int n = compact(sent, d, (I + j) * L.pitch, lh, 32 * warp);
      if (lane == 0) cnt[L.sx + warp] = n;
      if (lane == 0 && n != 0) atomicAdd(&a.nz_dh[row], n);""",
     """      const unsigned m = __ballot_sync(0xffffffffu, sent);
      reinterpret_cast<float*>(lh)[32 * warp + lane] = d;
      if (lane == 0) cnt[L.sx + warp] = static_cast<int>(m);
      if (lane == 0 && m != 0u) atomicAdd(&a.nz_dh[row], __popc(m));"""),
    (_F_ROW_SUMS, """      for (int s = 0; s < L.sx; ++s) {
        ax = mask_sum(ax, static_cast<unsigned>(cnt[s]),
                      reinterpret_cast<const float*>(lx) + 32 * s,
                      w + 32 * s * L.pitch + j, L.pitch);
      }
      for (int s = 0; s < L.sh; ++s) {
        ah = mask_sum(ah, static_cast<unsigned>(cnt[L.sx + s]),
                      reinterpret_cast<const float*>(lh) + 32 * s,
                      w + (I + 32 * s) * L.pitch + j, L.pitch);
      }"""))
_F_UNROLL = "#pragma unroll 2\n  for (int k = 0; k < n; ++k) {"
_F_NO_ATOMICS = (
    ("      if (lane == 0 && n != 0) atomicAdd(&a.nz_dx[row], n);\n", ""),
    ("      if (lane == 0 && n != 0) atomicAdd(&a.nz_dh[row], n);\n", ""))
F_GRU_VARIANTS = {
    "row sums rolled": (True, _patches(((
        _F_UNROLL, _F_UNROLL.replace("unroll 2", "unroll 1")),))),
    "row sums unrolled by four": (True, _patches(((
        _F_UNROLL, _F_UNROLL.replace("unroll 2", "unroll 4")),))),
    "rows as per-warp ballot masks over dense deltas": (
        True, _patches(_F_MASKS)),
    "σ(r), σ(u) after barrier 2, in the gate threads": (
        True, _patches(_F_SIGMA_LATE)),
    "x encoders in the first warps": (True, _patches(((
        "  const int xwarp = warp - (static_cast<int>(blockDim.x >> 5) - L.sx);",
        "  const int xwarp = warp < L.sx ? warp : -1;"),))),
    "weights staged by plain loads (no cp.async)": (
        True, _patches(_F_PLAIN_WEIGHTS)),
    "x read from global memory each frame": (True, _patches(_F_X_GLOBAL)),
    "x staged for 32 frames in the prologue (the design before)": (
        True, _patches(_F_X_STAGED)),
    "row sums in predicated batches of 4": (True, _f_batched(4)),
    "row sums in predicated batches of 8": (True, _f_batched(8)),
    "counts summed by the last thread after its column sums": (
        True, _patches(_F_NO_ATOMICS + (
            ("  for (int f = j; f < T; f += blockDim.x) {\n"
             "    a.nz_dx[static_cast<size_t>(f) * B + b] = 0;\n"
             "    a.nz_dh[static_cast<size_t>(f) * B + b] = 0;\n  }\n", ""),
            ("    __syncthreads();\n\n    // 3. The candidate",
             "    if (j == blockDim.x - 1) {\n"
             "      int nx = 0, nh = 0;\n"
             "      for (int s = 0; s < L.sx; ++s) nx += cnt[s];\n"
             "      for (int s = 0; s < L.sh; ++s) nh += cnt[L.sx + s];\n"
             "      a.nz_dx[row] = nx;\n      a.nz_dh[row] = nh;\n    }\n"
             "    __syncthreads();\n\n    // 3. The candidate")))),
    "ablation: no transmit counts": (False, _patches(_F_NO_ATOMICS)),
    "ablation: trivial gates": (False, _patches(_F_TRIVIAL_GATES)),
    "ablation: no row sums": (False, _patches(_F_NO_ROW_SUMS)),
    "ablation: neither gates nor row sums": (
        False, _patches(_F_TRIVIAL_GATES + _F_NO_ROW_SUMS)),
}

# ---------------------------------------------------- cell variants --
_CELL_SUMS = """    for (int s = 0; s < L.sx; ++s) {
      ax = segment_sum(ax, lx + 32 * s, cnt[s], a.wx + j);
    }
    for (int s = 0; s < L.sh; ++s) {
      ah = segment_sum(ah, lh + 32 * s, cnt[L.sx + s], a.wh + j);
    }"""
# The design before: every thread helps stage the transmitted rows into a
# shared tile (slot 32s + k for entry k of segment s), then after a
# barrier thread j sums column j from the tile in the same order.
_CELL_TILE = """  float* tile = reinterpret_cast<float*>(smem + L.total);
  for (int s = 0; s < L.sx + L.sh; ++s) {
    const Row* list = s < L.sx ? lx + 32 * s : lh + 32 * (s - L.sx);
    const float* wg = s < L.sx ? a.wx : a.wh;
    for (int e = j; e < cnt[s] * N; e += blockDim.x) {
      const int k = e / N;
      tile[(32 * s + k) * N + (e - k * N)] = wg[list[k].off + (e - k * N)];
    }
  }
  __syncthreads();
  if (j < N) {
    float ax = 0.0f, ah = 0.0f;
    for (int s = 0; s < L.sx + L.sh; ++s) {
      float acc = s < L.sx ? ax : ah;
      const Row* list = s < L.sx ? lx + 32 * s : lh + 32 * (s - L.sx);
      for (int k = 0; k < cnt[s]; ++k) {
        acc = acc + list[k].d * tile[(32 * s + k) * N + j];
      }
      if (s < L.sx) ax = acc; else ah = acc;
    }"""
_CHUNK = "constexpr int kChunk = 8;"
CELL_VARIANTS = {
    "rows staged in a shared tile first (the design before)": (
        True, _patches((
            ("  float r = 0.0f;\n  if (j < N) {\n    float ax = 0.0f, ah = 0.0f;\n"
             + _CELL_SUMS, "  float r = 0.0f;\n" + _CELL_TILE),
            ("  const size_t smem = layout(I, H).total;\n",
             "  const size_t smem = layout(I, H).total +\n"
             "      4 * static_cast<size_t>(32 * ((I + 31) / 32 + (H + 31) / 32))"
             " * 3 * H;\n"
             "  cudaError_t err = cudaFuncSetAttribute(\n"
             "      delta_gru_cell_kernel,"
             " cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
             "      static_cast<int>(smem));\n"
             "  if (err != cudaSuccess) return static_cast<int>(err);\n")))),
    "direct reads, 4 in flight": (True, _patches(((
        _CHUNK, "constexpr int kChunk = 4;"),))),
    "direct reads, 16 in flight": (True, _patches(((
        _CHUNK, "constexpr int kChunk = 16;"),))),
    "direct reads, 32 in flight": (True, _patches(((
        _CHUNK, "constexpr int kChunk = 32;"),))),
}


# ------------------------------------------------ detect_head variants --
# The first design: one thread per slot, the K classes of a frame in that
# thread's registers (its twelve exps and IEEE divisions form one chain),
# launched with one thread per slot whatever plan the wrapper passes.
_THREAD_PER_SLOT = r"""namespace {

constexpr int kWindow = 32;   // XLA:CPU's reduction window

struct Args {
  const float* logits;   // (F, B, K)
  const float* smooth0;  // (B, K)
  const int* active0;    // (B,)
  const int* refract0;   // (B,)
  const float* fire;     // (K - first_kw,)
  const float* rel;      // (K - first_kw,)
  float alpha;
  int refractory, first_kw;
  float* smooth;         // (B, K)
  int* active;           // (B,)
  int* refract;          // (B,)
  int* events;           // (F, B)
  int F, B, K;
};

// jnp.max of two values: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int KMAX>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int K, float (&x)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) x[k] = row[k];
  }
}

template <int KMAX>
__global__ void __launch_bounds__(128)
detect_head_kernel(const Args a) {
  extern __shared__ float th[];  // fire thresholds, then release
  const int n_kw = a.K - a.first_kw;
  for (int i = threadIdx.x; i < n_kw; i += blockDim.x) {
    th[i] = a.fire[i];
    th[a.K + i] = a.rel[i];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int K = a.K;
  // Window split of the sum: classes [0, split) then [split, K).
  const int split =
      K <= kWindow ? K : kWindow - (2 * kWindow - K) / 2;

  float s[KMAX], x[KMAX], xn[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    s[k] = k < K ? a.smooth0[static_cast<size_t>(b) * K + k] : 0.0f;
    x[k] = 0.0f;
    xn[k] = 0.0f;
  }
  int active = a.active0[b];
  int refract = a.refract0[b];
  const size_t stride = static_cast<size_t>(a.B) * K;
  const float* row = a.logits + static_cast<size_t>(b) * K;
  if (a.F > 0) load_row<KMAX>(row, K, x);

  for (int f = 0; f < a.F; ++f) {
    if (f + 1 < a.F) load_row<KMAX>(row + (f + 1) * stride, K, xn);
    float m = x[0];
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
      if (k < K) m = nan_max(m, x[k]);
    }
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        x[k] = xla_math::exp(x[k] - m);
        if (k < split) {
          p0 = p0 + x[k];
        } else {
          p1 = p1 + x[k];
        }
      }
    }
    const float sum = K <= kWindow ? p0 : p0 + p1;
    bool any_exceed = false, all_below = true;
    float best = -INFINITY;
    int cls = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float post = x[k] / sum;
        s[k] = fmaf(a.alpha, post - s[k], s[k]);
        if (k >= a.first_kw) {
          const int j = k - a.first_kw;
          const bool ex = s[k] > th[j];
          const float cand = ex ? s[k] : -INFINITY;
          if (cand > best) {   // the first index among equal maxima
            best = cand;
            cls = j;
          }
          any_exceed |= ex;
          all_below &= s[k] < th[K + j];
        }
      }
    }
    const bool idle = active == -1;
    const bool fire = idle && refract == 0 && any_exceed;
    const bool release = !idle && all_below;
    const int c = cls + a.first_kw;
    active = fire ? c : (release ? -1 : active);
    const int down = static_cast<int>(static_cast<unsigned>(refract) - 1u);
    refract = fire ? a.refractory : (down > 0 ? down : 0);
    a.events[static_cast<size_t>(f) * a.B + b] = fire ? c : -1;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) x[k] = xn[k];
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) a.smooth[static_cast<size_t>(b) * K + k] = s[k];
  }
  a.active[b] = active;
  a.refract[b] = refract;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for K classes: the fire and the
// release thresholds, K floats each.
extern "C" long long detect_head_smem_bytes(int K) {
  return 2LL * 4 * K;
}

// logits (F, B, K), smooth0 / smooth (B, K) float32; active0 / refract0 /
// active / refract (B,) and events (F, B) int32; fire / rel one float32
// per keyword (K - first_kw); all contiguous on the current device.
// Launches the wrapper's plan (grid CTAs of `block` threads, `smem` bytes
// of dynamic shared memory) on `stream` and returns the launch's error,
// or cudaErrorInvalidValue for a shape or plan this kernel cannot run.
extern "C" int detect_head_launch(
    const float* logits, const float* smooth0, const int* active0,
    const int* refract0, const float* fire, const float* rel, float alpha,
    int refractory, int first_kw, float* smooth, int* active, int* refract,
    int* events, int F, int B, int K, int grid, int block, int smem,
    void* stream) {
  if (K < 1 || K > 64 || first_kw < 0 || first_kw >= K || F < 0 || B < 1 ||
      smem < detect_head_smem_bytes(K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  block = B < 128 ? (B + 31) / 32 * 32 : 128;   // one thread per slot
  grid = (B + block - 1) / block;
  const Args args{logits, smooth0, active0, refract0, fire, rel, alpha,
                  refractory, first_kw, smooth, active, refract, events,
                  F, B, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 16) {
    detect_head_kernel<16><<<grid, block, smem, s>>>(args);
  } else if (K <= 32) {
    detect_head_kernel<32><<<grid, block, smem, s>>>(args);
  } else {
    detect_head_kernel<64><<<grid, block, smem, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int detect_head_group(int K) { return K <= 16 ? 16 : 32; }
"""
_HEAD_SUM = """    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int k = 0; k < G * PER; ++k) {"""
DETECT_VARIANTS = {
    "one thread per slot (the first design)": (
        True, lambda src: src[:src.index("namespace {")] + _THREAD_PER_SLOT),
    "logits 2 frames ahead": (True, _patches(((
        "constexpr int kAhead = 1;", "constexpr int kAhead = 2;"),))),
    "logits 4 frames ahead": (True, _patches(((
        "constexpr int kAhead = 1;", "constexpr int kAhead = 4;"),))),
    "logits 8 frames ahead": (True, _patches(((
        "constexpr int kAhead = 1;", "constexpr int kAhead = 8;"),))),
    "ablation: no exp": (False, _patches(((
        "      e[j] = xla_math::exp(x[j] - m);", "      e[j] = x[j] - m;"),))),
    "ablation: no division": (False, _patches(((
        "        const float post = e[j] / sum;",
        "        const float post = e[j] * sum;"),))),
    "ablation: the sum by a butterfly": (False, _patches(((
        _HEAD_SUM, """    float p0 = e[0], p1 = 0.0f;
#pragma unroll
    for (int d = G / 2; d > 0; d /= 2) {
      p0 += __shfl_xor_sync(0xffffffffu, p0, d, G);
    }
#pragma unroll
    for (int k = 0; k < 0; ++k) {"""),))),
}


# clock64() stamps in thread 0, summed over the CTAs in g_phase[k]: 0 the
# prologue, then per frame 1 the Δ encoders, 2 the first barrier, 3 the
# row sums, 4 the reduce-scatter and accumulate, 5 the second barrier, 6
# the gates and the hs store.
PHASES = ("prologue (per CTA)", "encode", "barrier 1", "row sums",
          "reduce-scatter + accumulate", "barrier 2", "gates + store")
_STAMPS = (
    ("  unsigned char* wx = smem;\n",
     "  long long c_prev = clock64();\n  unsigned char* wx = smem;\n"),
    ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n",
     '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n  STAMP(0)\n"),
    ("    __syncthreads();\n\n    // 2. Column sums",
     "    STAMP(1)\n    __syncthreads();\n    STAMP(2)\n\n    // 2. Column sums"),
    ("    const uint32_t sum_x = reduce_scatter(px, s);\n",
     "    STAMP(3)\n    const uint32_t sum_x = reduce_scatter(px, s);\n"),
    ("    __syncthreads();\n\n    // 3. Type-2",
     "    STAMP(4)\n    __syncthreads();\n    STAMP(5)\n\n    // 3. Type-2"),
    ("      a.hs[row * H + j] = static_cast<int16_t>(hcur);\n    }\n",
     "      a.hs[row * H + j] = static_cast<int16_t>(hcur);\n    }\n"
     "    STAMP(6)\n"),
    ("template <bool kMasked>\n"
     "__global__ void delta_gru_seq_int_kernel(Args a) {",
     "__device__ unsigned long long g_phase[7];\n"
     "#define STAMP(k) if (threadIdx.x == 0) { \\\n"
     "  const long long c_now = clock64(); \\\n"
     "  atomicAdd(&g_phase[k], static_cast<unsigned long long>(c_now - "
     "c_prev)); \\\n  c_prev = c_now; }\n"
     "template <bool kMasked>\n"
     "__global__ void delta_gru_seq_int_kernel(Args a) {"),
)
_READ_PHASES = """
extern "C" int read_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (e != cudaSuccess) return static_cast<int>(e);
  static const unsigned long long zero[7] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
"""


def _phase_stamps(src: str) -> str:
    for old, new in _STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"phase stamps: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + _READ_PHASES


# The same seven stamps in the float kernel (phase 4: the accumulate, the
# σ of the r and u columns and the shared stores).
F_PHASES = PHASES[:4] + ("accumulate + σ + store",) + PHASES[5:]
_F_STAMPS = (
    ("  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  const int I = a.I, H = a.H, N = 3 * H, B = a.B, T = a.T;\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  long long c_prev = clock64();\n"
     "  const int I = a.I, H = a.H, N = 3 * H, B = a.B, T = a.T;\n"),
    _STAMPS[1],
    ("    __syncthreads();\n\n    // 2. Column j",
     "    STAMP(1)\n    __syncthreads();\n    STAMP(2)\n\n    // 2. Column j"),
    ("      mx = mx + ax;\n", "      STAMP(3)\n      mx = mx + ax;\n"),
    ("    __syncthreads();\n\n    // 3. The candidate",
     "    STAMP(4)\n    __syncthreads();\n    STAMP(5)\n\n    // 3. The candidate"),
    ("      a.hs[row * H + j] = hcur;\n    }\n",
     "      a.hs[row * H + j] = hcur;\n    }\n    STAMP(6)\n"),
    *((a.replace("delta_gru_seq_int_kernel", "delta_gru_seq_kernel")
        .replace("<bool kMasked>", "<bool kMasked, bool kStaged>"),
       b.replace("delta_gru_seq_int_kernel", "delta_gru_seq_kernel")
        .replace("<bool kMasked>", "<bool kMasked, bool kStaged>"))
      for a, b in (_STAMPS[6],)),
)


def _f_phase_stamps(src: str) -> str:
    return _patches(_F_STAMPS)(src) + _READ_PHASES


def run_stamped(torch, build, kernel, lib, call, shapes, n, report):
    """Run a stamped build of ``kernel`` once per shape (it must give the
    committed kernel's outputs bit for bit) and hand its ``n`` counters,
    read and zeroed through ``read_phases``, to ``report(label, args,
    counters)``."""
    committed = build.load(kernel)
    read = lib.read_phases
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * n)()
    for label, args in shapes:
        build._loaded[kernel] = committed
        want = call(args)
        build._loaded[kernel] = lib
        call(args)                           # warm; then zero the counters
        torch.cuda.synchronize()
        if read(buf):
            raise SystemExit("read_phases failed")
        got = call(args)
        torch.cuda.synchronize()
        if read(buf):
            raise SystemExit("read_phases failed")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"the stamped {kernel} changed the outputs")
        report(label, args, list(buf))
    build._loaded[kernel] = committed


def gru_phase_report(results, kernel="delta_gru_seq_int", phases=PHASES):
    """Cycles per frame of each step of the ΔGRU frame in thread 0,
    averaged over the CTAs and frames."""
    def report(label, args, c):
        T, B = args[0].shape[0], args[0].shape[1]
        per = [c[0] / B] + [c[k] / (B * T) for k in range(1, 7)]
        print(f"[phases] {kernel} {label}: prologue {per[0]:.0f} "
              f"cycles per CTA; per frame {sum(per[1:]):.0f} cycles: "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(phases[1:],
                                                         per[1:])))
        results.setdefault(f"{kernel} phases (cycles)", {})[
            label] = dict(zip(phases, per))
    return report


def fex_phase_report(results, samples: int):
    """Per warp of the FEx pipeline, averaged over the CTAs: its cycles,
    those spent in bar.sync and in cp.async.wait_group, and the rest per
    sample."""
    def report(label, args, c):
        ctas = -(-args[0].shape[0] * 10 // 32)
        rows = {}
        for w, role in enumerate(FEX_ROLES):
            total, bar, cp = (c[4 * k + w] / ctas for k in range(3))
            rows[role] = {"cycles": total, "bar_sync": bar, "cp_wait": cp,
                          "rest_per_sample": (total - bar - cp) / samples}
        print(f"[phases] iir_fex {label}: " + "; ".join(
            f"{r} {v['cycles']:.0f} cycles, bar.sync {v['bar_sync']:.0f}, "
            f"cp.async wait {v['cp_wait']:.0f}, the rest "
            f"{v['rest_per_sample']:.2f} per sample" for r, v in rows.items()))
        results.setdefault("iir_fex phases (cycles per CTA)", {})[label] = rows
    return report


def _inline_headers(build, src: str) -> str:
    """The kernel source with its own headers (every csrc/*.cuh but
    xla_math.cuh) pasted in place of their #include lines, so that a
    variant can patch the steps they hold; it compiles to the same code."""
    for h in sorted(build.CSRC.glob("*.cuh")):
        line = f'#include "{h.name}"\n'
        if h.name != "xla_math.cuh" and line in src:
            src = src.replace(line, h.read_text().replace("#pragma once\n",
                                                          ""))
    return src


def build_variants(build, kernel: str, variants: dict, out_dir: pathlib.Path):
    """Write and compile every variant of csrc/<kernel>.cu (one nvcc each,
    all started together); returns {name: loaded library}.  Fails when a
    replacement does not apply (the source moved on) or nvcc fails."""
    src = _inline_headers(build, (build.CSRC / f"{kernel}.cu").read_text())
    procs = {}
    for i, (name, (_, patch, *_)) in enumerate(variants.items()):
        text = patch(src)
        if text == src:
            raise SystemExit(f"variant {name!r}: no replacement applied")
        cu = out_dir / f"{kernel}_v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_variants(torch, cs, build, kernel, libs, variants, module, call,
                  outputs, shapes, results):
    """For each shape: the committed library, then every variant, then in
    reverse order, then the committed one again, each timed with
    chip_smoke.graph_ms with its wrapper constants set on ``module``;
    exact variants are compared bit for bit."""
    committed = build.load(kernel)
    order = ["committed", *libs, *reversed(list(libs)), "committed"]
    exact = {k: v[0] for k, v in variants.items()}
    for label, args in shapes:
        build._loaded[kernel] = committed
        want = outputs(call(args))
        for name in order:
            build._loaded[kernel] = (committed if name == "committed"
                                     else libs[name])
            consts = variants[name][2] if name != "committed" and len(
                variants[name]) > 2 else {}
            saved = {k: getattr(module, k) for k in consts}
            for k, v in consts.items():
                setattr(module, k, v)
            got = outputs(call(args))
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = cs.graph_ms(torch, lambda: call(args))
            for k, v in saved.items():
                setattr(module, k, v)
            results.setdefault(kernel, {}).setdefault(name, {}).setdefault(
                label, []).append(ms)
            check = ("timing only" if name != "committed" and not exact[name]
                     else f"bit-equal to the committed kernel: {same}")
            print(f"[variant] {kernel} {label} {name}: {ms:.4f} ms ({check})")
            if name != "committed" and exact[name] and not same:
                raise SystemExit(f"{kernel} variant {name!r} changed the "
                                 f"outputs")
    build._loaded[kernel] = committed


def time_detect_head_variants(torch, cs, build, tmp, results):
    """detect_head's variants at F = 32 frames of B = 32 and 256 slots, 12
    classes, the always-on phase's detector configuration."""
    from repro_torch.kernels import detect_head as dh
    from repro_torch.models.detector import DetectorConfig, init_detector_state
    libs = build_variants(build, "detect_head", DETECT_VARIANTS, tmp)
    gen = torch.Generator(device="cuda").manual_seed(41)
    cfg = DetectorConfig(0.25, 0.09, 0.087, 30)
    shapes = [(f"B={B}", (0.8 * torch.randn(32, B, 12, generator=gen,
                                            device="cuda"),
                          init_detector_state(B, 12, "cuda")))
              for B in (cs.SLOTS, cs.ALWAYS_ON_SLOTS)]
    call = lambda a: dh.detect_head(a[0], a[1], cfg)
    out = lambda o: [o[1], o[0].smooth.view(torch.int32), o[0].active,
                     o[0].refract]
    time_variants(torch, cs, build, "detect_head", libs, DETECT_VARIANTS,
                  dh, call, out, shapes, results)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants.py needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import build
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex

    card = cs.card_line(torch)
    print(f"[card] {card} | torch {torch.__version__}")
    build.build(("iir_fex", "delta_gru_seq_int", "iir_fex_int",
                 "delta_gru_seq", "delta_gru_cell", "detect_head"))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        time_detect_head_variants(torch, cs, build, pathlib.Path(tmp),
                                  results)
        fex_libs = build_variants(
            build, "iir_fex", {**FEX_VARIANTS, "stamps": (True, _fex_stamps)},
            pathlib.Path(tmp))
        fex_stamped = fex_libs.pop("stamps")
        gru_libs = build_variants(
            build, "delta_gru_seq_int",
            {**GRU_VARIANTS, "stamps": (True, _phase_stamps)},
            pathlib.Path(tmp))
        phase_lib = gru_libs.pop("stamps")
        f_libs = build_variants(
            build, "delta_gru_seq",
            {**F_GRU_VARIANTS, "stamps": (True, _f_phase_stamps)},
            pathlib.Path(tmp))
        f_phase_lib = f_libs.pop("stamps")
        cell_libs = build_variants(build, "delta_gru_cell", CELL_VARIANTS,
                                   pathlib.Path(tmp))
        x, fex, params = cs.make_inputs(torch, np)
        coef = fex.coef.cuda()
        kw = dict(frame_shift=fex.cfg.frame_shift, env_alpha=fex.cfg.env_alpha,
                  log_eps=fex.cfg.log_eps)
        bits = lambda out: [t.contiguous().view(torch.int32) for t in out]
        fex_shapes = [(f"B={B}", (x[:, :cs.CHUNK].repeat(B // cs.SLOTS, 1)
                                  .contiguous(),
                                  iir_fex.init_fex_kernel_state(B, 10, "cuda")))
                      for B in (cs.SLOTS, cs.ALWAYS_ON_SLOTS)]
        fex_call = lambda a: iir_fex.batched_iir_fex(a[0], coef, a[1], **kw)
        time_variants(torch, cs, build, "iir_fex", fex_libs, FEX_VARIANTS,
                      iir_fex, fex_call, bits, fex_shapes, results)
        run_stamped(torch, build, "iir_fex", fex_stamped,
                    lambda a: bits(fex_call(a)), fex_shapes, 12,
                    fex_phase_report(results, cs.CHUNK))

        # Float ΔGRU and cell on the float FEx's features of the chunk.
        from repro_torch.core import delta_gru as dg
        from repro_torch.kernels import delta_gru_cell as dgc
        fl, _ = iir_fex.batched_iir_fex(x[:, :cs.CHUNK].contiguous(), coef,
                                        iir_fex.init_fex_kernel_state(
                                            cs.SLOTS, 10, "cuda"), **kw)
        fxs = fl.movedim(1, 0).contiguous()
        g = dg.DeltaGRUParams(*(params[k].cuda() for k in ("w_x", "w_h",
                                                           "b")))
        f_shapes = [(f"B={B}", (fxs.repeat(1, B // cs.SLOTS, 1).contiguous(),
                                dg.init_delta_state(B, 10, 64, g)))
                    for B in (cs.SLOTS, cs.ALWAYS_ON_SLOTS)]
        f_call = lambda a: dgs.delta_gru_seq(a[0], *a[1], g.w_x, g.w_h, 0.1)
        f_out = lambda out: bits([out[0], *out[1]]) + [out[2], out[3]]
        time_variants(torch, cs, build, "delta_gru_seq", f_libs,
                      F_GRU_VARIANTS, dgs, f_call, f_out, f_shapes, results)
        run_stamped(torch, build, "delta_gru_seq", f_phase_lib,
                    lambda a: f_out(f_call(a)), f_shapes, 7,
                    gru_phase_report(results, "delta_gru_seq", F_PHASES))
        cell_shapes = []
        for label, (xb, st0) in f_shapes:       # halfway through the chunk
            _, st, _, _ = dgs.delta_gru_seq(xb[:16].contiguous(), *st0,
                                            g.w_x, g.w_h, 0.1)
            cell_shapes.append((label, (xb[16].contiguous(), *st)))
        cell_call = lambda a: dgc.delta_gru_cell(*a, g.w_x, g.w_h, 0.1)
        time_variants(torch, cs, build, "delta_gru_cell", cell_libs,
                      CELL_VARIANTS, dgc, cell_call, bits, cell_shapes,
                      results)

        bundle = cs.promote(params, fex)
        codes = fp.to_code(x[:, :cs.CHUNK], bundle.ffmt.feat_frac, 16,
                           torch.int16)
        feats, _ = iir_fex.batched_iir_fex_int(
            codes, bundle.coef, fp.init_int_fex_state(cs.SLOTS, 10, "cuda"),
            fmt=bundle.ffmt)
        xs = feats.movedim(1, 0).contiguous()
        w, gfmt = bundle.gru, bundle.gfmt
        th = gfmt.th_codes(0.1)
        gru_shapes = [(f"B={B}", (xs.repeat(1, B // cs.SLOTS, 1).contiguous(),
                                  fp.init_int_delta_state(B, 10, 64, w)))
                      for B in (cs.SLOTS, cs.ALWAYS_ON_SLOTS)]
        gru_call = lambda a: dgs.delta_gru_seq_int(a[0], *a[1], w.w_x, w.w_h,
                                                   th, fmt=gfmt)
        gru_out = lambda out: [out[0], *out[1], out[2], out[3]]
        time_variants(torch, cs, build, "delta_gru_seq_int", gru_libs,
                      GRU_VARIANTS, dgs, gru_call, gru_out, gru_shapes,
                      results)
        run_stamped(torch, build, "delta_gru_seq_int", phase_lib,
                    lambda a: gru_out(gru_call(a)), gru_shapes, 7,
                    gru_phase_report(results))
    print(card)
    print(json.dumps({"card": card, "device_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
