#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the run the README documents
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of the
                                     #   always-on serving step

Phases, each exiting non-zero on failure:
  1. the card's name and power limit; build all four CUDA kernels with
     nvcc (one process per source, all started together) and print the
     build seconds and ptxas reports;
  2. hold each kernel against its plain PyTorch version on the card, at
     the serving shapes.  Float: FEx 12-bit codes exactly equal and raw
     envelopes within 1e-5 relative; ΔGRU hs within 1e-5 absolute at
     Δ_TH 0, 0.1 and 0.2 (transmit-count mismatches are counted).
     Integer: FEx feature codes and registers over two carried chunks,
     and the ΔGRU's hs codes, final h/x̂/ĥ/m_x/m_h and both transmit
     counts at Δ_TH 0, 0.1, 0.2 and with accumulators started at the
     24-bit rail — all exactly equal (tolerance 0);
  3. time each kernel and its plain version (CUDA events, warm-up,
     median) beside the bound worked out from the shapes;
  4. serve 64 one-second requests on 32 slots at the paper model's full
     width through ``repro_torch.launch.serve``, once per numerics
     (launch counters zeroed just before, read just after: the path's
     two kernels must have launched once per step, the other numerics'
     kernels not at all); check a CUDA session against the CPU
     plain-version session on a small input in both numerics; then a
     timed always-on phase in each, 256 slots × 16 chunks of 4096
     samples;
  5. the ``kernels`` JSON line, the card line, and the final
     ``{"ok": true, ...}`` line.

Needs one CUDA GPU and nvcc; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# H100 SXM int32 outside the tensor cores: 64 INT32 lanes per SM (Hopper
# white paper) × 132 SMs × 1.98 GHz boost, a multiply-add counted as two
# operations, as the fp32 figure counts an FMA.
INT32_OPS = 33.5e12
SLOTS, REQUESTS, CHUNK = 32, 64, 4096
ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS = 256, 16
THRESHOLDS = (0.0, 0.1, 0.2)
HS_ATOL = 1e-5                 # ΔGRU kernel vs plain, absolute
ENV_RTOL = 1e-5                # FEx raw envelope kernel vs plain, relative
SAT_MARGIN = 1 << 10           # int ΔGRU saturation case: start this close
VOTE_MISMATCH_MAX = 0.01       # int8 CUDA vs CPU session votes


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line(torch) -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def cuda_ms(torch, fn, reps: int, warmup: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after ``warmup`` runs that also bring the clocks up; prints the
    spread."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    med = statistics.median(times)
    print(f"[time]   median {med:.4f} ms of {reps} (min {min(times):.4f}, "
          f"max {max(times):.4f})")
    return med


# ------------------------------------------------------------ bounds --
FEX_OPS_PER_SAMPLE = 18        # 2 biquads (7 each) + envelope (4)
FEX_OPS_PER_FRAME = 10         # log2, normalise, clamp, round, clamp
GATE_OPS_PER_UNIT = 17         # 2 sigmoids (5) + tanh path (3) + blend (4)


FEX_INT_OPS_PER_SAMPLE = 52    # 12 products, 12 round-shifts, 8 clamps,
                               # adds, envelope blend (csrc/iir_fex_int.cu)
GATE_INT_OPS_PER_UNIT = 45     # r/u/c dequant, σ/tanh, requant, blend
COL_INT_OPS = 5                # align + accumulate + saturate per column


def bound(bytes_moved: float, flops: float,
          rate: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fex_bound(B, S, C):
    F = S // 128
    moved = 4 * (B * S + 6 * C + 2 * B * 5 * C + B * F * C)
    return bound(moved, B * S * C * FEX_OPS_PER_SAMPLE
                 + B * F * C * FEX_OPS_PER_FRAME)


def gru_bound(T, B, I, H, nz_total):
    N = 3 * H
    state = B * (H + I + H + N + N)
    moved = 4 * (T * B * I + (I + H) * N + 2 * state + T * B * H + 2 * T * B)
    flops = (2 * N * nz_total
             + T * B * (3 * (I + H) + 2 * N + GATE_OPS_PER_UNIT * H))
    return bound(moved, flops)


def fex_int_bound(B, S, C):
    F = S // 128
    moved = 2 * B * S + 4 * 6 * C + 2 * (2 * B * 5 * C) + 2 * B * F * C
    return bound(moved, B * S * C * FEX_INT_OPS_PER_SAMPLE
                 + B * F * C * FEX_OPS_PER_FRAME, INT32_OPS)


def gru_int_bound(T, B, I, H, nz_total):
    N = 3 * H
    state = B * (2 * (H + I + H) + 4 * 2 * N)
    moved = (2 * T * B * I + (I + H) * N + 2 * state + 2 * T * B * H
             + 2 * 4 * T * B)
    ops = (2 * N * nz_total
           + T * B * (3 * (I + H) + 2 * N * COL_INT_OPS
                      + GATE_INT_OPS_PER_UNIT * H))
    return bound(moved, ops, INT32_OPS)


# ------------------------------------------------------------- phases --
def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    secs = time.perf_counter() - t0
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}")
    for name, b in built.items():
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "smem" in ln]
        print(f"[build] {name}: {b.path.name} ({b.seconds:.1f} s) "
              f"{' | '.join(regs)}")
    print(f"[build] {len(built)} kernels built in {secs:.1f} s")
    if sorted(built) != sorted(build.KERNELS) or len(built) != 4:
        fail(f"expected the four kernels {build.KERNELS}, built "
             f"{sorted(built)}")
    # The wrappers' shared-memory formulas must be the kernels' own.
    from repro_torch.kernels import delta_gru_seq as dgs
    for name, formula in (("delta_gru_seq", dgs.seq_kernel_smem_bytes),
                          ("delta_gru_seq_int",
                           dgs.int_seq_kernel_smem_bytes)):
        fn = getattr(build.load(name), f"{name}_smem_bytes")
        fn.restype = ctypes.c_longlong
        for I, H in ((10, 64), (10, 16), (40, 100), (7, 5)):
            if fn(I, H) != formula(I, H):
                fail(f"{name} shared-memory formula mismatch at I={I} "
                     f"H={H}: kernel {fn(I, H)}, wrapper {formula(I, H)}")
    return secs


def make_inputs(torch, np):
    """Serving-shaped inputs: 12-bit keyword audio for SLOTS streams (two
    4096-sample chunks each), the FEx bank, the full-width model."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.core.quantize import quantize_audio_12b
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.models import kws
    audio, _ = synth_batch(np.random.default_rng(0), SLOTS)
    audio = np.concatenate([audio, audio[::-1]], axis=1)[:, :2 * CHUNK]
    x = quantize_audio_12b(torch.from_numpy(audio).cuda())
    fex = FeatureExtractor()
    params = kws.init_kws(torch.Generator().manual_seed(0), CONFIG,
                          input_dim=fex.cfg.n_active)
    return x, fex, params


def compare_fex(torch, x, fex):
    from repro_torch.kernels import iir_fex
    cfg = fex.cfg
    coef = fex.coef.cuda()
    kw = dict(frame_shift=cfg.frame_shift, env_alpha=cfg.env_alpha,
              log_eps=cfg.log_eps)
    res = {}
    for compress in (True, False):
        sk = sp = iir_fex.init_fex_kernel_state(x.shape[0], coef.shape[1],
                                                "cuda")
        fk_all, fp_all = [], []
        for half in range(2):
            xc = x[:, half * CHUNK:(half + 1) * CHUNK].contiguous()
            fk, sk = iir_fex.batched_iir_fex(xc, coef, sk, compress=compress,
                                             **kw)
            fp, sp = iir_fex.batched_iir_fex_ref(xc, coef, sp,
                                                 compress=compress, **kw)
            fk_all.append(fk)
            fp_all.append(fp)
        torch.cuda.synchronize()
        fk, fp = torch.cat(fk_all, 1), torch.cat(fp_all, 1)
        state_err = (sk - sp).abs().max().item()
        if compress:
            mism = int((fk != fp).sum().item())
            err = (fk - fp).abs().max().item()
            print(f"[compare] iir_fex compress=True  B={x.shape[0]} "
                  f"S=2x{CHUNK} C={coef.shape[1]}: {mism} of {fk.numel()} "
                  f"12-bit codes differ, max abs err {err:.3g}, final "
                  f"state max abs diff {state_err:.3g}")
            if mism:
                fail(f"iir_fex: {mism} feature codes differ from the plain "
                     f"version")
            res["max_abs_err"] = err
            res["feats"] = fk
        else:
            rel = ((fk - fp).abs() / fp.abs().clamp_min(1e-30)).max().item()
            print(f"[compare] iir_fex compress=False: raw envelope max rel "
                  f"err {rel:.3g} (bound {ENV_RTOL}), final state max abs "
                  f"diff {state_err:.3g}")
            if not rel <= ENV_RTOL:
                fail(f"iir_fex raw envelope rel err {rel} > {ENV_RTOL}")
            res["env_rel_err"] = rel
    return res


def compare_gru(torch, feats, params):
    """feats: (B, 2*T, C) FEx codes; two chunks of T frames, state carried."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.kernels import delta_gru_seq as dgs
    w_x, w_h, b = (params[k].cuda() for k in ("w_x", "w_h", "b"))
    gru = dg.DeltaGRUParams(w_x, w_h, b)
    xs = feats.movedim(1, 0).contiguous()              # (2T, B, C)
    T, B, I = xs.shape[0] // 2, xs.shape[1], xs.shape[2]
    H = w_h.shape[0]
    worst, nz_total = 0.0, {}
    for th in THRESHOLDS:
        sk = sp = dg.init_delta_state(B, I, H, gru)
        hs_err = st_err = 0.0
        nz_mism = 0
        nz_sum = 0
        for c in range(2):
            chunk = xs[c * T:(c + 1) * T].contiguous()
            hk, sk, nzxk, nzhk = dgs.delta_gru_seq(chunk, *sk, w_x, w_h, th)
            hp, sp, nzxp, nzhp = dgs.delta_gru_seq_ref(chunk, *sp, w_x, w_h,
                                                       th)
            torch.cuda.synchronize()
            hs_err = max(hs_err, (hk - hp).abs().max().item())
            st_err = max(st_err, max(
                ((a - r).abs() / (1.0 + r.abs())).max().item()
                for a, r in zip(sk, sp)))
            nz_mism += int((nzxk != nzxp).sum().item()
                           + (nzhk != nzhp).sum().item())
            if c == 0:
                nz_sum = int(nzxk.sum().item() + nzhk.sum().item())
        print(f"[compare] delta_gru_seq Δ_TH={th}: T={T} B={B} I={I} H={H}, "
              f"hs max abs diff {hs_err:.3g} (bound {HS_ATOL}), state max "
              f"diff {st_err:.3g} (relative to 1+|x|), nz mismatches "
              f"{nz_mism}, transmitted {nz_sum} of {T * B * (I + H)} "
              f"(chunk 1)")
        if not (hs_err <= HS_ATOL and st_err <= HS_ATOL):
            fail(f"delta_gru_seq Δ_TH={th}: hs diff {hs_err}, state diff "
                 f"{st_err} > {HS_ATOL}")
        worst = max(worst, hs_err)
        nz_total[th] = nz_sum
    return {"max_abs_err": worst, "nz_total": nz_total, "xs": xs[:T],
            "gru": gru}


def time_kernels(torch, x, fex, gru_res):
    from repro_torch.core import delta_gru as dg
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    cfg = fex.cfg
    coef = fex.coef.cuda()
    C = coef.shape[1]
    kw = dict(frame_shift=cfg.frame_shift, env_alpha=cfg.env_alpha,
              log_eps=cfg.log_eps)
    out = {}
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        xb = x[:, :CHUNK].repeat(B // SLOTS, 1).contiguous()
        st = iir_fex.init_fex_kernel_state(B, C, "cuda")
        ms = cuda_ms(torch, lambda: iir_fex.batched_iir_fex(xb, coef, st,
                                                            **kw), 50)
        bnd, by = fex_bound(B, CHUNK, C)
        out[("fex", B)] = (ms, bnd, by)
    xs32 = x[:, :CHUNK].contiguous()
    st32 = iir_fex.init_fex_kernel_state(SLOTS, C, "cuda")
    out[("fex_plain", SLOTS)] = cuda_ms(
        torch, lambda: iir_fex.batched_iir_fex_ref(xs32, coef, st32, **kw),
        3, warmup=1)

    gru = gru_res["gru"]
    th = 0.1
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        xs = gru_res["xs"].repeat(1, B // SLOTS, 1).contiguous()
        T, _, I = xs.shape
        H = gru.w_h.shape[0]
        st = dg.init_delta_state(B, I, H, gru)
        args = (xs, *st, gru.w_x, gru.w_h, th)
        _, _, nzx, nzh = dgs.delta_gru_seq(*args)
        nz_total = int(nzx.sum().item() + nzh.sum().item())
        ms = cuda_ms(torch, lambda: dgs.delta_gru_seq(*args), 50)
        bnd, by = gru_bound(T, B, I, H, nz_total)
        out[("gru", B)] = (ms, bnd, by)
        if B == SLOTS:
            out[("gru_plain", SLOTS)] = cuda_ms(
                torch, lambda: dgs.delta_gru_seq_ref(*args), 10, warmup=2)
    for kind, steps, what in (("fex", CHUNK, "dependent samples"),
                              ("gru", 32, "dependent frames")):
        for B in (SLOTS, ALWAYS_ON_SLOTS):
            ms, bnd, by = out[(kind, B)]
            print(f"[time] {kind} B={B}: kernel {ms:.4f} ms, bound "
                  f"{bnd:.5f} ms ({by}), serial chain {steps} {what}: "
                  f"{ms * 1e6 / steps:.1f} ns per step")
        print(f"[time] {kind} B={SLOTS}: plain version "
              f"{out[(kind + '_plain', SLOTS)]:.2f} ms")
    return out


# ------------------------------------------------------- int8 phases --
def promote(params, fex, threshold=0.1):
    from repro_torch.core import fixed_point as fp
    return fp.bundle_to(fp.promote_kws(params, threshold, fex=fex), "cuda")


def compare_fex_int(torch, x, bundle):
    """Integer FEx kernel vs its plain version over two carried chunks:
    feature codes and registers must be identical."""
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import iir_fex
    ffmt = bundle.ffmt
    codes = fp.to_code(x, ffmt.feat_frac, 16, torch.int16)
    B, C = x.shape[0], bundle.coef.shape[1]
    sk = sp = fp.init_int_fex_state(B, C, "cuda")
    fk_all, fp_all = [], []
    for half in range(2):
        xc = codes[:, half * CHUNK:(half + 1) * CHUNK].contiguous()
        fk, sk = iir_fex.batched_iir_fex_int(xc, bundle.coef, sk, fmt=ffmt)
        fpl, sp = iir_fex.batched_iir_fex_int_ref(xc, bundle.coef, sp,
                                                  fmt=ffmt)
        fk_all.append(fk)
        fp_all.append(fpl)
    torch.cuda.synchronize()
    fk, fpl = torch.cat(fk_all, 1), torch.cat(fp_all, 1)
    mism = int((fk != fpl).sum().item())
    st_mism = int((sk != sp).sum().item())
    err = (fk.int() - fpl.int()).abs().max().item()
    print(f"[compare] iir_fex_int B={B} S=2x{CHUNK} C={C}: {mism} of "
          f"{fk.numel()} feature codes and {st_mism} of {sk.numel()} "
          f"register codes differ (tolerance 0); codes span "
          f"[{int(fk.min())}, {int(fk.max())}]")
    if mism or st_mism or fk.dtype != torch.int16:
        fail(f"iir_fex_int differs from its plain version: {mism} feature, "
             f"{st_mism} register codes")
    return {"max_abs_err": float(err), "feats": fk}


def compare_gru_int(torch, feats, bundle):
    """Integer ΔGRU kernel vs its plain version: two chunks of T frames
    with the state carried, at three thresholds, then one chunk whose
    accumulators start within SAT_MARGIN of the 24-bit rail.  Every
    output must be identical."""
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    w, gfmt = bundle.gru, bundle.gfmt
    xs = feats.movedim(1, 0).contiguous()              # (2T, B, C)
    T, B, I = xs.shape[0] // 2, xs.shape[1], xs.shape[2]
    H = w.w_h.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    rail = (1 << (gfmt.acc_bits - 1)) - 1

    def near_rail():
        mag = rail - torch.randint(0, SAT_MARGIN, (B, 3 * H), generator=gen,
                                   device="cuda")
        sign = torch.randint(0, 2, (B, 3 * H), generator=gen,
                             device="cuda") * 2 - 1
        return (mag * sign).to(torch.int32)

    nz_total, cases = {}, []
    for th in THRESHOLDS:
        cases.append((f"Δ_TH={th}", th, fp.init_int_delta_state(B, I, H, w),
                      2))
    st = fp.init_int_delta_state(B, I, H, w)
    cases.append(("saturation", 0.0, st._replace(m_x=near_rail(),
                                                 m_h=near_rail()), 1))
    for label, th, st0, n_chunks in cases:
        tcodes = gfmt.th_codes(th)
        sk = sp = tuple(st0)
        mism = {"hs": 0, "state": 0, "nz": 0}
        nz_sum = 0
        at_rail = 0
        for c in range(n_chunks):
            chunk = xs[c * T:(c + 1) * T].contiguous()
            hk, sk, nxk, nhk = dgs.delta_gru_seq_int(
                chunk, *sk, w.w_x, w.w_h, tcodes, fmt=gfmt)
            hp, sp, nxp, nhp = dgs.delta_gru_seq_int_ref(
                chunk, *sp, w.w_x, w.w_h, tcodes, fmt=gfmt)
            torch.cuda.synchronize()
            mism["hs"] += int((hk != hp).sum().item())
            mism["state"] += sum(int((a != r).sum().item())
                                 for a, r in zip(sk, sp))
            mism["nz"] += int((nxk != nxp).sum().item()
                              + (nhk != nhp).sum().item())
            if c == 0:
                nz_sum = int(nxk.sum().item() + nhk.sum().item())
            at_rail = int((torch.cat([sk[3], sk[4]], -1).abs()
                           >= rail).sum().item())
        print(f"[compare] delta_gru_seq_int {label} (codes {tcodes}): T={T} "
              f"B={B} I={I} H={H}, mismatches hs {mism['hs']}, state "
              f"{mism['state']}, nz {mism['nz']} (tolerance 0); "
              f"transmitted {nz_sum} of {T * B * (I + H)} (chunk 1); "
              f"accumulators at the rail after: {at_rail}")
        if any(mism.values()):
            fail(f"delta_gru_seq_int {label} differs from its plain "
                 f"version: {mism}")
        if label == "saturation" and at_rail == 0:
            fail("the saturation case never reached the accumulator rail")
        nz_total[label] = nz_sum
    return {"max_abs_err": 0.0, "nz_total": nz_total, "xs": xs[:T],
            "bundle": bundle}


def time_int_kernels(torch, x, gru_res, fex_bundle):
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    ffmt, coef = fex_bundle.ffmt, fex_bundle.coef
    C = coef.shape[1]
    codes = fp.to_code(x[:, :CHUNK], ffmt.feat_frac, 16, torch.int16)
    out = {}
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        xb = codes.repeat(B // SLOTS, 1).contiguous()
        st = fp.init_int_fex_state(B, C, "cuda")
        ms = cuda_ms(torch, lambda: iir_fex.batched_iir_fex_int(
            xb, coef, st, fmt=ffmt), 50)
        out[("fex_int", B)] = (ms, *fex_int_bound(B, CHUNK, C))
        if B == SLOTS:
            out[("fex_int_plain", SLOTS)] = cuda_ms(
                torch, lambda: iir_fex.batched_iir_fex_int_ref(
                    xb, coef, st, fmt=ffmt), 3, warmup=1)
    bundle = gru_res["bundle"]
    w, gfmt = bundle.gru, bundle.gfmt
    th = gfmt.th_codes(0.1)
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        xs = gru_res["xs"].repeat(1, B // SLOTS, 1).contiguous()
        T, _, I = xs.shape
        H = w.w_h.shape[0]
        st = fp.init_int_delta_state(B, I, H, w)
        args = (xs, *st, w.w_x, w.w_h, th)
        _, _, nzx, nzh = dgs.delta_gru_seq_int(*args, fmt=gfmt)
        nz_total = int(nzx.sum().item() + nzh.sum().item())
        ms = cuda_ms(torch, lambda: dgs.delta_gru_seq_int(*args, fmt=gfmt),
                     50)
        out[("gru_int", B)] = (ms, *gru_int_bound(T, B, I, H, nz_total))
        if B == SLOTS:
            out[("gru_int_plain", SLOTS)] = cuda_ms(
                torch, lambda: dgs.delta_gru_seq_int_ref(*args, fmt=gfmt),
                10, warmup=2)
    for kind, steps, what in (("fex_int", CHUNK, "dependent samples"),
                              ("gru_int", 32, "dependent frames")):
        for B in (SLOTS, ALWAYS_ON_SLOTS):
            ms, bnd, by = out[(kind, B)]
            print(f"[time] {kind} B={B}: kernel {ms:.4f} ms, bound "
                  f"{bnd:.5f} ms ({by}), serial chain {steps} {what}: "
                  f"{ms * 1e6 / steps:.1f} ns per step")
        print(f"[time] {kind} B={SLOTS}: plain version "
              f"{out[(kind + '_plain', SLOTS)]:.2f} ms")
    return out


def serve_main_path(torch, numerics: str = "float32"):
    """Serve through the CLI's entry point with every kernel's count set
    to 0 just before and read just after: the path's two kernels must
    have launched once per step (+ the warm-up step), the others never."""
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    from repro_torch.launch import serve
    wrappers = {"batched_iir_fex": iir_fex.batched_iir_fex,
                "delta_gru_seq": dgs.delta_gru_seq,
                "batched_iir_fex_int": iir_fex.batched_iir_fex_int,
                "delta_gru_seq_int": dgs.delta_gru_seq_int}
    path = (("batched_iir_fex_int", "delta_gru_seq_int")
            if numerics == "int8" else ("batched_iir_fex", "delta_gru_seq"))
    args = serve.build_parser().parse_args(
        ["--mode", "kws-audio", "--slots", str(SLOTS), "--requests",
         str(REQUESTS), "--chunk-samples", str(CHUNK), "--seed", "0",
         "--numerics", numerics])
    serve.validate_args(args)
    for fn in wrappers.values():
        fn.launches = 0
    sess, done, labels, stats, dt = serve.serve_kws_audio(args)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    summ = sess.summary()
    print(f"[serve] {numerics}: {len(done)} requests on {SLOTS} slots, "
          f"{stats['steps']} steps in {dt:.2f} s (warm-up "
          f"{stats['warmup_s']:.2f} s), frames {summ.frames}, sparsity "
          f"{summ.sparsity:.4f}, launches {launches}")
    want = stats["steps"] + 1                   # + the warm-up step
    if any(launches[k] != want for k in path) or any(
            v for k, v in launches.items() if k not in path):
        fail(f"the {numerics} serving path must launch {path} once per "
             f"step ({want}) and nothing else: {launches}")
    if sess.numerics != numerics:
        fail(f"served {sess.numerics}, asked for {numerics}")
    if summ.frames <= 0 or len(done) != REQUESTS:
        fail(f"serving produced {summ.frames} frames, {len(done)} decisions")
    if not all(0 <= p < sess.n_classes for _, p in done):
        fail("a decision is outside the class range")
    from repro_torch.launch.streaming import HEALTH_SAT
    flagged = sess.unhealthy_slots()
    sat = sum(1 for f in flagged.values() if f & HEALTH_SAT)
    if sat:
        print(f"[serve] {sat} slots with an accumulator at the 24-bit rail "
              f"(HEALTH_SAT, telemetry)")
    bad = {k: f for k, f in flagged.items() if f & ~HEALTH_SAT}
    if bad:
        fail(f"unhealthy slots after serving: {bad}")
    return {k: launches[k] for k in path}


def check_against_cpu(torch, np, params):
    """A full-width CUDA session against the CPU session (the kernels'
    plain versions, which the CPU tests hold against the JAX package) on
    a small input: 4 streams, three unaligned chunks."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import synth_batch
    from repro_torch.launch.streaming import StreamingKwsSession
    audio, _ = synth_batch(np.random.default_rng(7), 4)
    outs = {}
    for dev in ("cuda", "cpu"):
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=4,
                                   device=dev)
        parts = [sess.process_audio(audio[:, lo:hi])
                 for lo, hi in ((0, 1500), (1500, 1501), (1501, 4000))]
        outs[dev] = [torch.cat([getattr(p, f) for p in parts]).cpu()
                     for f in ("logits", "votes", "nz")]
    (lg, vo, nz), (lg_c, vo_c, nz_c) = outs["cuda"], outs["cpu"]
    err = (lg - lg_c).abs().max().item()
    print(f"[check] CUDA vs CPU session, 4 streams x 4000 samples: logits "
          f"{tuple(lg.shape)} finite={bool(torch.isfinite(lg).all())}, max "
          f"abs diff {err:.3g}, vote mismatches {int((vo != vo_c).sum())}, "
          f"nz mismatches {int((nz != nz_c).sum())}")
    if lg.shape != (31, 4, CONFIG.vocab_size) or not torch.isfinite(lg).all():
        fail(f"unexpected logits {tuple(lg.shape)}")
    if err > 1e-4 or not torch.equal(vo, vo_c):
        fail(f"CUDA session disagrees with the CPU session: {err}")


def check_int8_against_cpu(torch, np, params):
    """A full-width int8 CUDA session against the int8 CPU session (the
    kernels' plain versions on the CPU, which the CPU tests hold against
    the JAX package), 4 streams × 4000 samples in unaligned chunks.  The
    integer FEx registers and x̂ must be equal; h codes, logit codes and
    votes are counted — they can differ where the CPU's and the card's
    σ/tanh/log2 differ by an ulp — and votes must agree to 1 %."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import synth_batch
    from repro_torch.launch.streaming import StreamingKwsSession
    audio, _ = synth_batch(np.random.default_rng(7), 4)
    outs, states = {}, {}
    for dev in ("cuda", "cpu"):
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=4,
                                   device=dev, numerics="int8")
        parts = [sess.process_audio(audio[:, lo:hi])
                 for lo, hi in ((0, 1500), (1500, 1501), (1501, 4000))]
        outs[dev] = [torch.cat([getattr(p, f) for p in parts]).cpu()
                     for f in ("logits", "votes", "nz")]
        states[dev] = [t.cpu() for t in (*sess.fex_state, *sess.state)]
        frac = sess._bundle.gfmt.logit_frac
    (lg, vo, nz), (lg_c, vo_c, nz_c) = outs["cuda"], outs["cpu"]
    fex_m = sum(int((a != b).sum()) for a, b in
                zip(states["cuda"][:2], states["cpu"][:2]))
    xh_m = int((states["cuda"][3] != states["cpu"][3]).sum())
    h_m = int((states["cuda"][2] != states["cpu"][2]).sum())
    code_m = int((torch.round(lg * 2.0 ** frac)
                  != torch.round(lg_c * 2.0 ** frac)).sum())
    vote_m = int((vo != vo_c).sum())
    print(f"[check] int8 CUDA vs CPU session, 4 streams x 4000 samples: "
          f"logit codes {tuple(lg.shape)}, mismatches: FEx registers "
          f"{fex_m}, x̂ {xh_m}, final h codes {h_m} of "
          f"{states['cpu'][2].numel()}, logit codes {code_m} of "
          f"{lg.numel()}, votes {vote_m} of {vo.numel()}, nz "
          f"{int((nz != nz_c).sum())} of {nz.numel()}")
    if lg.shape != (31, 4, CONFIG.vocab_size) or not torch.isfinite(lg).all():
        fail(f"unexpected int8 logits {tuple(lg.shape)}")
    if fex_m:
        fail(f"int8 FEx registers differ between CUDA and CPU: {fex_m}")
    if vote_m > VOTE_MISMATCH_MAX * vo.numel():
        fail(f"int8 CUDA session disagrees with the CPU session on "
             f"{vote_m} of {vo.numel()} votes")
    return {"h": h_m, "logit_codes": code_m, "votes": vote_m}


def always_on(torch, np, params, card, profile: bool,
              numerics: str = "float32"):
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import synth_batch
    from repro_torch.launch.engine import warm_session
    from repro_torch.launch.streaming import StreamingKwsSession
    B, n = ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS
    pool, _ = synth_batch(np.random.default_rng(3), 64)
    rng = np.random.default_rng(4)
    per_stream = -(-n * CHUNK // pool.shape[1])
    streams = pool[rng.integers(0, len(pool), (B, per_stream))].reshape(B, -1)
    streams = np.ascontiguousarray(streams[:, :n * CHUNK])
    sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=B,
                               numerics=numerics)
    warm_session(sess, CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(n):
        sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK]).votes.cpu()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summ = sess.summary()
    audio_s = B * n * CHUNK / 8000.0
    print(f"[always-on] {numerics}: {B} slots x {n} chunks of {CHUNK} "
          f"samples: "
          f"{dt * 1e3 / n:.3f} ms per step, {summ.frames / dt:.0f} "
          f"decisions/s, {audio_s / dt:.1f}x realtime, sparsity "
          f"{summ.sparsity:.4f} (Δ_TH 0.1) [{card}]")
    if summ.frames != B * n * CHUNK // 128:
        fail(f"always-on phase counted {summ.frames} decisions")
    if profile:
        profile_steps(torch, sess, streams, numerics)
    return dt / n


def profile_steps(torch, sess, streams, numerics):
    """torch.profiler over 4 always-on steps: device busy share of the
    wall time and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in range(4):
            sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK]
                               ).votes.cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] no device time in the trace: not measured")
        return
    print(f"[profile] {numerics}, 4 steps: wall {wall_us / 4:.1f} us/step, "
          f"device busy "
          f"{busy / 4:.1f} us/step ({100 * busy / wall_us:.1f}% of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   {dev_us / 4:9.1f} us/step  x{count // 4:<3d} "
              f"{key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the always-on serving step")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.platform import resolve_device

    t_start = time.perf_counter()
    card = card_line(torch)
    dev = resolve_device(None)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {dev}")
    build_kernels()

    x, fex, params = make_inputs(torch, np)
    fex_res = compare_fex(torch, x, fex)
    gru_res = compare_gru(torch, fex_res["feats"], params)
    bundle = promote(params, fex)
    fex_int_res = compare_fex_int(torch, x, bundle)
    gru_int_res = compare_gru_int(torch, fex_int_res["feats"], bundle)
    times = time_kernels(torch, x, fex, gru_res)
    times.update(time_int_kernels(torch, x, gru_int_res, bundle))
    launches = serve_main_path(torch, "float32")
    launches.update(serve_main_path(torch, "int8"))
    check_against_cpu(torch, np, params)
    check_int8_against_cpu(torch, np, params)
    always_on(torch, np, params, card, args.profile, "float32")
    always_on(torch, np, params, card, args.profile, "int8")

    C = fex.coef.shape[1]
    H = params["w_h"].shape[0]
    kernels = []
    for name, kind, source, replaces, err in (
            ("batched_iir_fex", "fex", "src/repro_torch/csrc/iir_fex.cu",
             "src/repro/kernels/iir_fex.py:145", fex_res["max_abs_err"]),
            ("delta_gru_seq", "gru", "src/repro_torch/csrc/delta_gru_seq.cu",
             "src/repro/kernels/delta_gru_seq.py:101",
             gru_res["max_abs_err"]),
            ("batched_iir_fex_int", "fex_int",
             "src/repro_torch/csrc/iir_fex_int.cu",
             "src/repro/kernels/iir_fex.py:241",
             fex_int_res["max_abs_err"]),
            ("delta_gru_seq_int", "gru_int",
             "src/repro_torch/csrc/delta_gru_seq_int.cu",
             "src/repro/kernels/delta_gru_seq.py:245",
             gru_int_res["max_abs_err"])):
        ms, bnd, by = times[(kind, SLOTS)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": times[(kind + "_plain", SLOTS)], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "ms_b256": times[(kind, ALWAYS_ON_SLOTS)][0],
            "bound_ms_b256": times[(kind, ALWAYS_ON_SLOTS)][1],
            "shape": (f"B={SLOTS} S={CHUNK} C={C}" if kind.startswith("fex")
                      else f"T=32 B={SLOTS} I={C} H={H}")})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
