#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the run the README documents
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of the
                                     #   always-on serving step

Phases, each exiting non-zero on failure:
  1. the card's name and power limit; build both CUDA kernels with nvcc
     (in parallel) and print the build seconds and ptxas reports;
  2. hold each kernel against its plain PyTorch version on the card, at
     the serving shapes: FEx 12-bit codes exactly equal and raw envelopes
     within 1e-5 relative; ΔGRU hs within 1e-5 absolute at Δ_TH 0, 0.1
     and 0.2 (transmit-count mismatches are counted and printed);
  3. time each kernel and its plain version (CUDA events, warm-up,
     median) beside the bound worked out from the shapes;
  4. serve 64 one-second requests on 32 slots at the paper model's full
     width through ``repro_torch.launch.serve`` (launch counters zeroed
     just before, read just after; both kernels must have launched), and
     check a CUDA session against the CPU plain-version session on a
     small input; then a timed always-on phase, 256 slots × 16 chunks of
     4096 samples;
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
SLOTS, REQUESTS, CHUNK = 32, 64, 4096
ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS = 256, 16
THRESHOLDS = (0.0, 0.1, 0.2)
HS_ATOL = 1e-5                 # ΔGRU kernel vs plain, absolute
ENV_RTOL = 1e-5                # FEx raw envelope kernel vs plain, relative


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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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
    print(f"[build] both kernels built in {secs:.1f} s")
    # The wrapper's shared-memory formula must be the kernel's own.
    from repro_torch.kernels import delta_gru_seq as dgs
    lib = build.load("delta_gru_seq")
    lib.delta_gru_seq_smem_bytes.restype = ctypes.c_longlong
    for I, H in ((10, 64), (10, 16), (40, 100)):
        got = lib.delta_gru_seq_smem_bytes(I, H)
        if got != dgs.seq_kernel_smem_bytes(I, H):
            fail(f"shared-memory formula mismatch at I={I} H={H}: kernel "
                 f"{got}, wrapper {dgs.seq_kernel_smem_bytes(I, H)}")
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


def serve_main_path(torch):
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--mode", "kws-audio", "--slots", str(SLOTS), "--requests",
         str(REQUESTS), "--chunk-samples", str(CHUNK), "--seed", "0"])
    serve.validate_args(args)
    iir_fex.batched_iir_fex.launches = 0
    dgs.delta_gru_seq.launches = 0
    sess, done, labels, stats, dt = serve.serve_kws_audio(args)
    torch.cuda.synchronize()
    launches = {"batched_iir_fex": iir_fex.batched_iir_fex.launches,
                "delta_gru_seq": dgs.delta_gru_seq.launches}
    summ = sess.summary()
    print(f"[serve] {len(done)} requests on {SLOTS} slots, "
          f"{stats['steps']} steps in {dt:.2f} s (warm-up "
          f"{stats['warmup_s']:.2f} s), frames {summ.frames}, sparsity "
          f"{summ.sparsity:.4f}, launches {launches}")
    if min(launches.values()) < 1:
        fail(f"the serving path did not launch every kernel: {launches}")
    if summ.frames <= 0 or len(done) != REQUESTS:
        fail(f"serving produced {summ.frames} frames, {len(done)} decisions")
    if not all(0 <= p < sess.n_classes for _, p in done):
        fail("a decision is outside the class range")
    if sess.unhealthy_slots():
        fail(f"unhealthy slots after serving: {sess.unhealthy_slots()}")
    return launches


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


def always_on(torch, np, params, card, profile: bool):
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
    sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=B)
    warm_session(sess, CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(n):
        sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK]).votes.cpu()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summ = sess.summary()
    audio_s = B * n * CHUNK / 8000.0
    print(f"[always-on] {B} slots x {n} chunks of {CHUNK} samples: "
          f"{dt * 1e3 / n:.3f} ms per step, {summ.frames / dt:.0f} "
          f"decisions/s, {audio_s / dt:.1f}x realtime, sparsity "
          f"{summ.sparsity:.4f} (Δ_TH 0.1) [{card}]")
    if summ.frames != B * n * CHUNK // 128:
        fail(f"always-on phase counted {summ.frames} decisions")
    if profile:
        profile_steps(torch, sess, streams)
    return dt / n


def profile_steps(torch, sess, streams):
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
    print(f"[profile] 4 steps: wall {wall_us / 4:.1f} us/step, device busy "
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
    times = time_kernels(torch, x, fex, gru_res)
    launches = serve_main_path(torch)
    check_against_cpu(torch, np, params)
    always_on(torch, np, params, card, args.profile)

    C = fex.coef.shape[1]
    kernels = []
    for name, kind, source, replaces, err in (
            ("batched_iir_fex", "fex", "src/repro_torch/csrc/iir_fex.cu",
             "src/repro/kernels/iir_fex.py:145", fex_res["max_abs_err"]),
            ("delta_gru_seq", "gru", "src/repro_torch/csrc/delta_gru_seq.cu",
             "src/repro/kernels/delta_gru_seq.py:101",
             gru_res["max_abs_err"])):
        ms, bnd, by = times[(kind, SLOTS)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": times[(kind + "_plain", SLOTS)], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "shape": (f"B={SLOTS} S={CHUNK} C={C}" if kind == "fex" else
                      f"T=32 B={SLOTS} I={C} H={params['w_h'].shape[0]}")})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
