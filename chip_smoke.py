#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the run the README documents
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of the
                                     #   always-on serving step
    python3 chip_smoke.py --lm-mesh-only  # phase 13 alone (no build, no
                                          #   final line; 4 cards: its
                                          #   multi-rank half)
    python3 chip_smoke.py --dryrun-only   # phase 14 alone (no build, no
                                          #   final line)
    python3 chip_smoke.py --dryrun-table RECORDS [TRACE_DIR]
        # a dry-run campaign's records beside the reference's, as a
        # markdown table (reads JSON only: no card, no build)

Phases, each exiting non-zero on failure:
  1. the card's name and power limit; build all eight CUDA kernels, the
     four chain probes (iir_fex, iir_fex_int, delta_gru_seq,
     delta_gru_seq_int) and the FEx kernels' unroll instances (1, 2, 4,
     5, 8, 16, 25, 32, 64) with nvcc (one process per library, all
     started together) and print the build seconds and ptxas reports; check the
     wrappers' shared-memory formulas against the kernels' own (iir_fex,
     iir_fex_int, both ΔGRU kernels and delta_matvec launch with the
     wrappers' plans and refuse one they cannot run);
  2. hold each kernel against its plain PyTorch version on the card, at
     the serving shapes.  Float FEx: 12-bit codes, raw envelopes and
     registers bit for bit over two carried chunks at B = 32 and 256, and
     at ragged shapes and data (B = 1, 3, 33; T = 4096 + 37, 1000, an odd
     row stride, a base off 16-byte alignment; frame_shift 100; raw
     envelopes; registers decaying through the denormals; ±1 full-scale
     audio; a NaN sample, whose NaN positions and bits must match).
     Float ΔGRU: hs within 1e-5 absolute and the final state within 1e-5
     of 1 + |x| at Δ_TH 0, 0.1 and 0.2, transmit counts equal, and the
     same at its edge cases (B = 1, 3, 33; T = 1, 3, 100; Δ_TH -1, every
     row sent, and above every |Δ|, no row; random models at 3H not a
     multiple of 4 or of 32, I = 40 over two x warps, I > H, H = 128 and
     the widest H admitted at I = 10).  Integer: FEx feature codes
     and registers over two carried chunks, and at ragged shapes (B = 1,
     3, 33; T not a multiple of frame_shift or of 8; frame_shift 100;
     ±full-scale audio from registers at the 16-bit rails; one-bit b and
     a shifts, whose sums pass 2^31 in the offset form), and the ΔGRU's
     hs codes, final h/x̂/ĥ/m_x/m_h and both transmit counts at Δ_TH 0,
     0.1, 0.2, with accumulators started at the 24-bit rail, at B = 1, 3,
     33, T = 1, 3, 100, thresholds 0, -1 (every row) and above every |Δ|
     (no row), and at other widths with random weights (3H not a
     multiple of 4, I > H, H = 128, the widest H admitted at I = 10) —
     all exactly equal (tolerance 0).  delta_matvec: the
     reference's sweep shapes in float32 and bfloat16, the wide model's
     two shapes, and the CTA tile's tails (B = 1, 17, 255; O = 640;
     block_i = 10 and 64, each also with only the last block active)
     within 1e-5 relative to 1 + |out|, a masked block with non-zero
     deltas exactly 128, an all-zero mask exactly m.
     delta_gru_cell: the reference's three sweep shapes, the full width
     at B = 1, 3, 33, 32 and 256 and the float ΔGRU's edge widths, at
     Δ_TH 0, 0.1, 0.2, -1 and above every |Δ|, x̂/ĥ equal, h and M
     within 1e-5.  The block-sparse ΔGRU path at full width (forced,
     two carried chunks) against delta_gru_seq: hs and final state bit
     for bit, transmit counts equal.  NaN as the reference treats it: the
     float ΔGRU kernel on features with NaN rows against its plain
     version (NaN positions and bits equal, no NaN transmitted), and
     ``fp.to_code`` of NaN, -NaN and ±Inf audio on CUDA against the CPU
     (every code equal, NaN → 0);
  3. time each kernel on the device (20 calls captured in a CUDA graph,
     replayed between CUDA events, median) and per call with its
     wrapper's host time (CUDA events around each call, the method of
     the earlier slices), its plain version and, where one PyTorch call
     computes the same function, that call, beside the bound worked out
     from the shapes; for delta_matvec also its FMUL+FADD bound and its
     time by copy path (TMA, cp.async, plain loads); for both FEx
     kernels and both ΔGRU kernels their chain bounds (each chain probe's
     time per sample step × 4096, or per frame × 32; a ΔGRU's at the
     rows the run's busiest stream sends per frame, and beside it the
     densest frame's, every row sent); for delta_gru_cell its launch
     floor (an empty kernel and one dependent global round trip at its
     launch shape, by the same CUDA-graph method); and the previous
     kernels' times quoted from PERF.md (not measured in the run);
  4. serve 64 one-second requests on 32 slots at the paper model's full
     width through ``repro_torch.launch.serve``, once per numerics, and
     once at H=256, whose weights no thread block holds, through the
     block-sparse path (launch counters zeroed just before, read just
     after: each path's kernels must have launched as often as its steps
     need, the other kernels not at all); check a CUDA session against
     the CPU plain-version session on a small input in both numerics
     (int8: every code equal);
  5. detection: hold detect_head (softmax → EMA → hysteresis latch over a
     chunk) against its plain version — events, latch, refractory count
     and smoothed posteriors bit for bit — at B = 32 and 256 over two
     carried chunks of 32 frames, α 0.25 and 0.3, scalar and per-keyword
     thresholds, first_keyword 1 and 2; at B = 1, 3, 33 × F = 1, 3, 100;
     at 35 classes (XLA's sum in two windows); on a NaN logit row, ±1e30
     logits and thresholds that fire in most slots; check its
     shared-memory formula and that it refuses a plan it cannot run; time
     it beside its plain version, its bound and its launch floor (an
     empty kernel at its launch shape); serve ``--mode kws-detect`` on 32
     slots × 30 s streams once per numerics (launch counters zeroed just
     before, read just after: the numerics' FEx and ΔGRU kernels and
     detect_head once per step, nothing else; fires present); check a
     CUDA detect session against the CPU one in both numerics (int8:
     every code, event, gate and state equal; float: events, gates,
     votes and counts equal, logits within 1e-4);
  6. the two-stage wake cascade: hold both masked ΔGRU instantiations
     (the stage-1 scans) against their plain versions at T = 1, 32, 100 ×
     B = 1, 3, 33, 256 × six wake traces (awake and asleep everywhere,
     random at duty 0.1, 0.5 and 0.9, first and last frames asleep) from
     a carried state and over two carried chunks — the int8 one bit for
     bit, the float one within 1e-5 and bit for bit against the unmasked
     kernel when awake everywhere, frozen rows and the state of slots
     asleep throughout bit for bit — and both ΔGRU kernels at stage 0's
     width (I = 4, H = 16); time the masked kernels by the trace's duty
     beside the unmasked ones; hold wake_head (stage 0's softmax, then
     the wake machine) bit for bit against its plain version and time it
     beside its launch floor; serve ``--mode kws-cascade`` on 32 slots ×
     30 s streams once per numerics (the numerics' FEx kernel, its ΔGRU
     kernel, wake_head, its masked instantiation and detect_head once per
     step, nothing else); check a CUDA cascade session against the CPU
     one in both numerics (int8: every code, awake bit, event and state
     equal; float: awake traces, events, gates, votes and counts equal,
     logits within 1e-4, the CPU's stage-0 scores more than 1e-4 from
     both thresholds);
  7. a timed always-on phase in each numerics, 256 slots × 16 chunks of
     4096 samples, each followed by the same in detect mode (continuous
     streams, VAD on) with its kernel launches per step and its step
     time beside the plain step's, then through the cascade beside the
     detect step (three alternating rounds on the same audio each) and
     the masked kernel on one step's own inputs at the run's duty
     (``--profile``: device busy share and device activities per step);
     then ``event_driven=True`` on a detect step's VAD-held ΔGRU input
     in each numerics, bit for bit the dense scan (int8 must skip slots);
  8. fault handling, overload and the pipelined engine: a CUDA session
     against the CPU session under ``adversarial_plan(7)`` (4 slots × 24
     steps of 512 samples, supervisor on, input policy trust) in both
     numerics, every vote, health mask, recovery and reason equal;
     ``set_threshold`` mid-stream (0.1 → 0.4 → 0.1) against the CPU in a
     plain and a cascade session, the cascade's wake trace equal to that
     of a session never switched; ``set_sync_debug_mode("error")`` around
     ``process_audio`` and ``reset_streams`` of unsupervised plain,
     detect and cascade sessions (no synchronisation); the reference's
     soak at full width (256 slots × 4096 samples, 2 chunks per
     utterance, adversarial_plan(7), 4 + 60 + 24 steps, bursty arrival
     waves, ladder 0.1 / 0.4, queue 512) in both numerics at depth 1 and
     2, every gate of ``BENCH_soak.json`` true and depth 2 equal to depth
     1 in every vote, controller level and recovery; ``serve --faults``
     in-process (kws-audio, kws-detect, kws-cascade × both numerics ×
     depth 1 and 2), counts zeroed before each run: decisions or fires
     equal between the depths, one launch of each path kernel per piece
     with a whole frame; the always-on plain step through the engine at
     depth 1 and 2, without and with the supervisor, five alternating
     rounds after an untimed one (``--profile``: device busy share),
     times not gated;
  9. training on the card: the gradients of ``kws.loss_fn`` and
     ``kws.frame_loss_fn`` at full width (I = 10, H = 64, K = 12, 62
     frames, B = 8, Δ_TH 0.1), float and QAT, on the card against the CPU
     (transmit counts equal, losses within 1e-6, gradients within 5e-6 ×
     max|g| per leaf); ``launch.train --arch deltakws`` in-process at
     B = 64 for 16 steps (QAT, --promote; counts zeroed just before and
     read just after: ``batched_iir_fex`` once per training batch + once
     for the evaluation, ``delta_gru_seq`` and ``delta_gru_seq_int`` once
     each for the float and int8 evaluation; the loss finite and falling;
     float and int8 eval accuracy and ms per step printed); ms per step
     of the four step kinds (utterance B = 64 and frame-level B = 32 × 2 s,
     float and QAT), device activities per step (torch.profiler) and the
     device's busy share of two (utterance QAT, frame-level float); a
     Trainer whose step 3 raises resumes from its checkpoint to the
     unfaulted run's params and moments bit for bit;
     the promoted bundle loads back code for code and serves 64 requests
     through the int8 kernels (once per step); ``serve --train-steps 2``
     for kws-detect and kws-cascade in both numerics (the float FEx
     kernel once per training batch of each stage, the serving path's
     kernels once per step as in phases 5–6; fires and stage-1 duty
     printed, not gated);
  10. kernel autotuning (``kernels/autotune.py``) at the always-on shapes
     (B = 256; S = 4096, C = 10; T = 32, I = 10, H = 64, Δ_TH 0.1) in
     both numerics: the greedy sweep of each of the four serving kernels
     (unroll or block_t, then block_b; the median of 20 calls each,
     CUDA events around the whole wrapper call), default and best µs
     printed with the card line and the winners recorded in the run's
     own cache (REPRO_AUTOTUNE_CACHE points at a temporary file from the
     start, so no cache of the machine changes a phase's launches); every
     configuration the tuner can reach (each axis's candidates, the float
     FEx's block_b = 1 and unrolls 32 to 128 included, and the sweep's)
     bit for bit against the default launch on serving data from a
     carried state (outputs, state, counts), and both FEx kernels at
     frame_shift 100 with unrolls 5, 25, 50 and 100; illegal knobs raise the reference's ValueError naming the
     kernel; 256-slot sessions that pick the winners up, and a forced
     configuration (every knob off its default), against a session with
     autotuning off over 4 steps: the report lists what was recorded,
     each kernel launches B / block_b times a step, and votes, logits and
     counts are equal bit for bit; the three examples at small flags;
  11. the LM stacks (eager PyTorch; no kernel of the port on their path,
     every launch count stays 0): the ten ARCH_IDS at smoke width in
     float32 on the card against the same weights on the CPU (loss,
     prefill and one decode step's logits within 1e-4 of max|·|), then
     their bf16 configs on the card (finite); qwen2-0.5b, mamba2-370m
     and granite-moe-3b-a800m at full width with the port's seeded init:
     the parameter count equal to the cost model's (plus the q/k/v
     biases, which it leaves out), 4 prompts × 128 tokens
     prefilled and 32 greedy tokens decoded (ms, tokens/s, device
     activities and busy share of a decode step, peak memory, FLOP/s from
     ``launch/costmodel.py``), prefill-then-decode against the longer
     prefill at the reference's rtol = atol = 0.15 on the first 4 of the
     full-width layers in float32 (the MoE at the reference's capacity
     1.25, where the two part by design: its gap held to the CPU's on the
     same weights, at the same tolerance; bf16 and the full depth printed
     beside a chaos probe at 4, 8 and all layers: the float32 logits
     after the embedding is scaled by 1 + 1e-6, and layer 0's attention
     score std), mamba2's Δ decode at Δ_TH 0
     against the dense one (float32, 1e-3 of max|·|); ``serve --mode lm --arch qwen2-0.5b --requests 8
     --slots 4``, ``train --arch qwen2-0.5b --full-config --steps 4
     --batch 8 --seq 128`` and its resume from the checkpoint, and 12
     AdamW steps lowering the smoke loss on one batch;
  12. the slot mesh: cuBLAS's float FC over each shard's streams against
     the same rows of the whole batch (the cases whose bits differ,
     printed) and ``streaming._fc``, which sums in one fixed order (none
     may differ); two shards on the one card (``SlotMesh.on("cuda",
     2)``), each on its own CUDA stream, in plain, detect and cascade
     mode and both numerics, 32 slots × 4 chunks of 4096 samples of
     keyword streams with a reset of one slot per shard between chunks,
     against the unsharded CUDA session: every output (logits by their
     bits), state and summary equal; counts zeroed just before the
     sharded run and read just after: each path kernel once per shard
     per step, the others never; two-shard CUDA sessions against
     two-shard CPU sessions in every mode (4 streams × 2048 samples,
     three unaligned chunks, a reset per shard: int8 every code equal,
     float the same but floats within 1e-4); ``set_sync_debug_mode
     ("error")`` around ``process_audio`` and ``reset_streams`` of
     unsupervised sharded plain, detect and cascade sessions; the
     always-on plain step at 256 slots, unsharded against two shards, 5
     alternating rounds of 16 chunks on the same audio in both numerics
     (outputs equal bit for bit; ``--profile``: device activities and
     busy share); ``serve --mode kws-audio --devices 2`` raising the
     "visible" error on a one-card machine (with more cards, the checks
     and the timing again on ``make_slot_mesh(min(count, 4))``, and
     ``serve --devices`` over those cards against ``--devices 1``);
  13. the LM mesh (DTensor on a DeviceMesh, one process per rank; no
     kernel of the port on its path, every launch count stays 0): a
     world-1 NCCL group and ``make_host_mesh(model=1)`` on qwen2-0.5b at
     full width (bf16, B = 8 × 128): 2 AdamW steps and 8 greedy tokens
     with DTensor params against the same without a mesh, bit for bit
     (params, moments, losses, tokens, logits), and a save →
     ``restore(shardings=)`` round trip; ms per step of both.  With ≥ 2
     cards, min(count, 4) NCCL ranks on ``(n/2, 2)``: 3 AdamW steps at
     full width against one card without a mesh at the reference's
     bounds (loss within 0.05, ≥ 97 % of the first leaf within 0.05) and
     in float32 on the first 4 layers (lr 1e-4) within 1e-4, prefill + 32
     greedy tokens under ``DECODE_RULES`` (float32 logits of the prefill
     and 4 steps within 1e-4 of max|·|; the KV cache must be split on its
     sequence over 'model', so each decode step combines the ranks'
     softmax partials over NCCL), the elastic restore ``(n, 1)`` →
     ``(n/2, 2)``, a float32 loss on ``(1, n)`` (14 heads and 2 KV heads
     replicated at model = 4); train and decode ms sharded and on one
     card, collectives per step (``CommDebugMode``) and peak memory per
     rank; with one card it prints that this half needs ≥ 2;
  14. the LM dry-run (``repro_torch.launch.dryrun.run_cell`` on the
     card): one full-size cell per family (DRYRUN_CELLS), each traced on
     fake tensors on the 256- and 512-rank production meshes, one process
     per cell, all started together; a line per record with the card
     line, and a line holding it against the reference's record of the
     cell (``tests/fixtures/reference_dryrun.json``, written by the JAX
     package's own dry-run and read as JSON): peak GB a rank and
     collective GB of both, with their ratios, and where the port's peak
     was reached; the run fails unless every record is ``ok`` with its
     memory, FLOPs and collectives filled, no kernel launches, the three
     ``decode_32k`` cells move at most 2× the reference's collective
     bytes, no record moves more than the larger of 2× the reference's and
     its bytes before the sequence-split cache was attended in place
     (DRYRUN_BEFORE_GB), and zamba2-2.7b ``prefill_32k`` fits the card at
     no more than a quarter of its earlier peak without an all-gather in
     ``_split_proj`` / ``_split_xbc``;
  15. the ``kernels`` JSON line (the eight kernels and the two masked
     instantiations; the four tuned ones with their sweep; each with its
     launches in phase 12's two-shard run, ``launches_slot_mesh``, on
     phase 13's path, ``launches_lm_mesh``, and in phase 14,
     ``launches_dryrun``), the card line, and the final
     ``{"ok": true, ...}`` line.

Needs one CUDA GPU and nvcc; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
SAT_MARGIN = 1 << 10           # int ΔGRU saturation case: start this close
MATVEC_TOL = 1e-5              # delta_matvec vs plain, times (1 + |out|)
WIDE_H = 256                   # a ΔGRU width no thread block holds
# The device times of the kernels that the current iir_fex, iir_fex_int,
# both ΔGRU kernels, delta_matvec and delta_gru_cell replaced, on an H100
# 80GB HBM3 at 700 W, quoted from PERF.md §6 beside this run's.
PREVIOUS_MS = {("fex_int", 32): 0.1904, ("fex_int", 256): 0.1914,
               ("matvec", 256): 0.0327, ("matvec", 10): 0.0043,
               ("fex", 32): 0.1776, ("fex", 256): 0.1807,
               ("gru_int", 32): 0.0550, ("gru_int", 256): 0.0580,
               ("gru", 32): 0.0527, ("gru", 256): 0.0550,
               ("cell", 32): 0.0077, ("cell", 256): 0.0080}
CHAIN_STEPS = 1 << 20          # FEx chain probes: steps timed
CHAIN_FRAMES = 32              # ΔGRU chain probes: frames timed (a chunk)
PROBES = ("iir_fex_chain", "iir_fex_int_chain", "delta_gru_seq_chain",
          "delta_gru_seq_int_chain")
EDGE_TH = (-1.0, 1e9)          # every row sent; above every |Δ|, no row


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


def max_sm_clock_hz(torch) -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), for bounds
    counted in instructions per clock."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        fail("nvidia-smi did not report clocks.max.sm")


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


def graph_ms(torch, fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device milliseconds of one ``fn()``: ``per_graph`` calls captured
    in one CUDA graph, the graph replayed ``reps`` times between CUDA
    events (median), so the wrapper's Python time, which the per-call
    events of ``cuda_ms`` include for a short kernel, is not counted."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    for _ in range(3):
        g.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    med = statistics.median(times)
    print(f"[time]   graph: median {med:.4f} ms per call ({per_graph} calls "
          f"per replay, {reps} replays; min {min(times):.4f})")
    return med


def kernel_ms(torch, fn) -> tuple[float, float]:
    """(device ms from a CUDA graph, ms per call between CUDA events)."""
    return graph_ms(torch, fn), cuda_ms(torch, fn, 50)


# ------------------------------------------------------------ bounds --
FEX_OPS_PER_SAMPLE = 18        # 2 biquads (7 each) + envelope (4)
# Operation counts follow XLA's expansions (kernels/xla_math.py), an FMA
# counted as two operations: log2 ≈ 40, then normalise, clamp, round,
# clamp; σ ≈ 30 each (exp: 9 FMAs, floor, clamps, 2^n), tanh ≈ 30 (10
# FMAs, a division), the pre-activation adds and the blend 6.
FEX_OPS_PER_FRAME = 48
GATE_OPS_PER_UNIT = 96


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


def matvec_bound(B, I, O, active_rows, n_blocks):
    """delta_matvec: Δx, the weight rows of the active blocks, m in, out
    and the mask; a multiply-add per active row, column and batch row."""
    moved = 4 * (B * I + active_rows * O + 2 * B * O + n_blocks)
    return bound(moved, 2 * B * active_rows * O)


def matvec_fmul_fadd_ms(torch, B, O, active_rows):
    """The same products under the kernel's numerics contract: each
    product rounded before its add, so an FMUL and an FADD (not one FFMA)
    per multiply-add, issued 128 lanes per SM per clock at the card's
    highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instr = 2 * B * active_rows * O
    return instr / (sms * 128 * max_sm_clock_hz(torch)) * 1e3


def fex_int_chain_bound(torch, bundle, steps: int = CHUNK):
    """The integer FEx's chain bound: csrc/iir_fex_int_chain.cu runs the
    kernel's section step CHAIN_STEPS times on one warp (register
    operands, nothing else on the SM) with channel 0's coefficient codes;
    its time per step is the recursion's latency, and ``steps`` of them
    the least time a chunk of ``steps`` samples can take.  Returns
    (cycles per step, ms for ``steps`` steps)."""
    from repro_torch.kernels import build
    fn = build.load("iir_fex_int_chain").iir_fex_int_chain
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    coef = bundle.coef.cpu()
    out = (ctypes.c_longlong * 3)()
    err = fn(CHAIN_STEPS, int(coef[1, 0]), int(coef[2, 0]),
             bundle.ffmt.a_frac, out)
    if err:
        fail(f"iir_fex_int chain probe: CUDA error {err}")
    cycles = out[0] / CHAIN_STEPS
    ns = out[1] / CHAIN_STEPS
    print(f"[time] iir_fex_int chain probe: {cycles:.2f} cycles, {ns:.3f} ns "
          f"per sample step ({out[0] / out[1]:.3f} GHz), {steps} steps = "
          f"{ns * steps / 1e6:.5f} ms")
    return cycles, ns * steps / 1e6


def fex_chain_bound(torch, coef, steps: int = CHUNK):
    """The float FEx's chain bound: csrc/iir_fex_chain.cu runs the
    kernel's section step CHAIN_STEPS times on one warp (register
    operands, nothing else on the SM) with channel 0's section-0
    coefficients; its time per step is the recursion's latency, and
    ``steps`` of them the least time a chunk of ``steps`` samples can
    take.  Returns (cycles per step, ms for ``steps`` steps)."""
    from repro_torch.kernels import build
    fn = build.load("iir_fex_chain").iir_fex_chain
    fn.argtypes = [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    c = coef.cpu()
    out = (ctypes.c_longlong * 2)()
    err = fn(CHAIN_STEPS, float(c[0, 0]), float(c[1, 0]), float(c[2, 0]),
             out)
    if err:
        fail(f"iir_fex chain probe: CUDA error {err}")
    cycles, ns = out[0] / CHAIN_STEPS, out[1] / CHAIN_STEPS
    print(f"[time] iir_fex chain probe: {cycles:.2f} cycles, {ns:.3f} ns per "
          f"sample step ({out[0] / out[1]:.3f} GHz), {steps} steps = "
          f"{ns * steps / 1e6:.5f} ms")
    return cycles, ns * steps / 1e6


def gru_int_chain_bound(torch, gfmt, rows=(10, 64),
                        frames: int = CHAIN_FRAMES):
    """The integer ΔGRU's chain bound: csrc/delta_gru_seq_int_chain.cu runs
    the kernel's per-frame critical path (Δ-encode, a column's sum over
    the transmitted rows split over four lanes and recombined, alignment,
    σ(r), the candidate, tanh, the blend) ``frames`` times on one warp with
    the serving formats and ``rows`` = (x rows, h rows) sent per frame:
    every one of the 74 by default, the densest frame; the least of five
    runs (the first fills the instruction cache).  Returns (cycles per
    frame, ms for ``frames`` frames)."""
    from repro_torch.kernels import build
    fn = build.load("delta_gru_seq_int_chain").delta_gru_seq_int_chain
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    runs = []
    for _ in range(5):
        out = (ctypes.c_longlong * 2)()
        err = fn(frames, *rows, gfmt.shift_x, gfmt.shift_h, gfmt.acc_bits,
                 gfmt.acc_frac, gfmt.hid_frac, out)
        if err:
            fail(f"delta_gru_seq_int chain probe: CUDA error {err}")
        runs.append((out[0], out[1]))
    cyc, ns = min(runs)
    print(f"[time] delta_gru_seq_int chain probe, {rows[0]} x + {rows[1]} h "
          f"rows per frame: {cyc / frames:.1f} cycles, {ns / frames:.1f} ns "
          f"per frame ({cyc / ns:.3f} GHz), {frames} frames = "
          f"{ns / 1e6:.5f} ms (runs: {', '.join(str(c) for c, _ in runs)} "
          f"cycles)")
    return cyc / frames, ns / 1e6


def gru_chain_bound(torch, rows=(10, 64), frames: int = CHAIN_FRAMES):
    """The float ΔGRU's chain bound: csrc/delta_gru_seq_chain.cu runs the
    kernel's per-frame critical path (Δ-encode and compaction, a column's
    sum over the transmitted rows, σ(r), σ(u), the candidate, tanh, the
    blend) ``frames`` times on one warp with ``rows`` = (x rows, h rows)
    sent per frame: every one of the 74 by default, the densest frame;
    the least of five runs (the first fills the instruction cache).
    Returns (cycles per frame, ms for ``frames`` frames)."""
    from repro_torch.kernels import build
    fn = build.load("delta_gru_seq_chain").delta_gru_seq_chain
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    runs = []
    for _ in range(5):
        out = (ctypes.c_longlong * 2)()
        err = fn(frames, *rows, out)
        if err:
            fail(f"delta_gru_seq chain probe: CUDA error {err}")
        runs.append((out[0], out[1]))
    cyc, ns = min(runs)
    print(f"[time] delta_gru_seq chain probe, {rows[0]} x + {rows[1]} h "
          f"rows per frame: {cyc / frames:.1f} cycles, {ns / frames:.1f} ns "
          f"per frame ({cyc / ns:.3f} GHz), {frames} frames = "
          f"{ns / 1e6:.5f} ms (runs: {', '.join(str(c) for c, _ in runs)} "
          f"cycles)")
    return cyc / frames, ns / 1e6


def busiest_rows(nzx, nzh, T):
    """The rows the busiest stream sends per frame (x, h), rounded up."""
    return tuple(-(-int(n.sum(0).max().item()) // T) for n in (nzx, nzh))


def cell_launch_floor(torch, B, H):
    """delta_gru_cell's launch floor at its launch shape (B CTAs of 3H
    rounded up to a warp): the device ms of an empty kernel and of one
    whose threads each make one dependent global round trip (a load, then
    a store of what it read plus one), by the CUDA-graph method."""
    from repro_torch.kernels import build
    lib = build.load("delta_gru_cell")
    fn = lib.delta_gru_cell_floor_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    buf = torch.zeros(B * -(-3 * H // 32) * 32, device="cuda")
    res = []
    for dependent in (0, 1):
        def launch(dependent=dependent):
            build.check(lib, fn(buf.data_ptr(), dependent, B, H,
                                torch.cuda.current_stream().cuda_stream),
                        "delta_gru_cell floor launch")
        res.append(graph_ms(torch, launch))
    return tuple(res)


def cell_bound(B, I, H, nz_total):
    """delta_gru_cell: x, h, x̂, ĥ, M_x, M_h in and out (x once), the
    weights once; the transmitted rows' multiply-adds and the gates."""
    N = 3 * H
    moved = 4 * (B * I + 2 * B * (H + I + H + 2 * N) + (I + H) * N)
    flops = 2 * N * nz_total + B * (3 * (I + H) + GATE_OPS_PER_UNIT * H)
    return bound(moved, flops)


# ------------------------------------------------------------- phases --
# The FEx kernels' unroll instances, one library each, built with the
# others: the tuner's candidates at frame_shift 128 (the divisors up to
# 16), the larger legal ones (64 and above share the fully unrolled
# tile), and 5 and 25, which divide frame_shift 100 but not the 64-sample
# tile (their loops end in a remainder).
UNROLLS = (1, 2, 4, 5, 8, 16, 25, 32, 64)


def build_kernels():
    from repro_torch.kernels import build
    from repro_torch.kernels.iir_fex import library
    instances = [library(name, u) for name in ("iir_fex", "iir_fex_int")
                 for u in UNROLLS]
    t0 = time.perf_counter()
    built = build.build((*build.KERNELS, *PROBES, *instances))
    secs = time.perf_counter() - t0
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}")
    for name, b in built.items():
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "smem" in ln]
        print(f"[build] {name}: {b.path.name} ({b.seconds:.1f} s) "
              f"{' | '.join(regs)}")
    print(f"[build] {len(built)} libraries (eight kernels, four chain "
          f"probes and {len(instances)} FEx unroll instances) built in "
          f"{secs:.1f} s")
    if not set(build.KERNELS) <= set(built) or len(build.KERNELS) != 8:
        fail(f"expected the eight kernels {build.KERNELS}, built "
             f"{sorted(built)}")
    # The wrappers' shared-memory formulas must be the kernels' own.
    from repro_torch.kernels import delta_gru_cell as dgc
    from repro_torch.kernels import delta_gru_seq as dgs
    for name, formula in (("delta_gru_seq", dgs.seq_kernel_smem_bytes),
                          ("delta_gru_seq_int",
                           dgs.int_seq_kernel_smem_bytes),
                          ("delta_gru_cell", dgc.cell_kernel_smem_bytes)):
        fn = getattr(build.load(name), f"{name}_smem_bytes")
        fn.restype = ctypes.c_longlong
        for I, H in ((10, 64), (10, 16), (40, 100), (7, 5), (40, 128),
                     (10, 132), (96, 32)):
            if fn(I, H) != formula(I, H):
                fail(f"{name} shared-memory formula mismatch at I={I} "
                     f"H={H}: kernel {fn(I, H)}, wrapper {formula(I, H)}")
    return secs


def keyword_audio(torch, np, B, seed):
    """12-bit keyword audio for B streams, two 4096-sample chunks each."""
    from repro_torch.core.quantize import quantize_audio_12b
    from repro_torch.data.gscd import synth_batch
    audio, _ = synth_batch(np.random.default_rng(seed), B)
    audio = np.concatenate([audio, audio[::-1]], axis=1)[:, :2 * CHUNK]
    return quantize_audio_12b(torch.from_numpy(audio).cuda())


def make_inputs(torch, np):
    """Serving-shaped inputs: 12-bit keyword audio for SLOTS streams (two
    4096-sample chunks each), the FEx bank, the full-width model."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.models import kws
    x = keyword_audio(torch, np, SLOTS, 0)
    fex = FeatureExtractor()
    params = kws.init_kws(torch.Generator().manual_seed(0), CONFIG,
                          input_dim=fex.cfg.n_active)
    return x, fex, params


def bits_differ(torch, a, b) -> int:
    """Elements of two float32 tensors whose bit patterns differ (a NaN
    equals only a NaN with the same bits)."""
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def compare_fex(torch, x, fex):
    """The float FEx kernel against its plain version over two chunks
    with the state carried, compressed and raw: every bit equal."""
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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fp, sp = iir_fex.batched_iir_fex_ref(xc, coef, sp,
                                                 compress=compress, **kw)
            torch.cuda.synchronize()
            if compress and half == 1:   # the plain version's time, warm
                res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            fk_all.append(fk)
            fp_all.append(fp)
        torch.cuda.synchronize()
        fk, fp = torch.cat(fk_all, 1), torch.cat(fp_all, 1)
        mism, st_mism = bits_differ(torch, fk, fp), bits_differ(torch, sk, sp)
        err = (fk - fp).abs().max().item()
        print(f"[compare] iir_fex compress={compress} B={x.shape[0]} "
              f"S=2x{CHUNK} C={coef.shape[1]}: {mism} of {fk.numel()} "
              f"{'12-bit codes' if compress else 'raw envelopes'} and "
              f"{st_mism} of {sk.numel()} registers differ in any bit "
              f"(tolerance 0), max abs err {err:.3g}")
        if mism or st_mism:
            fail(f"iir_fex compress={compress}: {mism} outputs and "
                 f"{st_mism} registers differ from the plain version")
        if compress:
            res["max_abs_err"] = err
            res["feats"] = fk
    return res


def compare_fex_edges(torch, np, fex):
    """The float FEx kernel against its plain version where the launch
    plan or the data is unusual, every bit equal (tolerance 0; a NaN
    equals only a NaN with the same bits): stream groups that do not fill
    a CTA (B = 1, 3, 33); rows whose length or start is not a multiple
    of 4 samples (the audio then comes sample by sample: T = 4096 + 37,
    an odd row stride, a base 4 bytes off 16-byte alignment); T = 1000; a
    frame_shift that splits the kernel's tiles; raw envelopes; registers
    seeded near 1e-36 decaying in silence through the denormals, which
    flush; ±1 full-scale audio; one stream with a NaN sample."""
    from repro_torch.kernels import iir_fex
    cfg = fex.cfg
    coef = fex.coef.cuda()
    C = coef.shape[1]
    rng = np.random.default_rng(41)
    speech = keyword_audio(torch, np, 33, 5)[:, :CHUNK + 64]
    zero = lambda B: iir_fex.init_fex_kernel_state(B, C, "cuda")
    gpu = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    misaligned = torch.empty(5 * 1000 + 1, device="cuda")[1:].view(5, 1000)
    misaligned.copy_(speech[:5, 2000:3000])
    tiny = 1e-36 * rng.standard_normal((3, 5, C))
    tiny[:, 4] = np.abs(tiny[:, 4])
    nan = speech[:3, :1000].clone()
    nan[1, 517] = float("nan")
    full = gpu(np.where(rng.random((4, 1000)) < 0.5, 1.0, -1.0))
    cases = [("B=1", speech[:1, :CHUNK], zero(1), 128, True),
             ("B=3 T=4096+37", speech[:3, :CHUNK + 37], zero(3), 128, True),
             ("B=3 T=4096+37 raw", speech[:3, :CHUNK + 37], zero(3), 128,
              False),
             ("B=33 T=1000", speech[:, 3000:4000], zero(33), 128, True),
             ("B=5 T=1001 (odd row stride)", speech[:5, :1001], zero(5), 128,
              True),
             ("B=5 T=1000 base 4 bytes off", misaligned, zero(5), 128, True),
             ("B=5 frame_shift=100", speech[:5, :1000], zero(5), 100, True),
             ("B=3 denormal decay in silence", gpu(np.zeros((3, 1024))),
              gpu(tiny), 128, False),
             ("B=4 full-scale ±1", full, zero(4), 128, True),
             ("B=3 NaN sample in stream 1", nan, zero(3), 128, True),
             ("B=3 NaN sample in stream 1 raw", nan, zero(3), 128, False)]
    for label, x, st, fs, compress in cases:
        if label.endswith("base 4 bytes off"):
            if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                fail("the misaligned FEx case is aligned or not contiguous")
        else:
            x = x.contiguous()
        kw = dict(frame_shift=fs, env_alpha=cfg.env_alpha,
                  log_eps=cfg.log_eps, compress=compress)
        fk, sk = iir_fex.batched_iir_fex(x, coef, st, **kw)
        fr, sr = iir_fex.batched_iir_fex_ref(x, coef, st, **kw)
        torch.cuda.synchronize()
        mism = bits_differ(torch, fk, fr) + bits_differ(torch, sk, sr)
        nan_pos = int((torch.isnan(fk) != torch.isnan(fr)).sum()
                      + (torch.isnan(sk) != torch.isnan(sr)).sum())
        zeros = int((sr == 0).sum())
        print(f"[compare] iir_fex {label}: {mism} of {fk.numel()} "
              f"{'codes' if compress else 'envelopes'} and {sk.numel()} "
              f"registers differ in any bit (tolerance 0); NaN positions "
              f"differ at {nan_pos}; NaN outputs {int(torch.isnan(fr).sum())}"
              f", registers exactly 0 after: {zeros}")
        if mism or nan_pos:
            fail(f"iir_fex {label} differs from its plain version")
        if label.startswith("B=3 denormal") and zeros <= sr.numel() // 2:
            fail("the denormal case did not flush the registers to 0")
        if label.startswith("B=3 NaN") and not torch.isnan(fr[1]).any():
            fail("the NaN case produced no NaN")


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
            "xs_all": xs, "gru": gru}


def random_gru(torch, np, rng, I, H, B, T):
    """A float ΔGRU with random weights and bias, and B streams of T
    frames of a random walk that moves 40 % of its components a frame."""
    from repro_torch.core import delta_gru as dg
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    steps = 0.2 * rng.standard_normal((T, B, I)) * (rng.random((T, B, I))
                                                    < 0.4)
    return (dg.DeltaGRUParams(
        cuda(rng.standard_normal((I, 3 * H)) / np.sqrt(I)),
        cuda(rng.standard_normal((H, 3 * H)) / np.sqrt(H)),
        cuda(0.1 * rng.standard_normal(3 * H))), cuda(np.cumsum(steps, 0)))


def compare_gru_edges(torch, np, gru_res):
    """The float ΔGRU kernel against its plain version where the launch or
    the data is unusual, hs within 1e-5 absolute, the final state within
    1e-5 of 1 + |x|, transmit counts equal: stream counts that are not
    the serving batch (B = 1, 3, 33), chunks of T = 1, 3 and 100 frames
    (x is loaded a frame ahead: none after the first, the last frame's,
    a long chunk), Δ_TH -1 (every row sent, zero deltas too) and above
    every |Δ| (nothing sent), and random models
    at other widths: 3H not a multiple of 4 (weights staged 4 bytes at a
    time) or of 32 (H = 20), I = 40 (x encoders in two warps, I > H),
    I = 96 > H = 32, H = 128 and the widest H that check_kernel_fits
    admits at I = 10."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.kernels import delta_gru_seq as dgs
    gru, xs_all = gru_res["gru"], gru_res["xs_all"]     # (2T, B, 10)
    rng = np.random.default_rng(47)
    serve = lambda T, B: xs_all[:T, :B] if B <= xs_all.shape[1] else \
        torch.cat([xs_all[:T]] * -(-B // xs_all.shape[1]), 1)[:, :B]
    long_xs = torch.cat([xs_all, xs_all.flip(0)])[:100]
    cases = [("B=1", gru, serve(32, 1), 0.1),
             ("B=3", gru, serve(32, 3), 0.1),
             ("B=33", gru, serve(32, 33), 0.1),
             ("T=1", gru, serve(1, 32), 0.1),
             ("T=3", gru, serve(3, 32), 0.1),
             ("T=100", gru, long_xs, 0.1),
             ("Δ_TH=-1 (every row sent)", gru, serve(32, 32), EDGE_TH[0]),
             ("Δ_TH above every |Δ| (nothing sent)", gru, serve(32, 32),
              EDGE_TH[1])]
    for I, H, B, T in ((7, 5, 3, 32), (10, 20, 3, 32), (40, 20, 5, 32),
                       (96, 32, 4, 40), (16, 128, 33, 32),
                       (10, widest_h(10, dgs.check_kernel_fits), 3, 32)):
        g, xr = random_gru(torch, np, rng, I, H, B, T)
        cases.append((f"I={I} H={H} B={B} T={T} random", g, xr, 0.1))
        if (I, H) == (40, 20):
            cases += [(f"I={I} H={H} random Δ_TH={th}", g, xr, th)
                      for th in EDGE_TH]
    for label, g, xs, th in cases:
        xs = xs.contiguous()
        T, B, I = xs.shape
        H = g.w_h.shape[0]
        st = tuple(dg.init_delta_state(B, I, H, g))
        hk, sk, nxk, nhk = dgs.delta_gru_seq(xs, *st, g.w_x, g.w_h, th)
        hp, sp, nxp, nhp = dgs.delta_gru_seq_ref(xs, *st, g.w_x, g.w_h, th)
        torch.cuda.synchronize()
        hs_err = (hk - hp).abs().max().item()
        st_err = max(((a - r).abs() / (1.0 + r.abs())).max().item()
                     for a, r in zip(sk, sp))
        nz_m = int((nxk != nxp).sum() + (nhk != nhp).sum())
        sent = int(nxp.sum() + nhp.sum())
        print(f"[compare] delta_gru_seq {label} (Δ_TH {th}): T={T} B={B} "
              f"I={I} H={H}, hs max abs diff {hs_err:.3g}, state {st_err:.3g}"
              f" (bound {HS_ATOL}), nz mismatches {nz_m}; transmitted "
              f"{sent} of {T * B * (I + H)}")
        if not (hs_err <= HS_ATOL and st_err <= HS_ATOL) or nz_m:
            fail(f"delta_gru_seq {label}: hs {hs_err}, state {st_err}, nz "
                 f"{nz_m}")
        if th == EDGE_TH[0] and sent != T * B * (I + H):
            fail(f"delta_gru_seq {label}: Δ_TH -1 did not send every row")
        if th == EDGE_TH[1] and sent:
            fail(f"delta_gru_seq {label}: a threshold above every |Δ| sent "
                 f"rows")


def time_kernels(torch, x, fex, gru_res, fex_plain_ms):
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
        ms, call = kernel_ms(torch, lambda: iir_fex.batched_iir_fex(
            xb, coef, st, **kw))
        out[("fex", B)] = (ms, *fex_bound(B, CHUNK, C), call)
    out[("fex_plain", SLOTS)] = fex_plain_ms
    out["fex_chain"] = fex_chain_bound(torch, coef)

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
        ms, call = kernel_ms(torch, lambda: dgs.delta_gru_seq(*args))
        out[("gru", B)] = (ms, *gru_bound(T, B, I, H, nz_total), call)
        if B == SLOTS:
            data_rows = busiest_rows(nzx, nzh, T)
            out[("gru_plain", SLOTS)] = cuda_ms(
                torch, lambda: dgs.delta_gru_seq_ref(*args), 10, warmup=2)
    out["gru_chain"] = (*gru_chain_bound(torch, data_rows), data_rows)
    out["gru_chain_every_row"] = gru_chain_bound(torch)
    print_times(out, (("fex", CHUNK, "dependent samples"),
                      ("gru", 32, "dependent frames")))
    return out


def print_times(out, kinds):
    """One line per kernel and batch: device and per-call time, roofline
    bound, time per chain step; for a kernel with a chain probe its chain
    bound and ratio, and the previous kernel's time quoted from PERF.md."""
    for kind, steps, what in kinds:
        for B in (SLOTS, ALWAYS_ON_SLOTS):
            ms, bnd, by, call = out[(kind, B)]
            extra = ""
            if kind + "_chain" in out:
                chain_ms, *rows = out[kind + "_chain"][1:]
                at = (f" at this run's rows ({rows[0][0]} x + {rows[0][1]} h "
                      f"per frame)" if rows else "")
                extra = (f"; chain bound{at} {chain_ms:.5f} ms "
                         f"({ms / chain_ms:.2f}x)")
            if kind + "_chain_every_row" in out:
                dense_ms = out[kind + "_chain_every_row"][1]
                extra += (f", with every row sent {dense_ms:.5f} ms "
                          f"({ms / dense_ms:.2f}x)")
            if (kind, B) in PREVIOUS_MS:
                extra += (f"; previous kernel {PREVIOUS_MS[(kind, B)]:.4f} "
                          f"ms (quoted from PERF.md, not measured here)")
            print(f"[time] {kind} B={B}: kernel {ms:.4f} ms on the device "
                  f"({call:.4f} ms per call with the wrapper), bound "
                  f"{bnd:.5f} ms ({by}), serial chain {steps} {what}: "
                  f"{ms * 1e6 / steps:.1f} ns per step{extra}")
        print(f"[time] {kind} B={SLOTS}: plain version "
              f"{out[(kind + '_plain', SLOTS)]:.2f} ms")


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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fpl, sp = iir_fex.batched_iir_fex_int_ref(xc, bundle.coef, sp,
                                                  fmt=ffmt)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3     # the second: warm
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
    return {"max_abs_err": float(err), "feats": fk, "plain_ms": plain_ms}


def compare_fex_int_tails(torch, np, bundle):
    """Integer FEx kernel vs its plain version where the launch plan is
    ragged: stream groups that do not fill a CTA (B = 1, 3, 33), chunks
    whose T is not a multiple of frame_shift or of 8 (the audio then
    comes sample by sample), a frame_shift that splits the kernel's
    tiles, ±full-scale audio from registers started at the 16-bit rails,
    and one-bit b and a shifts with codes that take Q + 2^15 plus a
    shifted product past 2^31 (the kernel's wide instance).  Every
    feature code and register must be equal."""
    from repro_torch.core import fixed_point as fp
    from repro_torch.data.gscd import synth_batch
    from repro_torch.kernels import iir_fex
    ffmt, coef = bundle.ffmt, bundle.coef
    C = coef.shape[1]
    rng = np.random.default_rng(31)
    audio, _ = synth_batch(np.random.default_rng(5), 33)
    speech = fp.to_code(torch.from_numpy(audio).cuda(), ffmt.feat_frac, 16,
                        torch.int16)

    def rails(B, T):
        x = np.where(rng.random((B, T)) < 0.5, 2047, -2048)
        st = np.where(rng.random((B, 5, C)) < 0.5, 32767, -32768)
        return (torch.from_numpy(x.astype(np.int16)).cuda(),
                torch.from_numpy(st.astype(np.int16)).cuda())

    zero = lambda B: fp.init_int_fex_state(B, C, "cuda")
    hot = coef.clone()                 # b0 = 8 in both sections: the
    hot[[0, 3]] = 8 << ffmt.b_frac     # registers sit on the rails
    # b_frac = a_frac = 1 with b0 = 2^18 - 1 and 2^16 - 1, a2 = 2^16 - 1:
    # at every -2048 sample both sections' r2 sums pass 2^31 - 2^15.
    one_bit = dataclasses.replace(ffmt, b_frac=1, a_frac=1)
    wide = torch.tensor([(1 << 18) - 1, -3, (1 << 16) - 1, (1 << 16) - 1, 2,
                         (1 << 16) - 1], dtype=torch.int32, device="cuda")
    wide = wide[:, None].expand(6, C).contiguous()
    cases = [("B=1", speech[:1, :CHUNK], zero(1), 128, coef, ffmt),
             ("B=3 T=4096+37", speech[:3, :CHUNK + 37], zero(3), 128, coef,
              ffmt),
             ("B=33 T=1000", speech[:, 3000:4000], zero(33), 128, coef,
              ffmt),
             ("B=5 frame_shift=100", speech[:5, :1000], zero(5), 100, coef,
              ffmt),
             ("rails B=4 b0=8", *rails(4, CHUNK), 128, hot, ffmt),
             ("rails B=2 T=3 frame_shift=1", *rails(2, 3), 1, coef, ffmt),
             ("rails B=3 one-bit shifts", *rails(3, CHUNK), 128, wide,
              one_bit)]
    for label, x, st, fs, cf, fmt in cases:
        x = x.contiguous()
        fk, sk = iir_fex.batched_iir_fex_int(x, cf, st, fmt=fmt,
                                             frame_shift=fs)
        fr, sr = iir_fex.batched_iir_fex_int_ref(x, cf, st, fmt=fmt,
                                                 frame_shift=fs)
        torch.cuda.synchronize()
        mism = int((fk != fr).sum()) + int((sk != sr).sum())
        at_rail = int(((sr[:, :4] == 32767) | (sr[:, :4] == -32768)).sum())
        print(f"[compare] iir_fex_int {label}: {mism} of {fk.numel()} codes "
              f"and {sk.numel()} registers differ (tolerance 0); filter "
              f"registers at a 16-bit rail after the chunk: {at_rail} of "
              f"{sr[:, :4].numel()}")
        if mism:
            fail(f"iir_fex_int {label} differs from its plain version")
        if label.startswith("rails") and at_rail == 0:
            fail(f"iir_fex_int {label} never pinned a register at a rail")


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


def widest_h(I: int, check) -> int:
    """The widest hidden size ``check`` (a kernel's check_*_fits) admits
    at input width I."""
    from repro_torch.kernels import delta_gru_seq as dgs
    best = 0
    for H in range(1, dgs.MAX_THREADS // 3 + 1):
        try:
            check(I, H)
        except ValueError:
            continue
        best = H
    return best


def compare_gru_int_edges(torch, np, feats, bundle):
    """Integer ΔGRU kernel vs its plain version where the launch or the
    data is unusual, every output identical (tolerance 0): stream counts
    that are not the serving batch (B = 1, 3, 33), chunks of T = 1, 3 and
    100 frames (100 > the 32 frames staged at a time), a threshold of 0,
    one of -1 (every row sent, zero deltas too), one above every |Δ|
    (nothing sent), and other widths with random int8 weights and codes:
    3H not a multiple of 4 or 16 (weights staged byte by byte), I > H,
    H = 128, and the widest H that check_int_kernel_fits admits at
    I = 10."""
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    w, gfmt = bundle.gru, bundle.gfmt
    xs_all = feats.movedim(1, 0).contiguous()           # (2T, B, 10)
    th = gfmt.th_codes(0.1)
    rng = np.random.default_rng(43)

    def random_model(I, H, B, T):
        wx = rng.integers(-128, 128, (I, 3 * H))
        wh = rng.integers(-128, 128, (H, 3 * H))
        b = rng.integers(-(1 << 18), 1 << 18, 3 * H)
        steps = rng.integers(-300, 301, (T, B, I)) * (rng.random((T, B, I))
                                                      < 0.4)
        xs = np.clip(np.cumsum(steps, 0), -2048, 2047)
        cuda = lambda a, dt: torch.from_numpy(a.astype(dt)).cuda()
        return (fp.IntGruWeights(cuda(wx, np.int8), cuda(wh, np.int8),
                                 cuda(b, np.int32)),
                cuda(xs, np.int16))

    serve = lambda T, B: xs_all[:T, :B] if B <= xs_all.shape[1] else \
        torch.cat([xs_all[:T]] * -(-B // xs_all.shape[1]), 1)[:, :B]
    long_xs = torch.cat([xs_all, xs_all.flip(0)])[:100]
    cases = [("B=1", w, serve(32, 1), th),
             ("B=3", w, serve(32, 3), th),
             ("B=33", w, serve(32, 33), th),
             ("T=1", w, serve(1, 32), th),
             ("T=3", w, serve(3, 32), th),
             ("T=100", w, long_xs, th),
             ("th=0", w, serve(32, 32), (0, 0)),
             ("th=-1 (every row sent)", w, serve(32, 32), (-1, -1)),
             ("th above every |Δ| (nothing sent)", w, serve(32, 32),
              (1 << 17, 1 << 17))]
    for I, H, B, T in ((7, 5, 3, 32), (40, 100, 5, 32), (96, 32, 4, 40),
                       (16, 128, 33, 32),
                       (10, widest_h(10, dgs.check_int_kernel_fits), 3, 32)):
        wr, xr = random_model(I, H, B, T)
        cases.append((f"I={I} H={H} B={B} T={T} random", wr, xr, th))
    for label, wc, xs, tcodes in cases:
        xs = xs.contiguous()
        T, B, I = xs.shape
        H = wc.w_h.shape[0]
        st = tuple(fp.init_int_delta_state(B, I, H, wc))
        hk, sk, nxk, nhk = dgs.delta_gru_seq_int(xs, *st, wc.w_x, wc.w_h,
                                                 tcodes, fmt=gfmt)
        hp, sp, nxp, nhp = dgs.delta_gru_seq_int_ref(xs, *st, wc.w_x,
                                                     wc.w_h, tcodes,
                                                     fmt=gfmt)
        torch.cuda.synchronize()
        mism = {"hs": int((hk != hp).sum()),
                "state": sum(int((a != r).sum()) for a, r in zip(sk, sp)),
                "nz": int((nxk != nxp).sum() + (nhk != nhp).sum())}
        sent = int(nxp.sum() + nhp.sum())
        print(f"[compare] delta_gru_seq_int {label} (codes {tcodes}): T={T} "
              f"B={B} I={I} H={H}, mismatches {mism} (tolerance 0); "
              f"transmitted {sent} of {T * B * (I + H)}")
        if any(mism.values()):
            fail(f"delta_gru_seq_int {label} differs from its plain "
                 f"version: {mism}")
        if label.startswith("th=-1") and sent != T * B * (I + H):
            fail("th=-1 did not send every row")
        if label.startswith("th above") and sent:
            fail("a threshold above every |Δ| sent rows")


def time_int_kernels(torch, x, gru_res, fex_bundle, fex_int_plain_ms):
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
        ms, call = kernel_ms(torch, lambda: iir_fex.batched_iir_fex_int(
            xb, coef, st, fmt=ffmt))
        out[("fex_int", B)] = (ms, *fex_int_bound(B, CHUNK, C), call)
    out[("fex_int_plain", SLOTS)] = fex_int_plain_ms
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
        if B == SLOTS:
            data_rows = busiest_rows(nzx, nzh, T)
        ms, call = kernel_ms(torch, lambda: dgs.delta_gru_seq_int(
            *args, fmt=gfmt))
        out[("gru_int", B)] = (ms, *gru_int_bound(T, B, I, H, nz_total),
                               call)
        if B == SLOTS:
            out[("gru_int_plain", SLOTS)] = cuda_ms(
                torch, lambda: dgs.delta_gru_seq_int_ref(*args, fmt=gfmt),
                10, warmup=2)
    out["fex_int_chain"] = fex_int_chain_bound(torch, fex_bundle)
    out["gru_int_chain"] = (*gru_int_chain_bound(torch, gfmt, data_rows),
                            data_rows)
    out["gru_int_chain_every_row"] = gru_int_chain_bound(torch, gfmt)
    print_times(out, (("fex_int", CHUNK, "dependent samples"),
                      ("gru_int", 32, "dependent frames")))
    return out


# ------------------------------------------------- block-sparse phases --
MATVEC_SWEEP = ((1, 128, 128, 128, 128), (4, 512, 384, 128, 128),
                (2, 256, 640, 64, 128), (8, 1024, 256, 256, 64))


def _sparse_deltas(torch, gen, B, I, block_i, density=0.06, idle=True):
    """Deltas as the ΔGRU makes them, mostly zero; with ``idle`` the
    second input block (where there is one) is all zero."""
    dx = torch.randn(B, I, generator=gen, device="cuda")
    dx = dx * (torch.rand(B, I, generator=gen, device="cuda") < density)
    if idle and I // block_i > 1:
        dx[:, block_i:2 * block_i] = 0.0
    return dx.contiguous()


def compare_delta_matvec(torch, wide_shapes):
    """delta_matvec against its plain version on the card: the reference's
    sweep in float32 and bfloat16, the wide model's shapes, a masked
    block with non-zero deltas and an all-zero mask."""
    from repro_torch.kernels import delta_matvec as dm
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    cases = [(f"sweep {c}", *c, dt) for c in MATVEC_SWEEP
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"wide B={B} I={I} O={O}", B, I, O, bi, bo, torch.float32)
              for B, I, O, bi, bo in wide_shapes]
    # Tails of the 16 × 64 CTA tile and of the 32-row slices: rows that do
    # not fill a tile, block_i = 10 (slices of 10 rows), 5 blocks of 64;
    # each also with only the last block active.
    cases += [(f"tail B={B} I={I} O=640{last}", B, I, 640, bi, 128, dt)
              for B in (1, 17, 255) for I, bi in ((10, 10), (320, 64))
              for dt in (torch.float32, torch.bfloat16)
              for last in ("", " last block only")]
    for label, B, I, O, block_i, block_o, dtype in cases:
        dx = _sparse_deltas(torch, gen, B, I, block_i, 0.5).to(dtype)
        w = torch.randn(I, O, generator=gen, device="cuda").to(dtype)
        m = torch.randn(B, O, generator=gen, device="cuda")
        mask = dm.make_block_mask(dx, block_i)
        if label.endswith("last block only"):
            mask = torch.zeros_like(mask)
            mask[-1] = 1
        got = dm.delta_matvec(dx, w, m, mask, block_i=block_i,
                              block_o=block_o)
        want = dm.delta_matvec_ref(dx, w, m, mask, block_i)
        torch.cuda.synchronize()
        err = ((got - want).abs() / (1.0 + want.abs())).max().item()
        abs_err = (got - want).abs().max().item()
        print(f"[compare] delta_matvec {label} {str(dtype)[6:]} "
              f"block_i={block_i}: active blocks {int(mask.sum())} of "
              f"{mask.numel()}, max err {err:.3g} relative to 1+|out| "
              f"(bound {MATVEC_TOL}), max abs err {abs_err:.3g}")
        if not err <= MATVEC_TOL:
            fail(f"delta_matvec {label}: err {err} > {MATVEC_TOL}")
        worst = max(worst, abs_err)
    ones = torch.ones(2, 256, device="cuda")
    out = dm.delta_matvec(ones, torch.ones(256, 128, device="cuda"),
                          torch.zeros(2, 128, device="cuda"),
                          torch.tensor([1, 0], dtype=torch.int32,
                                       device="cuda"))
    m = torch.randn(2, 128, generator=gen, device="cuda")
    none = dm.delta_matvec(ones, torch.ones(256, 128, device="cuda"), m,
                           torch.zeros(2, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    exact = bool((out == 128.0).all()) and torch.equal(none, m)
    print(f"[compare] delta_matvec masked block with non-zero deltas: all "
          f"128.0 = {bool((out == 128.0).all())}; all-zero mask returns m "
          f"bit for bit = {torch.equal(none, m)}")
    if not exact:
        fail("delta_matvec: a masked-off block contributed")
    return {"max_abs_err": worst}


def compare_cell(torch, gru_res):
    """delta_gru_cell against its plain version on the card: the
    reference's three sweep shapes, the full width at B = 1, 3, 33, 32
    and 256, and the float ΔGRU's edge widths (3H not a multiple of 4 or
    of 32, I = 40 over two x warps, I > H, H = 128, the widest H the
    sequence kernel admits at I = 10), at Δ_TH 0, 0.1, 0.2, -1 (every
    row sent: x̂ = x, ĥ = h) and above every |Δ| (no row: M and x̂
    unchanged)."""
    from repro_torch.kernels import delta_gru_cell as dgc
    from repro_torch.kernels import delta_gru_seq as dgs
    gen = torch.Generator(device="cuda").manual_seed(23)
    gru = gru_res["gru"]
    worst = 0.0
    shapes = [(1, 10, 64, None), (4, 16, 32, None), (2, 40, 128, None),
              (SLOTS, 10, 64, gru), (ALWAYS_ON_SLOTS, 10, 64, gru),
              (1, 10, 64, gru), (3, 10, 64, gru), (33, 10, 64, gru),
              (3, 7, 5, None), (3, 10, 20, None), (5, 40, 20, None),
              (4, 96, 32, None), (33, 16, 128, None),
              (3, 10, widest_h(10, dgs.check_kernel_fits), None)]
    for B, I, H, model in shapes:
        r = lambda *s, k=1.0: k * torch.randn(*s, generator=gen,
                                              device="cuda")
        if model is None:
            w_x, w_h = r(I, 3 * H, k=0.2), r(H, 3 * H, k=0.2)
        else:
            w_x, w_h = model.w_x, model.w_h
        args = (r(B, I), r(B, H, k=0.5), r(B, I, k=0.1), r(B, H, k=0.1),
                r(B, 3 * H, k=0.1), r(B, 3 * H, k=0.1), w_x, w_h)
        for th in THRESHOLDS + EDGE_TH:
            got = dgc.delta_gru_cell(*args, th)
            want = dgc.delta_gru_cell_ref(*args, th)
            torch.cuda.synchronize()
            sel_m = sum(int((g != w).sum()) for g, w in
                        zip(got[1:3], want[1:3]))
            if th == EDGE_TH[0]:
                sel_m += int((got[1] != args[0]).sum()
                             + (got[2] != args[1]).sum())
            if th == EDGE_TH[1]:
                sel_m += int((got[1] != args[2]).sum()
                             + (got[3] != args[4]).sum()
                             + (got[4] != args[5]).sum())
            err = max((g - w).abs().max().item() for g, w in
                      zip(got[0:1] + got[3:], want[0:1] + want[3:]))
            print(f"[compare] delta_gru_cell B={B} I={I} H={H} Δ_TH={th}: "
                  f"x̂/ĥ mismatches {sel_m} (tolerance 0), h/M max abs "
                  f"diff {err:.3g} (bound {HS_ATOL})")
            if sel_m or not err <= HS_ATOL:
                fail(f"delta_gru_cell B={B} H={H} Δ_TH={th}: x̂/ĥ {sel_m}, "
                     f"h/M {err}")
            worst = max(worst, err)
    return {"max_abs_err": worst}


def compare_blocked(torch, gru_res):
    """The full-width ΔGRU forced through the block-sparse path
    (smem_budget_bytes=0) over two carried chunks, against delta_gru_seq
    at Δ_TH 0.1."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import delta_matvec as dm
    gru, xs = gru_res["gru"], gru_res["xs_all"]
    T, B, I = xs.shape[0] // 2, xs.shape[1], xs.shape[2]
    H = gru.w_h.shape[0]
    sb = ss = dg.init_delta_state(B, I, H, gru)
    hs_err, nz_m = 0.0, 0
    dm.delta_matvec.launches = dgs.delta_gru_seq.launches = 0
    for c in range(2):
        chunk = xs[c * T:(c + 1) * T].contiguous()
        hb, sb, stb = dg.delta_gru_scan(gru, chunk, 0.1, sb,
                                        backend="pallas",
                                        smem_budget_bytes=0)
        hq, ss, stq = dg.delta_gru_scan(gru, chunk, 0.1, ss,
                                        backend="pallas")
        torch.cuda.synchronize()
        hs_err = max(hs_err, (hb - hq).abs().max().item())
        nz_m += int((stb.nz_dx != stq.nz_dx).sum()
                    + (stb.nz_dh != stq.nz_dh).sum())
    st_err = max((a - b).abs().max().item() for a, b in zip(sb, ss))
    launches = (dm.delta_matvec.launches, dgs.delta_gru_seq.launches)
    print(f"[compare] block-sparse ΔGRU (smem_budget_bytes=0) vs "
          f"delta_gru_seq, 2 chunks of T={T}, B={B}, I={I}, H={H}, Δ_TH "
          f"0.1: hs max abs diff {hs_err:.3g}, final state {st_err:.3g} "
          f"(both must be 0: the same sums in the same order), "
          f"transmit-count mismatches {nz_m}; launches delta_matvec "
          f"{launches[0]}, delta_gru_seq {launches[1]}")
    if hs_err != 0.0 or st_err != 0.0 or nz_m or launches != (4 * T, 2):
        fail(f"block-sparse path: hs {hs_err}, state {st_err}, nz {nz_m}, "
             f"launches {launches}")
    return {"max_abs_err": hs_err}


def wide_params(torch):
    """The DeltaKWS architecture at H=WIDE_H, random weights from seed 0."""
    import dataclasses

    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.models import kws
    cfg = dataclasses.replace(CONFIG, d_model=WIDE_H)
    return cfg, kws.init_kws(torch.Generator().manual_seed(0), cfg,
                             input_dim=CONFIG.frontend_tokens)


def time_matvec_copy_paths(torch, dm, dx, w, m, mask, block_i, want):
    """delta_matvec's device time with each copy path the tensors allow
    (the launcher called directly with the wrapper's plan but another
    copy path; these launches are not counted).  Each path must give the
    wrapper's result bit for bit: the sums are the same."""
    from repro_torch.kernels import build
    B, I = dx.shape
    O = w.shape[1]
    plan = dm.matvec_launch_plan(B, I, O, block_i, 128)
    lib, fn = dm._launcher()
    out = torch.empty_like(m)
    times = {}
    for copy in ("tma", "cp.async", "plain"):
        if copy == "tma" and plan["copy"] != "tma":
            continue

        def launch(copy=copy):
            err = fn(dx.data_ptr(), w.data_ptr(), m.data_ptr(),
                     mask.data_ptr(), out.data_ptr(), B, I, O, block_i, 0,
                     *plan["grid"], plan["threads"], dm.COPY_CODES[copy],
                     plan["smem_bytes"],
                     torch.cuda.current_stream().cuda_stream)
            build.check(lib, err, f"delta_matvec {copy} launch")
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            fail(f"delta_matvec {copy} copy path differs from the wrapper's "
                 f"result at I={I}")
        times[copy] = graph_ms(torch, launch)
    print(f"[time] delta_matvec B={B} I={I} O={O} block_i={block_i} by copy "
          f"path (the plan takes {plan['copy']}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return times


def time_block_sparse(torch, gru_res):
    """delta_matvec at the wide model's two matvec shapes (B=256) and
    delta_gru_cell at full width (B=32, 256): kernel, plain version,
    library call where one exists, bound."""
    from repro_torch.kernels import delta_gru_cell as dgc
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import delta_matvec as dm
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    B, O = ALWAYS_ON_SLOTS, 3 * WIDE_H
    for I, block_i in ((10, 10), (WIDE_H, 128)):
        dx = _sparse_deltas(torch, gen, B, I, block_i, idle=False)
        w = torch.randn(I, O, generator=gen, device="cuda") / I ** 0.5
        m = torch.randn(B, O, generator=gen, device="cuda")
        mask = dm.make_block_mask(dx, block_i)
        rows = int(mask.sum()) * block_i
        dx_m = dx * torch.repeat_interleave(mask.float(), block_i)
        ms, call = kernel_ms(torch, lambda: dm.delta_matvec(
            dx, w, m, mask, block_i=block_i, block_o=128))
        plain = graph_ms(torch, lambda: dm.delta_matvec_ref(
            dx, w, m, mask, block_i))
        lib = graph_ms(torch, lambda: torch.addmm(m, dx_m, w))
        bnd, by = matvec_bound(B, I, O, rows, mask.numel())
        fmul = matvec_fmul_fadd_ms(torch, B, O, rows)
        out[("matvec", I)] = (ms, plain, lib, bnd, by, call, fmul)
        time_matvec_copy_paths(torch, dm, dx, w, m, mask, block_i,
                               dm.delta_matvec(dx, w, m, mask,
                                               block_i=block_i))
        print(f"[time] delta_matvec B={B} I={I} O={O} block_i={block_i} "
              f"({int(mask.sum())} of {mask.numel()} blocks active): kernel "
              f"{ms:.4f} ms on the device ({call:.4f} ms per call with the "
              f"wrapper), plain {plain:.4f} ms, torch.addmm {lib:.4f} ms "
              f"(both on the device; kernel/addmm {ms / lib:.2f}), bound "
              f"{bnd:.5f} ms ({by}), FMUL+FADD bound {fmul:.5f} ms; "
              f"previous kernel {PREVIOUS_MS[('matvec', I)]:.4f} ms "
              f"(quoted from PERF.md, not measured here)")
    gru = gru_res["gru"]
    th = 0.1
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        xs = gru_res["xs"].repeat(1, B // SLOTS, 1).contiguous()
        T, _, I = xs.shape
        H = gru.w_h.shape[0]
        from repro_torch.core import delta_gru as dg
        _, st, _, _ = dgs.delta_gru_seq(xs[:T // 2].contiguous(),
                                        *dg.init_delta_state(B, I, H, gru),
                                        gru.w_x, gru.w_h, th)
        x = xs[T // 2].contiguous()
        args = (x, *st, gru.w_x, gru.w_h, th)
        dx = (x - st[1]).abs() > th
        dh = (st[0] - st[2]).abs() > th
        nz = int(dx.sum() + dh.sum())
        ms, call = kernel_ms(torch, lambda: dgc.delta_gru_cell(*args))
        plain = cuda_ms(torch, lambda: dgc.delta_gru_cell_ref(*args), 10,
                        warmup=2)
        bnd, by = cell_bound(B, I, H, nz)
        empty, trip = cell_launch_floor(torch, B, H)
        out[("cell", B)] = (ms, plain, None, bnd, by, call, None, empty,
                            trip)
        print(f"[time] delta_gru_cell B={B} I={I} H={H} Δ_TH {th} "
              f"({nz} of {B * (I + H)} deltas transmitted): kernel "
              f"{ms:.4f} ms on the device ({call:.4f} ms per call with the "
              f"wrapper), plain {plain:.4f} ms per call, bound {bnd:.5f} "
              f"ms ({by}); launch floor at {B} CTAs of "
              f"{-(-3 * H // 32) * 32} threads: empty kernel {empty:.4f} "
              f"ms, one dependent global round trip {trip:.4f} ms — the "
              f"kernel at {ms / max(bnd, trip):.2f}x the larger of the "
              f"floor and the bound; previous kernel "
              f"{PREVIOUS_MS[('cell', B)]:.4f} ms (quoted from PERF.md, not "
              f"measured here)")
    return out


def serve_wide(torch, np):
    """Serve REQUESTS one-second requests on SLOTS slots with the DeltaKWS
    architecture at H=WIDE_H, whose ΔGRU weights (817 KB) no thread
    block holds: every step must run the FEx kernel once and
    delta_matvec twice per frame, and never delta_gru_seq."""
    from repro_torch.data.gscd import T as UTT_SAMPLES
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.launch.engine import run_audio_requests
    from repro_torch.launch.streaming import SlotScheduler, StreamingKwsSession
    cfg, params = wide_params(torch)
    fex = FeatureExtractor()
    sess = StreamingKwsSession(params, cfg, threshold=0.1, batch=SLOTS,
                               fex=fex, device="cuda")
    sched = SlotScheduler(sess)
    for req in range(REQUESTS):
        sched.submit(req)
    audio_q, _ = synth_batch(np.random.default_rng(1), REQUESTS)
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    done, stats = run_audio_requests(
        sess, sched, None, audio_q=audio_q, chunk=CHUNK,
        chunks_per_utt=-(-UTT_SAMPLES // CHUNK),
        real_frames=UTT_SAMPLES // fex.cfg.frame_shift)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(wrappers)
    steps = stats["steps"] + 1                  # + the warm-up step
    frames = CHUNK // fex.cfg.frame_shift
    summ = sess.summary()
    print(f"[serve] float32 H={WIDE_H} (block-sparse ΔGRU): {len(done)} "
          f"requests on {SLOTS} slots, {stats['steps']} steps in {dt:.2f} s, "
          f"frames {summ.frames}, sparsity {summ.sparsity:.4f}, launches "
          f"{launches}")
    want = {"batched_iir_fex": steps, "delta_matvec": 2 * frames * steps}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"the H={WIDE_H} path must launch {want} and nothing else: "
             f"{launches}")
    if len(done) != REQUESTS or not all(0 <= p < sess.n_classes
                                        for _, p in done):
        fail(f"the H={WIDE_H} session decided {len(done)} requests")
    if sess.unhealthy_slots():
        fail(f"unhealthy slots after the H={WIDE_H} run: "
             f"{sess.unhealthy_slots()}")
    return {"delta_matvec": launches["delta_matvec"]}


def kernel_wrappers():
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels import ops
    return {name: getattr(ops, name) for name in (
        "batched_iir_fex", "delta_gru_seq", "batched_iir_fex_int",
        "delta_gru_seq_int", "delta_matvec", "delta_gru_cell",
        "detect_head", "wake_head")}


# The masked instantiations count their launches apart, on their wrapper.
MASKED = {"delta_gru_seq (masked)": "delta_gru_seq",
          "delta_gru_seq_int (masked)": "delta_gru_seq_int"}


def zero_launches(wrappers):
    """Set every kernel's launch count to 0, the masked ones' too."""
    for fn in wrappers.values():
        fn.launches = 0
    for base in MASKED.values():
        wrappers[base].masked_launches = 0


def read_launches(wrappers) -> dict:
    """Every kernel's launch count by name, each masked instantiation as a
    kernel of its own."""
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({name: wrappers[base].masked_launches
                for name, base in MASKED.items()})
    return out


def serve_main_path(torch, numerics: str = "float32"):
    """Serve through the CLI's entry point with every kernel's count set
    to 0 just before and read just after: the path's two kernels must
    have launched once per step (+ the warm-up step), the others never."""
    from repro_torch.launch import serve
    wrappers = kernel_wrappers()
    path = (("batched_iir_fex_int", "delta_gru_seq_int")
            if numerics == "int8" else ("batched_iir_fex", "delta_gru_seq"))
    args = serve.build_parser().parse_args(
        ["--mode", "kws-audio", "--slots", str(SLOTS), "--requests",
         str(REQUESTS), "--chunk-samples", str(CHUNK), "--init-seed", "0",
         "--train-steps", "0", "--numerics", numerics])
    serve.validate_args(args)
    zero_launches(wrappers)
    sess, done, labels, stats, dt = serve.serve_kws_audio(args)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
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
    the JAX package), 4 streams × 4000 samples in unaligned chunks.  Both
    sides run XLA's σ/tanh/log2, so every code must be equal: the FEx
    registers, x̂, h, the logit codes, the votes and the transmit
    counts."""
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
    nz_m = int((nz != nz_c).sum())
    if fex_m or xh_m or h_m or code_m or vote_m or nz_m:
        fail(f"int8 CUDA session disagrees with the CPU session: FEx "
             f"{fex_m}, x̂ {xh_m}, h {h_m}, logit codes {code_m}, votes "
             f"{vote_m}, nz {nz_m}")
    return {"h": h_m, "logit_codes": code_m, "votes": vote_m}


def always_on(torch, np, params, card, profile: bool,
              numerics: str = "float32"):
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.engine import warm_session
    from repro_torch.launch.streaming import StreamingKwsSession
    B, n = ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS
    streams = always_on_streams(np)
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
    n_dev = sum(1 for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
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
          f"{busy / 4:.1f} us/step ({100 * busy / wall_us:.1f}% of wall), "
          f"{n_dev / 4:.1f} device activities (kernels, copies) per step")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   {dev_us / 4:9.1f} us/step  x{count // 4:<3d} "
              f"{key[:90]}")


# ---------------------------------------------------- detection phases --
DETECT_FIRE, DETECT_RELEASE = 0.1, 0.09   # the random model fires here
DETECT_SECONDS = 30.0                     # serve phase: stream per slot
HEAD_OPS_PER_CLASS = 32        # exp ≈ 24, the max, the sum, the division,
                               # the EMA, the compares (an FMA counts two)


def head_case(torch, gen, F, B, K, scale=0.8):
    return scale * torch.randn(F, B, K, generator=gen, device="cuda")


def run_head(torch, dh, logits, cfg, chunks):
    """The kernel and its plain version over ``chunks`` carried chunks of
    ``logits``; returns (mismatches, fires, max abs smooth diff) and fails
    on any difference."""
    from repro_torch.models.detector import init_detector_state
    F, B, K = logits.shape
    st_k = st_p = init_detector_state(B, K, "cuda")
    step = -(-F // chunks)
    bad = fires = 0
    for lo in range(0, F, step):
        st_k, ev_k = dh.detect_head(logits[lo:lo + step], st_k, cfg)
        st_p, ev_p = dh.detect_head_ref(logits[lo:lo + step], st_p, cfg)
        torch.cuda.synchronize()
        bad += int((ev_k != ev_p).sum())
        bad += int((st_k.active != st_p.active).sum())
        bad += int((st_k.refract != st_p.refract).sum())
        bad += bits_differ(torch, st_k.smooth, st_p.smooth)
        fires += int((ev_k >= 0).sum())
    return bad, fires


def compare_detect_head(torch, np):
    """detect_head against its plain version (xla_softmax + the frame
    loop of detector_scan) on the card: events, the latch, the refractory
    count and the smoothed posteriors bit for bit (tolerance 0), at the
    serving shapes over two carried chunks, at ragged shapes, over the
    options and on hostile data."""
    from repro_torch.kernels import build
    from repro_torch.kernels import detect_head as dh
    from repro_torch.models.detector import DetectorConfig
    lib = build.load("detect_head")
    fn = lib.detect_head_smem_bytes
    fn.restype = ctypes.c_longlong
    group = lib.detect_head_group
    for K in (1, 11, 12, 16, 17, 35, 64):
        if fn(K) != dh.detect_launch_plan(33, K)[2]:
            fail(f"detect_head shared-memory formula mismatch at K={K}")
        if group(K) != dh.lanes_per_slot(K):
            fail(f"detect_head lanes per slot mismatch at K={K}")
    gen = torch.Generator(device="cuda").manual_seed(31)
    rng = np.random.default_rng(31)
    cases = []
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        logits = head_case(torch, gen, 64, B, 12)
        for alpha in (0.25, 0.3):
            for fk in (1, 2):
                n_kw = 12 - fk
                per_kw = tuple(float(v) for v in
                               rng.uniform(0.085, 0.1, n_kw))
                for fire, rel in ((0.09, 0.087),
                                  (per_kw, tuple(0.97 * f for f in per_kw))):
                    kind = ("per-keyword" if isinstance(fire, tuple)
                            else "scalar")
                    cases.append((f"B={B} F=2x32 α={alpha} first_keyword="
                                  f"{fk} {kind} thresholds", logits,
                                  DetectorConfig(alpha, fire, rel, 5, fk),
                                  2))
    for B in (1, 3, 33):
        for F in (1, 3, 100):
            cases.append((f"B={B} F={F}", head_case(torch, gen, F, B, 12),
                          DetectorConfig(0.3, 0.02, 0.015, 4), 1))
    lg = head_case(torch, gen, 40, 33, 35, 2.0)
    cases.append(("B=33 F=40 K=35 (a sum in two windows)", lg,
                  DetectorConfig(0.3, 0.035, 0.03, 4), 2))
    lg = head_case(torch, gen, 50, 64, 12, 3.0)
    lg[7, 5, 3] = float("nan")
    lg[10:20, 9, 4], lg[10:20, 9, 0] = 1e30, -1e30
    lg[20:30, 11, :] = 1e30
    lg[30:40, 12, 2], lg[30:40, 12, 5] = -1e30, 1e30
    cases.append(("hostile: a NaN row, ±1e30 logits, fires in most slots",
                  lg, DetectorConfig(0.3, 0.05, 0.04, 2), 2))
    for name, logits, cfg, chunks in cases:
        bad, fires = run_head(torch, dh, logits, cfg, chunks)
        print(f"[compare] detect_head {name}: mismatches {bad} (events, "
              f"latch, refractory, smooth bits; tolerance 0), fires {fires}")
        if bad:
            fail(f"detect_head disagrees with its plain version: {name}")
        if fires == 0:
            fail(f"detect_head case fired nowhere: {name}")
    # A plan the kernel cannot run is refused, not run.
    launch = lib.detect_head_launch
    p = ctypes.c_void_p
    launch.argtypes = ([p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [p] * 4 + [ctypes.c_int] * 6 + [p])
    for grid, block in ((1, 256), (3, 128), (1, 48)):
        err = launch(*([None] * 6), 0.25, 1, 2, *([None] * 4), 1, 30, 12,
                     grid, block, 96, None)
        if err == 0:
            fail(f"detect_head ran a plan it cannot run ({grid} CTAs of "
                 f"{block} for 30 slots)")
    return {"max_abs_err": 0.0, "cases": len(cases)}


def head_bound(F, B, K):
    """detect_head: logits read once, the state read and written, the
    events written; per (frame, slot, class) HEAD_OPS_PER_CLASS ops."""
    moved = 4 * (F * B * K + 2 * (B * K + 2 * B) + F * B)
    return bound(moved, HEAD_OPS_PER_CLASS * F * B * K)


def time_detect_head(torch):
    """detect_head at the serving shapes (F = 32, K = 12, B = 32 and 256)
    and at F = 1: kernel (device and per call), plain version, the bound
    from the shapes, and the launch floor (an empty kernel at the same
    launch shape)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import detect_head as dh
    from repro_torch.models.detector import DetectorConfig, init_detector_state
    gen = torch.Generator(device="cuda").manual_seed(37)
    cfg = DetectorConfig(0.25, 0.09, 0.087, 30)
    lib = build.load("detect_head")
    floor = lib.detect_head_floor_launch
    floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        st = init_detector_state(B, 12, "cuda")
        res = {}
        for F in (32, 1):
            lg = head_case(torch, gen, F, B, 12)
            res[F] = kernel_ms(torch, lambda: dh.detect_head(lg, st, cfg))
        lg = head_case(torch, gen, 32, B, 12)
        plain = cuda_ms(torch, lambda: dh.detect_head_ref(lg, st, cfg), 5,
                        warmup=1)
        grid, block, _ = dh.detect_launch_plan(B, 12)

        def empty():
            build.check(lib, floor(grid, block,
                                   torch.cuda.current_stream().cuda_stream),
                        "detect_head floor launch")
        fl = graph_ms(torch, empty)
        bnd, by = head_bound(32, B, 12)
        (ms, call), (ms1, _) = res[32], res[1]
        out[B] = dict(ms=ms, call=call, ms_f1=ms1, plain=plain, floor=fl,
                      bound=bnd, by=by)
        print(f"[time] detect_head B={B} F=32 K=12: kernel {ms:.4f} ms on "
              f"the device ({call:.4f} ms per call with the wrapper), at "
              f"F=1 {ms1:.4f} ms ({(ms - ms1) * 1e3 / 31:.3f} us per frame "
              f"of the chain), plain {plain:.2f} ms per call, bound "
              f"{bnd:.6f} ms ({by}); launch floor (empty kernel, {grid} "
              f"CTAs of {block}) {fl:.4f} ms — the kernel at "
              f"{ms / fl:.2f}x the floor")
    return out


def detect_args(numerics, slots, seconds, extra=()):
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--mode", "kws-detect", "--slots", str(slots), "--stream-seconds",
         str(seconds), "--chunk-samples", str(CHUNK), "--init-seed", "0",
         "--train-steps", "0",
         "--numerics", numerics, "--fire-threshold", str(DETECT_FIRE),
         "--release-threshold", str(DETECT_RELEASE), *extra])
    serve.validate_args(args)
    return args


def serve_detect(torch, numerics: str):
    """Serve kws-detect through the CLI's entry point at full width on
    SLOTS slots × 30 s streams, every kernel's count set to 0 just before
    and read just after: the FEx and ΔGRU kernels of the numerics and
    detect_head once per step (+ the warm-up step), nothing else.
    Returns detect_head's launches."""
    from repro_torch.launch import serve
    from repro_torch.launch.streaming import HEALTH_SAT
    wrappers = kernel_wrappers()
    path = (("batched_iir_fex_int", "delta_gru_seq_int", "detect_head")
            if numerics == "int8"
            else ("batched_iir_fex", "delta_gru_seq", "detect_head"))
    args = detect_args(numerics, SLOTS, DETECT_SECONDS)
    zero_launches(wrappers)
    sess, point, stats, dt, n_samples = serve.serve_kws_detect(args)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    summ = sess.summary()
    slo = stats["slo"]
    print(f"[serve] kws-detect {numerics}: {SLOTS} slots x "
          f"{n_samples / 8000:.0f} s, {stats['steps']} steps in {dt:.2f} s "
          f"(warm-up {stats['warmup_s']:.2f} s), step p50 "
          f"{slo['step_ms']['p50']:.2f} ms, {slo['decisions'] / slo['steady_state_s']:.0f} "
          f"decisions/s; {point.n_events} events, {point.hits} hits, "
          f"{point.misses} misses, {point.false_alarms} false alarms "
          f"({point.fa_per_hour:.1f} FA/hr), vad duty {summ.vad_duty:.3f}, "
          f"sparsity {summ.sparsity:.4f}, launches {launches}")
    want = stats["steps"] + 1                   # + the warm-up step
    if any(launches[k] != want for k in path) or any(
            v for k, v in launches.items() if k not in path):
        fail(f"the {numerics} detect path must launch {path} once per "
             f"step ({want}) and nothing else: {launches}")
    if summ.frames != SLOTS * (n_samples // 128):
        fail(f"kws-detect counted {summ.frames} decisions")
    if point.n_events == 0 or point.hits + point.false_alarms == 0:
        fail(f"kws-detect fired nothing: {point}")
    if not 0.0 < summ.vad_duty < 1.0:
        fail(f"vad duty {summ.vad_duty}")
    bad = {k: f for k, f in sess.unhealthy_slots().items()
           if f & ~HEALTH_SAT}
    if bad:
        fail(f"unhealthy slots after kws-detect: {bad}")
    return launches["detect_head"]


def check_detect_against_cpu(torch, np, params, numerics: str):
    """A full-width CUDA detect session against the CPU one (the plain
    versions, which the CPU tests hold against the JAX package) on 4
    continuous streams × 12000 samples in unaligned chunks, with fires.
    int8: every logit code, vote, count, event, gate and state equal;
    float: events, gates, votes and counts equal, logits within 1e-4."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import make_streams
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    streams = make_streams(7, 4, duration_s=1.5, snr_db=20.0,
                           events_per_min=60.0)
    audio = np.stack([s.audio for s in streams])
    det = DetectorConfig(0.3, 0.095, 0.09, 4)
    outs, states = {}, {}
    for dev in ("cuda", "cpu"):
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=4,
                                   device=dev, numerics=numerics,
                                   detector=det, vad=VADConfig(0.02))
        parts = [sess.process_audio(audio[:, lo:hi])
                 for lo, hi in ((0, 5000), (5000, 5001), (5001, 12000))]
        outs[dev] = {f: torch.cat([getattr(p, f) for p in parts]).cpu()
                     for f in parts[0]._fields if f != "awake"}
        states[dev] = [t.cpu() for t in (*sess.fex_state, *sess.state,
                                         *sess.vad_state, *sess.det_state)]
        heads = [sess.vad_state.hold.cpu(), sess.det_state.smooth.cpu()]
        states[dev + " head"] = heads
        summ = sess.summary()
        outs[dev]["duty"] = summ.vad_duty
    c, p = outs["cuda"], outs["cpu"]
    err = (c["logits"] - p["logits"]).abs().max().item()
    mism = {f: int((c[f] != p[f]).sum())
            for f in ("votes", "nz", "events", "gate")}
    # Integer state (codes, the latch, the counts) must be equal; the
    # VAD hold and the smoothed posteriors are held to the logits'
    # tolerance in float32 and must be equal in int8.
    state_m = sum(int((a != b).sum()) for a, b in
                  zip(states["cuda"], states["cpu"])
                  if not a.is_floating_point())
    state_err = max((a.float() - b.float()).abs().max().item() for a, b in
                    zip(states["cuda head"], states["cpu head"]))
    fires = int((c["events"] >= 0).sum())
    print(f"[check] {numerics} detect session CUDA vs CPU, 4 streams x "
          f"12000 samples: logits max abs diff {err:.3g}, mismatches "
          f"{mism}, integer state elements differing {state_m}, VAD hold "
          f"and smoothed posteriors max abs diff {state_err:.3g}, fires "
          f"{fires}, vad duty "
          f"{c['duty']:.3f} / {p['duty']:.3f}")
    if any(mism.values()) or state_m or fires == 0 or c["duty"] != p["duty"]:
        fail(f"{numerics} detect session disagrees with the CPU one")
    if numerics == "int8" and (err or state_err):
        fail(f"int8 detect session: logits {err}, hold/smooth {state_err}")
    if not (err <= 1e-4 and state_err <= 1e-4):
        fail(f"float detect session: logits {err}, state {state_err}")


def detect_always_on(torch, np, params, card, profile: bool,
                     numerics: str, plain_step_s: float):
    """The always-on phase in detect mode: ALWAYS_ON_SLOTS continuous
    streams (the serve CLI's 20 dB SNR) × ALWAYS_ON_CHUNKS chunks of CHUNK
    samples, VAD on, streams synthesised before the clock starts: step
    time, decisions/s and kernel launches per step.  Then three rounds
    alternating a plain session and the detect session on the same audio
    (reset between rounds), so the two steps are compared within the same
    few seconds; beside them the non-detect always-on step of this run."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import make_streams
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.launch.engine import warm_session
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    B, n = ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS
    streams = make_streams(200, B, duration_s=n * CHUNK / 8000 + 0.1,
                           snr_db=20.0)
    streams = np.ascontiguousarray(
        np.stack([s.audio[:n * CHUNK] for s in streams]))
    sess = StreamingKwsSession(
        params, CONFIG, threshold=0.1, batch=B, numerics=numerics,
        detector=DetectorConfig(fire_threshold=DETECT_FIRE,
                                release_threshold=DETECT_RELEASE),
        vad=VADConfig(0.02))
    plain = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=B,
                                numerics=numerics)
    warm_session(sess, CHUNK)
    warm_session(plain, CHUNK)

    def run(s, field):
        s.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n):
            getattr(s.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK]),
                    field).cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    step_s = run(sess, "events")
    launches = {k: v // n for k, v in read_launches(wrappers).items() if v}
    summ = sess.summary()
    print(f"[always-on] detect {numerics}: {B} slots x {n} chunks of "
          f"{CHUNK} samples, VAD on: {step_s * 1e3:.3f} ms per step, "
          f"{summ.frames / (step_s * n):.0f} decisions/s, vad duty "
          f"{summ.vad_duty:.3f}, sparsity {summ.sparsity:.4f}, kernel "
          f"launches per step {launches} [{card}]")
    if summ.frames != B * n * CHUNK // 128:
        fail(f"detect always-on phase counted {summ.frames} decisions")
    rounds = [(run(plain, "votes"), run(sess, "events")) for _ in range(3)]
    med = [statistics.median(r[i] for r in rounds) for i in (0, 1)]
    print(f"[always-on] detect {numerics} vs plain on the same audio, 3 "
          f"alternating rounds: plain "
          f"{', '.join(f'{p * 1e3:.3f}' for p, _ in rounds)} ms, detect "
          f"{', '.join(f'{d * 1e3:.3f}' for _, d in rounds)} ms per step; "
          f"medians {med[0] * 1e3:.3f} / {med[1] * 1e3:.3f} ms "
          f"({med[1] / med[0]:.2f}x); the non-detect always-on step of this "
          f"run {plain_step_s * 1e3:.3f} ms [{card}]")
    if profile:
        profile_steps(torch, plain, streams, f"plain {numerics} (same audio)")
        profile_steps(torch, sess, streams, f"detect {numerics}")
    return {"step_ms": step_s * 1e3, "plain_ms": med[0] * 1e3,
            "detect_ms": med[1] * 1e3}


# ------------------------------------------------------ cascade phases --
MASK_T = (1, 32, 100)          # masked kernels: frames per chunk
MASK_B = (1, 3, 33, ALWAYS_ON_SLOTS)
MASK_DUTIES = (0.1, 0.5, 0.9)
# Wake / sleep / hangover of the served and timed cascade runs: the random
# stage 0 scores 0.5 exactly while its h is zero (VAD-held silence) and
# up to ~0.65 on speech, so these wake it around speech only.
CASCADE_SERVE = (0.55, 0.52, 15)
# The CUDA-vs-CPU check: slots wake and sleep on its 4 streams, and its
# CPU scores lie more than SCORE_MARGIN from both thresholds (checked), so
# a float score on the card, within ~1e-6 of the CPU's, decides alike.
CASCADE_CHECK = (0.6, 0.58, 4)
SCORE_MARGIN = 1e-4
S0_CHANNELS, S0_TH = 4, 0.05


def awake_masks(torch, gen, T, B):
    """The wake traces the masked kernels are held to their plain versions
    on: awake and asleep everywhere, random per slot and frame at three
    duties, and a random one whose first and last frames are asleep."""
    rand = lambda: torch.rand((T, B), generator=gen, device="cuda")
    masks = {"all awake": torch.ones((T, B), dtype=torch.bool,
                                     device="cuda"),
             "all asleep": torch.zeros((T, B), dtype=torch.bool,
                                       device="cuda")}
    for d in MASK_DUTIES:
        masks[f"duty {d}"] = rand() < d
    ends = rand() < 0.5
    ends[0] = False
    ends[-1] = False
    masks["first and last frames asleep"] = ends
    return masks


def tiled(xs, T, B):
    """(T, B, ...) from a (T0, B0, ...) chunk, repeated over both axes."""
    reps = (-(-T // xs.shape[0]), -(-B // xs.shape[1])) + (1,) * (
        xs.dim() - 2)
    return xs.repeat(*reps)[:T, :B].contiguous()


def frozen_violations(torch, hs, st0, st, nzx, nzh, awake):
    """Count the places where an asleep frame did not freeze: its hs row
    must repeat the previous frame's h (the carried h at frame 0) bit for
    bit, its counts be 0, and a slot asleep throughout must end in its
    carried state bit for bit."""
    prev = torch.cat([st0[0][None], hs[:-1]])
    asleep = ~awake
    bad = int((hs != prev)[asleep].sum().item())
    bad += int(nzx[asleep].sum().item() + nzh[asleep].sum().item())
    still = asleep.all(0)
    for a, b in zip(st, st0):
        bad += int((a[still] != b[still]).sum().item())
    return bad


def compare_masked(torch, np, gru_res, fex_int_feats, bundle):
    """Both masked instantiations against their plain versions on the
    card: the float one within HS_ATOL (state within HS_ATOL of 1 + |x|),
    counts equal, and bit for bit against the unmasked kernel when awake
    everywhere; the integer one bit for bit.  Frozen rows and the final
    state of slots asleep throughout bit for bit in both.  At T = 1, 32,
    100 × B = 1, 3, 33, 256 × every trace of ``awake_masks``, from a
    carried state (one chunk of the unmasked kernel first); then two
    carried chunks; then the stage-0 width (I = 4, H = 16) in both
    kernels, unmasked, against the plain versions.  Returns the float
    kernel's largest hs error."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    gen = torch.Generator(device="cuda").manual_seed(23)
    gru, xs_f = gru_res["gru"], gru_res["xs_all"]        # (64, 32, 10)
    w, gfmt = bundle.gru, bundle.gfmt
    xs_i = fex_int_feats.movedim(1, 0).contiguous()      # (64, 32, 10)
    tcodes = gfmt.th_codes(0.1)
    H = gru.w_h.shape[0]
    worst = 0.0
    run_f = lambda xs, st, a: dgs.delta_gru_seq(xs, *st, gru.w_x, gru.w_h,
                                                0.1, awake=a)
    ref_f = lambda xs, st, a: dgs.delta_gru_seq_ref(xs, *st, gru.w_x,
                                                    gru.w_h, 0.1, a)
    run_i = lambda xs, st, a: dgs.delta_gru_seq_int(
        xs, *st, w.w_x, w.w_h, tcodes, fmt=gfmt, awake=a)
    ref_i = lambda xs, st, a: dgs.delta_gru_seq_int_ref(
        xs, *st, w.w_x, w.w_h, tcodes, fmt=gfmt, awake=a)
    for T in MASK_T:
        for B in MASK_B:
            # A carried state: the unmasked kernels over another chunk.
            f0 = tuple(dgs.delta_gru_seq(
                tiled(xs_f[32:], 32, B), *dg.init_delta_state(B, 10, H, gru),
                gru.w_x, gru.w_h, 0.1)[1])
            i0 = tuple(dgs.delta_gru_seq_int(
                tiled(xs_i[32:], 32, B),
                *fp.init_int_delta_state(B, 10, H, w), w.w_x, w.w_h, tcodes,
                fmt=gfmt)[1])
            xf, xi = tiled(xs_f, T, B), tiled(xs_i, T, B)
            res = {"float": [0.0, 0.0, 0, 0], "int8": [0, 0, 0]}
            for label, a in awake_masks(torch, gen, T, B).items():
                hk, sk, nxk, nhk = run_f(xf, f0, a)
                hp, sp, nxp, nhp = ref_f(xf, f0, a)
                torch.cuda.synchronize()
                r = res["float"]
                r[0] = max(r[0], (hk - hp).abs().max().item())
                r[1] = max(r[1], max(((x - y).abs() / (1.0 + y.abs()))
                                     .max().item() for x, y in zip(sk, sp)))
                r[2] += int((nxk != nxp).sum() + (nhk != nhp).sum())
                r[3] += frozen_violations(torch, hk, f0, sk, nxk, nhk, a)
                if label == "all awake":
                    hu, su, nxu, nhu = dgs.delta_gru_seq(
                        xf, *f0, gru.w_x, gru.w_h, 0.1)
                    same = torch.equal(hu, hk) and all(
                        torch.equal(x, y) for x, y in
                        zip((*su, nxu, nhu), (*sk, nxk, nhk)))
                    if not same:
                        fail(f"masked delta_gru_seq awake everywhere differs "
                             f"from the unmasked kernel at T={T} B={B}")
                ik = run_i(xi, i0, a)
                ip = ref_i(xi, i0, a)
                torch.cuda.synchronize()
                r = res["int8"]
                r[0] += int((ik[0] != ip[0]).sum())
                r[0] += sum(int((x != y).sum()) for x, y in zip(ik[1], ip[1]))
                r[1] += int((ik[2] != ip[2]).sum() + (ik[3] != ip[3]).sum())
                r[2] += frozen_violations(torch, ik[0], i0, ik[1], ik[2],
                                          ik[3], a)
            f, i = res["float"], res["int8"]
            print(f"[compare] masked ΔGRU T={T} B={B}, {len(MASK_DUTIES) + 3}"
                  f" traces: float hs max abs diff {f[0]:.3g}, state "
                  f"{f[1]:.3g} (bound {HS_ATOL}), nz mismatches {f[2]}, "
                  f"frozen-row violations {f[3]}; int8 code mismatches "
                  f"{i[0]}, nz {i[1]}, frozen-row violations {i[2]}")
            if f[0] > HS_ATOL or f[1] > HS_ATOL or f[2] or f[3] or any(i):
                fail(f"masked ΔGRU kernels differ at T={T} B={B}: {res}")
            worst = max(worst, f[0])
    # Two carried chunks, state from the kernel and from the plain version.
    a = awake_masks(torch, gen, 64, 33)["duty 0.5"]
    xf, xi = tiled(xs_f, 64, 33), tiled(xs_i, 64, 33)
    sk = sp = tuple(dg.init_delta_state(33, 10, H, gru))
    ik_st = ip_st = tuple(fp.init_int_delta_state(33, 10, H, w))
    errs = [0.0, 0]
    for c in range(2):
        sl = slice(32 * c, 32 * c + 32)
        hk, sk, _, _ = run_f(xf[sl].contiguous(), sk, a[sl].contiguous())
        hp, sp, _, _ = ref_f(xf[sl].contiguous(), sp, a[sl].contiguous())
        ik = run_i(xi[sl].contiguous(), ik_st, a[sl].contiguous())
        ip = ref_i(xi[sl].contiguous(), ip_st, a[sl].contiguous())
        ik_st, ip_st = ik[1], ip[1]
        torch.cuda.synchronize()
        errs[0] = max(errs[0], (hk - hp).abs().max().item())
        errs[1] += int((ik[0] != ip[0]).sum()) + sum(
            int((x != y).sum()) for x, y in zip(ik_st, ip_st))
    st_err = max(((x - y).abs() / (1.0 + y.abs())).max().item()
                 for x, y in zip(sk, sp))
    print(f"[compare] masked ΔGRU, two carried chunks of 32 frames, B=33, "
          f"duty 0.5: float hs {errs[0]:.3g}, final state {st_err:.3g}; "
          f"int8 mismatches {errs[1]}")
    if errs[0] > HS_ATOL or st_err > HS_ATOL or errs[1]:
        fail(f"masked ΔGRU over carried chunks: {errs}, {st_err}")
    # Stage 0's width in both kernels, unmasked.
    rng = np.random.default_rng(29)
    g0, x0 = random_gru(torch, np, rng, S0_CHANNELS, 16, ALWAYS_ON_SLOTS, 32)
    st = tuple(dg.init_delta_state(ALWAYS_ON_SLOTS, S0_CHANNELS, 16, g0))
    hk, sk, nxk, nhk = dgs.delta_gru_seq(x0, *st, g0.w_x, g0.w_h, S0_TH)
    hp, sp, nxp, nhp = dgs.delta_gru_seq_ref(x0, *st, g0.w_x, g0.w_h, S0_TH)
    w0, f0mt = fp.quantize_gru(dg.DeltaGRUParams(*(t.cpu() for t in g0)))
    w0 = fp.IntGruWeights(*(t.cuda() for t in w0))
    c0 = fp.to_code(x0, f0mt.feat_frac, 16, torch.int16).contiguous()
    s0 = tuple(fp.init_int_delta_state(ALWAYS_ON_SLOTS, S0_CHANNELS, 16, w0))
    t0 = f0mt.th_codes(S0_TH)
    ik = dgs.delta_gru_seq_int(c0, *s0, w0.w_x, w0.w_h, t0, fmt=f0mt)
    ip = dgs.delta_gru_seq_int_ref(c0, *s0, w0.w_x, w0.w_h, t0, fmt=f0mt)
    torch.cuda.synchronize()
    f_err = (hk - hp).abs().max().item()
    nz_m = int((nxk != nxp).sum() + (nhk != nhp).sum())
    i_m = sum(int((x != y).sum()) for x, y in
              zip((ik[0], *ik[1], ik[2], ik[3]), (ip[0], *ip[1], ip[2], ip[3])))
    print(f"[compare] stage-0 width I={S0_CHANNELS} H=16, B="
          f"{ALWAYS_ON_SLOTS} T=32: delta_gru_seq hs max abs diff "
          f"{f_err:.3g}, nz mismatches {nz_m}, transmitted "
          f"{int(nxp.sum() + nhp.sum())}; delta_gru_seq_int mismatches "
          f"{i_m}, transmitted {int(ip[2].sum() + ip[3].sum())}")
    if f_err > HS_ATOL or nz_m or i_m:
        fail("a ΔGRU kernel differs from its plain version at stage 0's "
             "width")
    return worst


def time_masked_duties(torch, gru_res, fex_int_feats, bundle):
    """Both masked instantiations at B = ALWAYS_ON_SLOTS, T = 32 on the
    serving inputs, by the trace's duty: every slot awake on the same
    frames (the first 0, 8, 16, 24 or 32), and random per slot and frame
    at duty 0.1, 0.5, 0.9, beside the unmasked kernel.  A launch lasts
    as long as its busiest CTA, i.e. its busiest stream's awake frames."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    gen = torch.Generator(device="cuda").manual_seed(31)
    B, T = ALWAYS_ON_SLOTS, 32
    gru, w, gfmt = gru_res["gru"], bundle.gru, bundle.gfmt
    xf = tiled(gru_res["xs_all"], T, B)
    xi = tiled(fex_int_feats.movedim(1, 0), T, B)
    H = gru.w_h.shape[0]
    sf = tuple(dg.init_delta_state(B, 10, H, gru))
    si = tuple(fp.init_int_delta_state(B, 10, H, w))
    th = gfmt.th_codes(0.1)
    calls = {"float32": lambda a: dgs.delta_gru_seq(
                 xf, *sf, gru.w_x, gru.w_h, 0.1, awake=a),
             "int8": lambda a: dgs.delta_gru_seq_int(
                 xi, *si, w.w_x, w.w_h, th, fmt=gfmt, awake=a)}
    traces = {}
    for n in (0, 8, 16, 24, 32):
        a = torch.zeros((T, B), dtype=torch.bool, device="cuda")
        a[:n] = True
        traces[f"first {n} frames, every slot"] = a
    for d in MASK_DUTIES:
        traces[f"random, duty {d}"] = torch.rand(
            (T, B), generator=gen, device="cuda") < d
    out = {}
    for numerics, call in calls.items():
        unmasked = graph_ms(torch, lambda: call(None))
        rows = []
        for label, a in traces.items():
            ms = graph_ms(torch, lambda: call(a))
            busiest = int(a.sum(0).max())
            rows.append((label, float(a.float().mean()), busiest, ms))
            print(f"[time] masked {numerics} ΔGRU B={B} T={T}, {label}: "
                  f"duty {rows[-1][1]:.3f}, busiest stream awake {busiest} "
                  f"frames: {ms:.4f} ms ({ms / unmasked:.2f}x the unmasked "
                  f"kernel's {unmasked:.4f} ms)")
        out[numerics] = {"unmasked": unmasked, "rows": rows}
    return out


WAKE_OPS_PER_FRAME = 60        # 2 exps ≈ 48, max, sum, division, compares


def wake_case(torch, gen, F, B, scale=1.0):
    """Stage-0-like logits: class 1 a random walk around class 0, so the
    posterior crosses the thresholds, wakes and sleeps."""
    x0 = torch.randn((F, B), generator=gen, device="cuda") * 0.1
    walk = torch.cumsum(torch.randn((F, B), generator=gen, device="cuda")
                        * 0.3 * scale, 0)
    return torch.stack([x0, x0 + walk], -1).contiguous()


def compare_wake_head(torch, np):
    """wake_head against its plain version (xla_softmax, then the closed
    form of the wake machine) bit for bit — trace, latch and countdown —
    at B = 32 and 256 over two carried chunks of 32 frames, at B = 1, 3,
    33 × F = 1, 3, 100, with hangover 0 and 15, wake = sleep, a NaN
    logit, ±1e30 logits, 3 and 32 classes, and carried states with the
    latch set; and that it refuses a plan it cannot run."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wake_head as wh
    from repro_torch.launch.streaming import CascadeConfig
    gen = torch.Generator(device="cuda").manual_seed(41)
    cases = []
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        for cfg in (CascadeConfig(0.6, 0.45, 15), CascadeConfig(0.55, 0.55, 0),
                    CascadeConfig(0.7, 0.3, 3)):
            cases.append((f"B={B} {tuple(cfg[:3])}", cfg,
                          [wake_case(torch, gen, 32, B) for _ in range(2)]))
    for B in (1, 3, 33):
        for F in (1, 3, 100):
            cases.append((f"B={B} F={F}", CascadeConfig(0.6, 0.5, 4),
                          [wake_case(torch, gen, F, B)]))
    odd = wake_case(torch, gen, 32, 33)
    odd[3, 5, 1] = float("nan")
    odd[7, 6, 0] = 1e30
    odd[8, 7, 1] = -1e30
    cases.append(("NaN and ±1e30 logits", CascadeConfig(0.6, 0.5, 4), [odd]))
    for K in (3, 32):
        lg = torch.randn((32, 33, K), generator=gen, device="cuda")
        cases.append((f"K={K}", CascadeConfig(0.2, 0.1, 2), [lg]))
    awake_frames = total = 0
    for label, cfg, chunks in cases:
        B = chunks[0].shape[1]
        start = (torch.rand(B, generator=gen, device="cuda") < 0.5,
                 torch.randint(0, cfg.hangover_frames + 1, (B,),
                               generator=gen, device="cuda",
                               dtype=torch.int32))
        start = (start[0], torch.where(start[0], start[1], 0))
        k_st = p_st = start
        mism = 0
        for lg in chunks:
            tk, *k_st = wh.wake_head(lg, *k_st, cfg)
            tp, *p_st = wh.wake_head_ref(lg, *p_st, cfg)
            torch.cuda.synchronize()
            mism += int((tk != tp).sum()) + sum(
                int((a != b).sum()) for a, b in zip(k_st, p_st))
            awake_frames += int(tp.sum())
            total += tp.numel()
        if mism:
            fail(f"wake_head {label}: {mism} outputs differ from the plain "
                 f"version")
    print(f"[compare] wake_head vs its plain version, {len(cases)} cases "
          f"(B = 1..256, F = 1..100, two carried chunks, hangover 0 / 3 / "
          f"4 / 15, wake = sleep, NaN and ±1e30 logits, K = 2, 3, 32): "
          f"traces, latches and countdowns equal bit for bit; awake "
          f"{awake_frames} of {total} frame-slots")
    if not 0 < awake_frames < total:
        fail("wake_head cases never woke or never slept")
    lib, fn = wh._launcher()
    lg = wake_case(torch, gen, 4, 8)
    a = torch.zeros(8, dtype=torch.bool, device="cuda")
    h = torch.zeros(8, dtype=torch.int32, device="cuda")
    t = torch.empty((4, 8), dtype=torch.bool, device="cuda")
    err = fn(lg.data_ptr(), a.data_ptr(), h.data_ptr(), 0.5, 0.4, 3,
             t.data_ptr(), a.data_ptr(), h.data_ptr(), 4, 8, 2, 1, 16,
             torch.cuda.current_stream().cuda_stream)
    if err == 0:
        fail("wake_head ran a plan of 16 threads per CTA")


def time_wake_head(torch):
    """wake_head at the serving shapes (F = 32, K = 2, B = 32 and 256):
    kernel (device and per call), plain version, the bound from the
    shapes, and the launch floor (an empty kernel at its launch shape)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wake_head as wh
    from repro_torch.launch.streaming import CascadeConfig
    gen = torch.Generator(device="cuda").manual_seed(43)
    cfg = CascadeConfig(*CASCADE_SERVE)
    lib = build.load("wake_head")
    floor = lib.wake_head_floor_launch
    floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for B in (SLOTS, ALWAYS_ON_SLOTS):
        lg = wake_case(torch, gen, 32, B)
        a = torch.zeros(B, dtype=torch.bool, device="cuda")
        h = torch.zeros(B, dtype=torch.int32, device="cuda")
        ms, call = kernel_ms(torch, lambda: wh.wake_head(lg, a, h, cfg))
        plain = cuda_ms(torch, lambda: wh.wake_head_ref(lg, a, h, cfg), 10,
                        warmup=2)
        grid, block = wh.wake_launch_plan(B, 2)

        def empty():
            build.check(lib, floor(grid, block,
                                   torch.cuda.current_stream().cuda_stream),
                        "wake_head floor launch")
        fl = graph_ms(torch, empty)
        bnd, by = bound(4 * 32 * B * 2 + 32 * B + 2 * 5 * B,
                        32 * B * WAKE_OPS_PER_FRAME)
        out[B] = dict(ms=ms, call=call, plain=plain, floor=fl, bound=bnd,
                      by=by)
        print(f"[time] wake_head B={B} F=32 K=2: kernel {ms:.4f} ms on the "
              f"device ({call:.4f} ms per call with the wrapper), plain "
              f"{plain:.2f} ms per call, bound {bnd:.6f} ms ({by}); launch "
              f"floor (empty kernel, {grid} CTAs of {block}) {fl:.4f} ms — "
              f"the kernel at {ms / fl:.2f}x the floor")
    return out


def masked_bound(T, B, I, H, nz_total, n_awake, integer: bool):
    """The masked instantiations: x, the trace and hs of every frame-slot
    and the weights and state once, the transmitted rows' multiply-adds
    and the gates of the awake frame-slots only (an asleep one stores h)."""
    N = 3 * H
    if integer:
        state = B * (2 * (H + I + H) + 4 * 2 * N)
        moved = (2 * T * B * I + (I + H) * N + 2 * state + 2 * T * B * H
                 + 2 * 4 * T * B + T * B)
        ops = (2 * N * nz_total + n_awake * (
            3 * (I + H) + 2 * N * COL_INT_OPS + GATE_INT_OPS_PER_UNIT * H))
        return bound(moved, ops, INT32_OPS)
    state = B * (H + I + H + N + N)
    moved = (4 * (T * B * I + (I + H) * N + 2 * state + T * B * H + 2 * T * B)
             + T * B)
    flops = 2 * N * nz_total + n_awake * (3 * (I + H) + 2 * N
                                          + GATE_OPS_PER_UNIT * H)
    return bound(moved, flops)


class capture_args:
    """Within the block, record the arguments of each call of
    ``module.name`` (the session steps call it through the module)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def cascade_config(cfg=CASCADE_SERVE):
    from repro_torch.launch.streaming import CascadeConfig
    return CascadeConfig(wake_threshold=cfg[0], sleep_threshold=cfg[1],
                         hangover_frames=cfg[2], s0_threshold=S0_TH,
                         s0_channels=S0_CHANNELS)


def stage0(torch):
    """The serve CLI's stage-0 model (16 units, binary head, seed 7)."""
    from repro_torch.launch import serve
    return serve.stage0_params(serve.build_parser().parse_args([]))


def serve_cascade(torch, numerics: str):
    """Serve kws-cascade through the CLI's entry point at full width on
    SLOTS slots × 30 s streams, every kernel's count set to 0 just before
    and read just after: the numerics' FEx kernel, its ΔGRU kernel
    unmasked (stage 0), wake_head, its masked instantiation (stage 1) and
    detect_head once per step (+ the warm-up step), nothing else.
    Returns the path's launches."""
    from repro_torch.launch import serve
    from repro_torch.launch.streaming import HEALTH_SAT
    wrappers = kernel_wrappers()
    gru = "delta_gru_seq_int" if numerics == "int8" else "delta_gru_seq"
    path = ("batched_iir_fex_int" if numerics == "int8"
            else "batched_iir_fex", gru, "wake_head", f"{gru} (masked)",
            "detect_head")
    wake, sleep, hang = CASCADE_SERVE
    args = detect_args(numerics, SLOTS, DETECT_SECONDS, (
        "--wake-threshold", str(wake), "--sleep-threshold", str(sleep),
        "--hangover-frames", str(hang)))
    args.mode = "kws-cascade"
    serve.validate_args(args)
    zero_launches(wrappers)
    sess, point, stats, dt, n_samples = serve.serve_kws_detect(args)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    summ = sess.summary()
    slo = stats["slo"]
    print(f"[serve] kws-cascade {numerics}: {SLOTS} slots x "
          f"{n_samples / 8000:.0f} s, {stats['steps']} steps in {dt:.2f} s "
          f"(warm-up {stats['warmup_s']:.2f} s), step p50 "
          f"{slo['step_ms']['p50']:.2f} ms, "
          f"{slo['decisions'] / slo['steady_state_s']:.0f} decisions/s; "
          f"{point.n_events} events, {point.hits} hits, {point.misses} "
          f"misses, {point.false_alarms} false alarms "
          f"({point.fa_per_hour:.1f} FA/hr), stage-1 duty "
          f"{summ.stage1_duty:.3f} ({summ.frames_entered_stage1}/"
          f"{summ.frames}), vad duty {summ.vad_duty:.3f}, sparsity "
          f"{summ.sparsity:.4f}, {summ.energy_nj_per_decision:.1f} "
          f"nJ/decision (stage-0 {summ.s0_energy_nj_per_decision:.2f}), "
          f"launches {launches}")
    want = stats["steps"] + 1                   # + the warm-up step
    if any(launches[k] != want for k in path) or any(
            v for k, v in launches.items() if k not in path):
        fail(f"the {numerics} cascade path must launch {path} once per "
             f"step ({want}) and nothing else: {launches}")
    if summ.frames != SLOTS * (n_samples // 128):
        fail(f"kws-cascade counted {summ.frames} decisions")
    if not 0.0 < summ.stage1_duty < 1.0:
        fail(f"kws-cascade stage-1 duty {summ.stage1_duty}")
    if point.hits + point.false_alarms == 0:
        fail(f"kws-cascade fired nothing: {point}")
    bad = {k: f for k, f in sess.unhealthy_slots().items()
           if f & ~HEALTH_SAT}
    if bad:
        fail(f"unhealthy slots after kws-cascade: {bad}")
    return {k: launches[k] for k in path}


def check_cascade_against_cpu(torch, np, params, numerics: str):
    """A full-width CUDA cascade session against the CPU one (the plain
    versions, which the CPU tests hold against the JAX package) on 4
    continuous streams × 12000 samples in unaligned chunks, with wakes,
    sleeps and fires.  int8: every logit code, vote, count, awake bit,
    event, gate and state equal; float: awake traces, events, gates,
    votes and counts equal, logits within 1e-4, and the CPU's stage-0
    scores more than SCORE_MARGIN from both thresholds."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import make_streams
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.launch import streaming
    from repro_torch.models.detector import DetectorConfig
    streams = make_streams(7, 4, duration_s=1.5, snr_db=20.0,
                           events_per_min=60.0)
    audio = np.stack([s.audio for s in streams])
    det = DetectorConfig(0.3, 0.095, 0.09, 4)
    p0 = stage0(torch)
    outs, states, summ = {}, {}, {}
    for dev in ("cuda", "cpu"):
        sess = streaming.StreamingKwsSession(
            params, CONFIG, threshold=0.1, batch=4, device=dev,
            numerics=numerics, detector=det, vad=VADConfig(0.02),
            cascade=cascade_config(CASCADE_CHECK), stage0_params=p0)
        with capture_args(streaming, "cascade_wake_scan") as cap:
            parts = [sess.process_audio(audio[:, lo:hi])
                     for lo, hi in ((0, 5000), (5000, 5001), (5001, 12000))]
        outs[dev] = {f: torch.cat([getattr(p, f) for p in parts]).cpu()
                     for f in parts[0]._fields}
        cas = sess.cas_state
        states[dev] = [t.cpu() for t in (*sess.state, cas.awake, cas.hang,
                                         *cas.s0)]
        if dev == "cpu":           # the CUDA session runs wake_head
            scores = torch.cat([a[3] for a, _ in cap.calls])
        summ[dev] = sess.summary()
    c, p = outs["cuda"], outs["cpu"]
    err = (c["logits"] - p["logits"]).abs().max().item()
    mism = {f: int((c[f] != p[f]).sum())
            for f in ("votes", "nz", "events", "gate", "awake")}
    state_m = sum(int((a != b).sum()) for a, b in
                  zip(states["cuda"], states["cpu"])
                  if not a.is_floating_point())
    state_err = max((a.float() - b.float()).abs().max().item() for a, b in
                    zip(states["cuda"], states["cpu"]))
    awake, events = p["awake"], p["events"]
    sleeps = int(((awake[:-1] & ~awake[1:]).sum()).item())
    margin = min((scores - t).abs().min().item() for t in CASCADE_CHECK[:2])
    fires = int((events >= 0).sum())
    print(f"[check] {numerics} cascade session CUDA vs CPU, 4 streams x "
          f"12000 samples: logits max abs diff {err:.3g}, mismatches "
          f"{mism}, integer state elements differing {state_m}, float state "
          f"max abs diff {state_err:.3g}, stage-1 duty "
          f"{summ['cuda'].stage1_duty:.3f} / {summ['cpu'].stage1_duty:.3f}, "
          f"wakes to sleep {sleeps}, fires {fires}, CPU scores' least "
          f"distance to a threshold {margin:.3g}")
    if any(mism.values()) or state_m or fires == 0 or sleeps == 0:
        fail(f"{numerics} cascade session disagrees with the CPU one or "
             f"never slept / fired")
    if summ["cuda"].frames_entered_stage1 != summ["cpu"].frames_entered_stage1:
        fail("the CUDA and CPU cascade sessions count different duties")
    if (events[~awake] != -1).any() or not 0 < awake.float().mean() < 1:
        fail(f"{numerics} cascade: events on asleep frames or a trivial "
             f"duty")
    if numerics == "int8" and (err or state_err):
        fail(f"int8 cascade session: logits {err}, state {state_err}")
    if not (err <= 1e-4 and state_err <= 1e-4):
        fail(f"float cascade session: logits {err}, state {state_err}")
    if numerics == "float32" and margin <= SCORE_MARGIN:
        fail(f"a stage-0 score lies {margin} from a threshold")


def cascade_always_on(torch, np, params, card, profile: bool,
                      numerics: str, detect_ms: float):
    """The always-on phase through the cascade: ALWAYS_ON_SLOTS continuous
    streams × ALWAYS_ON_CHUNKS chunks of CHUNK samples (the detect phase's
    audio), VAD on: step time, decisions/s, stage-1 duty and kernel
    launches per step; then three rounds alternating the detect session
    and the cascade session on the same audio; then the masked kernel's
    device time on one step's own inputs at the run's duty, beside the
    same call awake everywhere, the unmasked kernel and the plain
    version."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.data.continuous import make_streams
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.launch.engine import warm_session
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    B, n = ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS
    streams = make_streams(200, B, duration_s=n * CHUNK / 8000 + 0.1,
                           snr_db=20.0)
    streams = np.ascontiguousarray(
        np.stack([s.audio[:n * CHUNK] for s in streams]))
    det = DetectorConfig(fire_threshold=DETECT_FIRE,
                         release_threshold=DETECT_RELEASE)
    sess = StreamingKwsSession(
        params, CONFIG, threshold=0.1, batch=B, numerics=numerics,
        detector=det, vad=VADConfig(0.02), cascade=cascade_config(),
        stage0_params=stage0(torch))
    detect = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=B,
                                 numerics=numerics, detector=det,
                                 vad=VADConfig(0.02))
    warm_session(sess, CHUNK)
    warm_session(detect, CHUNK)

    def run(s):
        s.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n):
            s.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK]).events.cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    step_s = run(sess)
    launches = {k: v // n for k, v in read_launches(wrappers).items() if v}
    summ = sess.summary()
    print(f"[always-on] cascade {numerics}: {B} slots x {n} chunks of "
          f"{CHUNK} samples, VAD on: {step_s * 1e3:.3f} ms per step, "
          f"{summ.frames / (step_s * n):.0f} decisions/s, stage-1 duty "
          f"{summ.stage1_duty:.3f}, vad duty {summ.vad_duty:.3f}, sparsity "
          f"{summ.sparsity:.4f}, kernel launches per step {launches} "
          f"[{card}]")
    if summ.frames != B * n * CHUNK // 128:
        fail(f"cascade always-on phase counted {summ.frames} decisions")
    if not 0.0 < summ.stage1_duty < 1.0:
        fail(f"cascade always-on stage-1 duty {summ.stage1_duty}")
    rounds = [(run(detect), run(sess)) for _ in range(3)]
    med = [statistics.median(r[i] for r in rounds) for i in (0, 1)]
    print(f"[always-on] cascade {numerics} vs detect on the same audio, 3 "
          f"alternating rounds: detect "
          f"{', '.join(f'{d * 1e3:.3f}' for d, _ in rounds)} ms, cascade "
          f"{', '.join(f'{c * 1e3:.3f}' for _, c in rounds)} ms per step; "
          f"medians {med[0] * 1e3:.3f} / {med[1] * 1e3:.3f} ms "
          f"({med[1] / med[0]:.2f}x); the detect phase's own step "
          f"{detect_ms:.3f} ms [{card}]")
    if profile:
        profile_steps(torch, detect, streams, f"detect {numerics} (same "
                      f"audio)")
        profile_steps(torch, sess, streams, f"cascade {numerics}")
    # One step's stage-1 call, replayed alone at this run's duty.
    mod, name = ((fp, "masked_int_gru_scan") if numerics == "int8"
                 else (dg, "masked_delta_gru_scan"))
    sess.reset()
    for c in range(n // 2):
        sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK])
    with capture_args(mod, name) as cap:
        sess.process_audio(streams[:, (n // 2) * CHUNK:(n // 2 + 1) * CHUNK])
    args, _ = cap.calls[-1]
    if numerics == "int8":
        w, gfmt, xs, th, st, awake = args
        th = gfmt.th_codes(th)
        call = lambda a: dgs.delta_gru_seq_int(xs, *st, w.w_x, w.w_h, th,
                                               fmt=gfmt, awake=a)
        plain = lambda: dgs.delta_gru_seq_int_ref(xs, *st, w.w_x, w.w_h, th,
                                                  fmt=gfmt, awake=awake)
    else:
        g, xs, th, st, awake = args
        call = lambda a: dgs.delta_gru_seq(xs, *st, g.w_x, g.w_h, th,
                                           awake=a)
        plain = lambda: dgs.delta_gru_seq_ref(xs, *st, g.w_x, g.w_h, th,
                                              awake)
    T, Bs, I = xs.shape
    H = st[0].shape[1]
    ones = torch.ones_like(awake)
    _, _, nzx, nzh = call(awake)
    nz_total = int(nzx.sum() + nzh.sum())
    n_awake = int(awake.sum())
    duty = n_awake / awake.numel()
    ms = graph_ms(torch, lambda: call(awake))
    ms_all = graph_ms(torch, lambda: call(ones))
    ms_plain_kernel = graph_ms(torch, lambda: call(None))
    plain_ms = cuda_ms(torch, plain, 5, warmup=1)
    bnd, by = masked_bound(T, Bs, I, H, nz_total, n_awake,
                           numerics == "int8")
    busiest = int(awake.sum(0).max())
    rows = busiest_rows(nzx, nzh, max(busiest, 1))
    print(f"[time] masked {'delta_gru_seq_int' if numerics == 'int8' else 'delta_gru_seq'}"
          f" on one cascade step's inputs (T={T} B={Bs} I={I} H={H}): at "
          f"this run's duty {duty:.3f} {ms:.4f} ms, awake everywhere "
          f"{ms_all:.4f} ms, the unmasked instantiation {ms_plain_kernel:.4f}"
          f" ms (device); plain version {plain_ms:.2f} ms; bound {bnd:.5f} "
          f"ms ({by}); the busiest stream is awake {busiest} of {T} frames "
          f"and sends {rows[0]} x + {rows[1]} h rows per awake frame "
          f"[{card}]")
    return {"step_ms": step_s * 1e3, "detect_ms": med[0] * 1e3,
            "cascade_ms": med[1] * 1e3, "duty": summ.stage1_duty,
            "launches": launches, "ms": ms, "ms_awake": ms_all,
            "ms_unmasked": ms_plain_kernel, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "step_duty": duty,
            "busiest_awake": busiest, "rows": rows, "shape":
            f"T={T} B={Bs} I={I} H={H}"}


def event_driven_on_card(torch, np, params, numerics: str):
    """``event_driven=True`` on the card on VAD-held input: a detect
    session runs 256 mostly silent continuous streams for 6 chunks; the
    seventh step's ΔGRU call (its gated features and carried state) is
    replayed dense and event-driven.  hs, the final state and both counts
    must be equal bit for bit; int8 must skip slots."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.data.continuous import make_streams
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.kernels import compaction
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    B, n = ALWAYS_ON_SLOTS, 7
    streams = make_streams(300, B, duration_s=n * CHUNK / 8000 + 0.1,
                           snr_db=20.0, events_per_min=6.0)
    audio = np.stack([s.audio[:n * CHUNK] for s in streams])
    sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=B,
                               numerics=numerics, detector=DetectorConfig(),
                               vad=VADConfig(0.02))
    for c in range(n - 1):
        sess.process_audio(audio[:, c * CHUNK:(c + 1) * CHUNK])
    mod, name = ((fp, "int_gru_scan") if numerics == "int8"
                 else (dg, "delta_gru_scan"))
    with capture_args(mod, name) as cap:
        sess.process_audio(audio[:, (n - 1) * CHUNK:])
    args, kw = cap.calls[-1]
    dense = getattr(mod, name)(*args, **kw)
    compaction.reset_counters()
    event = getattr(mod, name)(*args, **kw, event_driven=True)
    torch.cuda.synchronize()
    c = compaction.counters()
    if numerics == "int8":
        pairs = [(dense[0], event[0]), *zip(dense[1], event[1]),
                 (dense[2], event[2]), (dense[3], event[3])]
    else:
        pairs = [(dense[0], event[0]), *zip(dense[1], event[1]),
                 (dense[2].nz_dx, event[2].nz_dx),
                 (dense[2].nz_dh, event[2].nz_dh)]
    differ = sum(int((bits_view(torch, a) != bits_view(torch, b)).sum())
                 for a, b in pairs)
    print(f"[check] event_driven {numerics} on VAD-held input (B={B}, "
          f"T={args[2 if numerics == 'int8' else 1].shape[0]}): bits "
          f"differing from the dense scan {differ}; slots skipped "
          f"{c['slots_skipped']} of {c['slots_total']}, frames entered "
          f"{c['frames_entered']} of {c['frames_total']} (probe "
          f"{c['probe_frames']})")
    if differ:
        fail(f"event_driven {numerics} differs from the dense scan")
    if numerics == "int8" and c["slots_skipped"] == 0:
        fail("event_driven int8 skipped no slot on VAD-held input")
    return c


# ------------------------------ fault handling, overload and the engine --
FAULT_SLOTS, FAULT_CHUNK, FAULT_STEPS = 4, 512, 24
SOAK_CHUNKS_PER_UTT = 2
SOAK_STEPS = (4, 60, 24)                  # warm-up, faulty, cooldown
SOAK_LADDER, SOAK_QUEUE, SOAK_SEED = (0.1, 0.4), 512, 7
SERVE_FAULTS = ("nan_burst:0.05,dup_chunk:0.05,one_sample_chunk:0.05,"
                "churn_storm:0.05")
# A replay seed under which every armed kind fires within the kws-audio
# run's five steps (at these rates most seeds fire one kind or none).
SERVE_FAULT_SEED = 704
SERVE_FAULT_SECONDS = 10.0                # kws-detect / kws-cascade streams
TH_SCHEDULE = (0.1, 0.4, 0.1)             # set_threshold, chunk by chunk
TH_SPANS = ((0, 4000), (4000, 8000), (8000, 12000))


class Failures:
    """Collects a phase's failed checks, so one run reports them all;
    ``raise_any`` fails the run at the phase's end."""

    def __init__(self, phase):
        self.phase, self.msgs = phase, []

    def check(self, ok, msg):
        if not ok:
            print(f"[FAIL] {msg}")
            self.msgs.append(msg)

    def raise_any(self):
        if self.msgs:
            fail(f"{self.phase}: {len(self.msgs)} checks failed: "
                 + "; ".join(self.msgs))


def compare_nan_semantics(torch, np, gru_res, bundle):
    """NaN on the card as the reference treats it.  The float ΔGRU kernel
    on features with NaN rows (whole rows, part of the first frame's row,
    one channel of the last frame) against its plain version: NaN
    positions equal and their bits too, everything else within HS_ATOL
    (the state relative to 1 + |x|), transmit counts equal, and no NaN
    transmitted (x̂, h and M stay finite).  ``fp.to_code`` of NaN, -NaN
    and ±Inf audio after the 12-bit quantizer, as the int8 step computes
    it, on CUDA against the CPU: every code equal (XLA and the CPU give
    0 for NaN)."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.core.quantize import quantize_audio_12b
    from repro_torch.kernels import delta_gru_seq as dgs
    gru = gru_res["gru"]
    xs = gru_res["xs"].clone()                          # (T, B, I)
    T, B, I = xs.shape
    H = gru.w_h.shape[0]
    nan = float("nan")
    xs[3:7, 1] = nan
    xs[0, 2, :3] = nan
    xs[T - 1, 5, 4] = nan
    st0 = dg.init_delta_state(B, I, H, gru)
    hk, sk, nxk, nhk = dgs.delta_gru_seq(xs, *st0, gru.w_x, gru.w_h, 0.1)
    hp, sp, nxp, nhp = dgs.delta_gru_seq_ref(xs, *st0, gru.w_x, gru.w_h, 0.1)
    torch.cuda.synchronize()
    nan_m = nan_bits = 0
    err = 0.0
    for a, b, rel in ((hk, hp, False), *((x, y, True)
                                         for x, y in zip(sk, sp))):
        na, nb = torch.isnan(a), torch.isnan(b)
        nan_m += int((na != nb).sum())
        both = na & nb
        nan_bits += bits_differ(torch, a[both], b[both])
        fin = ~(na | nb)
        d = (a[fin] - b[fin]).abs()
        if rel:
            d = d / (1.0 + b[fin].abs())
        err = max(err, d.max().item() if d.numel() else 0.0)
    nz_m = int((nxk != nxp).sum() + (nhk != nhp).sum())
    finite = all(bool(torch.isfinite(t).all()) for t in (*sk, hk))
    print(f"[compare] delta_gru_seq on NaN feature rows (T={T} B={B}): NaN "
          f"position mismatches {nan_m}, NaN bits differing {nan_bits}, max "
          f"diff elsewhere {err:.3g}, nz mismatches {nz_m}, hs and state "
          f"finite {finite}")
    if nan_m or nan_bits or err > HS_ATOL or nz_m or not finite:
        fail("the float ΔGRU kernel handles NaN features unlike its plain "
             "version or transmits a NaN")
    vals = [nan, -nan, float("inf"), float("-inf"), 0.5, -1.5, 2.0,
            1.0 - 2.0 ** -12, -0.0, 1e-30]
    audio = torch.tensor(vals, dtype=torch.float32).repeat(3, 40)
    codes = {}
    for dev in ("cuda", "cpu"):
        q = quantize_audio_12b(audio.to(dev).float())
        codes[dev] = fp.to_code(q, bundle.ffmt.feat_frac, 16,
                                torch.int16).cpu()
    mism = int((codes["cuda"] != codes["cpu"]).sum())
    print(f"[compare] fp.to_code of NaN / -NaN / ±Inf audio: CUDA codes "
          f"{codes['cuda'][0, :len(vals)].tolist()}, CPU "
          f"{codes['cpu'][0, :len(vals)].tolist()}, mismatches {mism}")
    if mism or codes["cuda"][0, 0] != 0 or codes["cuda"][0, 1] != 0:
        fail("fp.to_code of NaN audio on CUDA differs from the CPU's 0")


def fault_audio(np, slots, n_samples, seed):
    from repro_torch.data.continuous import make_streams
    streams = make_streams(seed, slots, duration_s=n_samples / 8000 + 0.1,
                           snr_db=20.0, events_per_min=60.0)
    return np.stack([s.audio[:n_samples] for s in streams])


def check_faults_against_cpu(torch, np, params, numerics, bad):
    """A CUDA session against the CPU session under one fault campaign:
    FAULT_SLOTS slots × FAULT_CHUNK-sample chunks, FAULT_STEPS steps of
    ``adversarial_plan(SOAK_SEED)`` (each step's pieces, then its churn
    resets), the supervisor on, input policy trust.  Every vote, transmit
    count, per-step health mask, flagged set, recovery count and reason
    equal; int8 logits equal, float within 1e-4."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.faults import FaultInjector, adversarial_plan
    from repro_torch.launch.streaming import (StreamingKwsSession,
                                              SupervisorConfig)
    audio = fault_audio(np, FAULT_SLOTS, FAULT_CHUNK * FAULT_STEPS, 11)
    runs = {}
    for dev in ("cuda", "cpu"):
        sess = StreamingKwsSession(
            params, CONFIG, threshold=0.1, batch=FAULT_SLOTS, device=dev,
            numerics=numerics, supervisor=SupervisorConfig(),
            input_policy="trust")
        inj = FaultInjector(adversarial_plan(SOAK_SEED), FAULT_SLOTS)
        outs, health, kinds = [], [], []
        for step in range(FAULT_STEPS):
            pieces, actions = inj.inject(
                audio[:, step * FAULT_CHUNK:(step + 1) * FAULT_CHUNK])
            for p in pieces:
                o = sess.process_audio(p)
                outs.append([o.logits.cpu(), o.votes.cpu(), o.nz.cpu()])
                health.append((sess.unhealthy_slots(), sess.flagged_slots()))
            for act in actions:
                kinds.append(act.kind)
                if act.kind == "churn_storm":
                    sess.reset_streams(act.slots)
        s = sess.summary()
        runs[dev] = (outs, health, s.recoveries, s.recovery_reasons,
                     s.frames)
    (oc, hc, rc, rrc, fc), (op, hp, rp, rrp, fp_) = runs["cuda"], runs["cpu"]
    err = max(((a[0] - b[0]).abs().max().item() if a[0].numel() else 0.0)
              for a, b in zip(oc, op))
    vote_m = sum(int((a[1] != b[1]).sum() + (a[2] != b[2]).sum())
                 for a, b in zip(oc, op))
    health_m = sum(a != b for a, b in zip(hc, hp))
    print(f"[faults] {numerics} CUDA vs CPU session under adversarial_plan"
          f"({SOAK_SEED}), {FAULT_SLOTS} slots x {FAULT_STEPS} steps of "
          f"{FAULT_CHUNK} samples ({len(oc)} pieces; faults {kinds}): "
          f"logits max abs diff {err:.3g}, vote/nz mismatches {vote_m}, "
          f"health masks differing in {health_m} pieces, recoveries "
          f"{rc} {rrc} / {rp} {rrp}, frames {fc} / {fp_}")
    tol = 0.0 if numerics == "int8" else 1e-4
    bad.check(err <= tol and not vote_m and not health_m and rc == rp
              and rrc == rrp and fc == fp_ and rc >= 1,
              f"{numerics} CUDA session differs from the CPU one under "
              f"faults (or nothing recovered)")


def check_set_threshold(torch, np, params, numerics, bad):
    """``set_threshold`` mid-stream on the card (Δ_TH 0.1 → 0.4 → 0.1,
    chunk by chunk) against the CPU session doing the same, in a plain
    session and a cascade session: votes, counts, events and awake bits
    equal, int8 logits equal and float within 1e-4; the cascade's wake
    trace equal to that of a CUDA cascade session never switched (stage
    0 keeps its own Δ_TH), and its stage-0 state bit for bit too."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    audio = fault_audio(np, 4, TH_SPANS[-1][1], 7)
    p0 = stage0(torch)

    def run(dev, cascade, schedule):
        kw = (dict(detector=DetectorConfig(0.3, 0.095, 0.09, 4),
                   vad=VADConfig(0.02), cascade=cascade_config(CASCADE_CHECK),
                   stage0_params=p0) if cascade else {})
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1, batch=4,
                                   device=dev, numerics=numerics, **kw)
        outs = []
        for (lo, hi), th in zip(TH_SPANS, schedule):
            sess.set_threshold(th)
            o = sess.process_audio(audio[:, lo:hi])
            outs.append({f: getattr(o, f).cpu() for f in o._fields
                         if getattr(o, f) is not None})
        s0 = [t.cpu() for t in sess.cas_state.s0] if cascade else []
        return outs, s0, sess.summary()

    for cascade in (False, True):
        cu, s0c, sc = run("cuda", cascade, TH_SCHEDULE)
        cp, _, sp = run("cpu", cascade, TH_SCHEDULE)
        fixed, s0f, sf = run("cuda", cascade, (TH_SCHEDULE[0],) * 3)
        err = max((a["logits"] - b["logits"]).abs().max().item()
                  for a, b in zip(cu, cp))
        mism = sum(int((a[f] != b[f]).sum()) for a, b in zip(cu, cp)
                   for f in a if f != "logits")
        wake_m = sum(int((a["awake"] != b["awake"]).sum())
                     for a, b in zip(cu, fixed)) if cascade else 0
        s0_m = sum(int((a != b).sum()) for a, b in zip(s0c, s0f))
        kind = "cascade" if cascade else "plain"
        print(f"[faults] set_threshold {TH_SCHEDULE} {numerics} {kind} "
              f"session, CUDA vs CPU: logits max abs diff {err:.3g}, other "
              f"mismatches {mism}, sparsity {sc.sparsity:.4f} / "
              f"{sp.sparsity:.4f} (never switched: {sf.sparsity:.4f})"
              + (f"; wake trace vs the session never switched: {wake_m} "
                 f"bits differ, stage-0 state {s0_m}" if cascade else ""))
        tol = 0.0 if numerics == "int8" else 1e-4
        bad.check(err <= tol and not mism and not wake_m and not s0_m
                  and sc.sparsity == sp.sparsity
                  and sc.sparsity != sf.sparsity,
                  f"set_threshold {numerics} {kind} session differs from "
                  f"the CPU's, moved stage 0, or changed nothing")


def soak_session(params, numerics, **kw):
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.streaming import (StreamingKwsSession,
                                              SupervisorConfig)
    return StreamingKwsSession(params, CONFIG, threshold=SOAK_LADDER[0],
                               batch=ALWAYS_ON_SLOTS, numerics=numerics,
                               supervisor=SupervisorConfig(),
                               input_policy="trust", **kw)


def soak(torch, np, params, numerics, depth):
    """The reference's soak (``benchmarks/serve_bench.py --soak``) at full
    width: ALWAYS_ON_SLOTS slots × CHUNK-sample chunks, SOAK_CHUNKS_PER_UTT
    chunks per utterance, ``adversarial_plan(SOAK_SEED)``, SOAK_STEPS
    warm-up / faulty / cooldown steps, bursty arrival waves (4× the
    service rate for 8 of every 20 steps), the Δ_TH ladder SOAK_LADDER
    and a queue of SOAK_QUEUE, through ``PipelinedEngine`` at ``depth``.
    Returns the votes of every step (in dispatch order), the controller
    level after every step, the summary, the controller's stats and the
    gates of ``BENCH_soak.json`` but the recovery probe's."""
    from repro_torch.launch.engine import PipelinedEngine
    from repro_torch.launch.faults import FaultInjector, adversarial_plan
    from repro_torch.launch.serve import AdmissionController, OverloadPolicy
    from repro_torch.launch.streaming import QUARANTINE_DEFAULT, SlotScheduler
    slots, chunk, per_utt = ALWAYS_ON_SLOTS, CHUNK, SOAK_CHUNKS_PER_UTT
    sess = soak_session(params, numerics)
    sched = SlotScheduler(sess)
    eng = PipelinedEngine(sess, depth=depth, field="votes", scheduler=sched)
    ctl = AdmissionController(sess, sched, OverloadPolicy(
        thresholds=SOAK_LADDER, max_queue=SOAK_QUEUE))
    injector = FaultInjector(adversarial_plan(SOAK_SEED), slots)
    pool = np.random.default_rng(1).uniform(
        -0.5, 0.5, (slots, per_utt, chunk)).astype(np.float32)
    progress: dict[int, int] = {}
    st = {"req": 0, "frames_host": 0}
    votes, levels, lat_s, fired = [], [], [], {}

    def take(drained):
        for f in drained:
            votes.append(np.concatenate(f.arrays) if f.arrays
                         else np.zeros((0, slots), np.int32))

    def run_steps(n_steps, faulty, arrivals):
        for step in range(n_steps):
            for _ in range(arrivals(step)):
                ctl.submit(st["req"])
                st["req"] += 1
            for slot, _ in sched.admit():
                progress[slot] = 0
            t0 = time.perf_counter()
            eng.begin()
            block = np.zeros((slots, chunk), np.float32)
            for slot in sched.live:
                block[slot] = pool[slot, progress[slot] % per_utt]
            pieces, actions = (injector.inject(block) if faulty
                               else ([block], []))
            stalled = False
            for act in actions:
                fired[act.kind] = fired.get(act.kind, 0) + 1
                if act.kind == "stall":
                    stalled = True
                    time.sleep(act.detail)
                elif act.kind == "churn_storm":
                    storm = [s for s in act.slots if s in sched.live]
                    sess.reset_streams(storm)
                    for s in storm:
                        progress[s] = 0
            piece_frames, drained = eng.submit(pieces)
            st["frames_host"] += sum(piece_frames) * slots
            eng.end()
            dt = time.perf_counter() - t0
            if not stalled:
                lat_s.append(dt)
            take(drained)
            for slot in list(sched.live):
                progress[slot] += 1
                if progress[slot] >= per_utt:
                    sched.evict(slot)
            ctl.observe(dt)
            levels.append(ctl.level)

    steady = max(1, slots // per_utt)
    warm, faulty, cool = SOAK_STEPS
    run_steps(warm, False, lambda s: steady)
    run_steps(faulty, True, lambda s: steady * 4 if s % 20 < 8 else steady)
    run_steps(cool, False, lambda s: 0)
    take(eng.flush())
    torch.cuda.synchronize()
    summ = sess.summary()
    unrecovered = {s: m for s, m in sess.unhealthy_slots().items()
                   if m & QUARANTINE_DEFAULT}
    cst = ctl.stats()
    lat = np.asarray(lat_s[1:] or lat_s) * 1e3
    third = max(1, len(lat) // 3)
    drift = (float(np.median(lat[-third:]))
             / max(float(np.median(lat[:third])), 1e-9))
    gates = {
        "unrecovered_slots_zero": not unrecovered,
        "controller_at_base": ctl.level == 0,
        "controller_escalated": cst["escalations"] >= 1
        and cst["releases"] >= 1,
        "telemetry_exact": summ.frames == st["frames_host"]
        and not summ.overflowed,
        "latency_drift_ok": drift < 3.0,
    }
    return {"votes": votes, "levels": levels, "summary": summ,
            "controller": cst, "gates": gates, "faults": fired,
            "step_ms_p50": float(np.percentile(lat, 50)),
            "step_ms_p99": float(np.percentile(lat, 99)), "drift": drift}


def soak_recovery_probe(torch, np, params, numerics) -> bool:
    """The soak's recovery gate on dedicated sessions: slot 0 poisoned
    with NaN for half a chunk and healed by the supervisor decides the
    next two chunks bit for bit as a fresh session reset at the same
    point (and the supervisor recovered it)."""
    rng = np.random.default_rng(2)
    probe = rng.uniform(-0.5, 0.5, (3, ALWAYS_ON_SLOTS, CHUNK)).astype(
        np.float32)
    poison = probe[0].copy()
    poison[0, :CHUNK // 2] = np.nan
    healed = soak_session(params, numerics)
    healed.process_audio(poison)
    h = [healed.process_audio(p).votes.cpu() for p in probe[1:]]
    fresh = soak_session(params, numerics)
    fresh.process_audio(probe[0])
    fresh.reset_streams([0])
    f = [fresh.process_audio(p).votes.cpu() for p in probe[1:]]
    return (all(torch.equal(a, b) for a, b in zip(h, f))
            and healed.summary().recoveries >= 1)


def soak_phase(torch, np, params, card, bad):
    """The soak in both numerics at depth 1 and 2: every gate true, and
    depth 2 equal to depth 1 in every vote, controller level, recovery,
    reason and summary field (timing aside)."""
    out = {}
    for numerics in ("float32", "int8"):
        runs = {d: soak(torch, np, params, numerics, d) for d in (1, 2)}
        probe_ok = soak_recovery_probe(torch, np, params, numerics)
        r1, r2 = runs[1], runs[2]
        same = (len(r1["votes"]) == len(r2["votes"])
                and all(np.array_equal(a, b)
                        for a, b in zip(r1["votes"], r2["votes"]))
                and r1["levels"] == r2["levels"]
                and r1["controller"] == r2["controller"]
                and dataclasses.replace(r1["summary"], slo={})
                == dataclasses.replace(r2["summary"], slo={}))
        for d, r in runs.items():
            s = r["summary"]
            print(f"[soak] {numerics} depth {d}: {sum(SOAK_STEPS)} steps on "
                  f"{ALWAYS_ON_SLOTS} slots x {CHUNK}, faults {r['faults']}, "
                  f"{s.recoveries} recoveries {s.recovery_reasons}, "
                  f"sat_events {s.sat_events}, controller {r['controller']},"
                  f" levels seen {sorted(set(r['levels']))}, frames "
                  f"{s.frames}, step p50 {r['step_ms_p50']:.3f} / p99 "
                  f"{r['step_ms_p99']:.3f} ms, drift "
                  f"{r['drift']:.3f}, gates {r['gates']} [{card}]")
            for gate, ok in r["gates"].items():
                bad.check(ok, f"soak {numerics} depth {d}: {gate}")
        print(f"[soak] {numerics}: recovery bit-identical {probe_ok}; depth 2"
              f" equals depth 1 in every vote, level, recovery and summary "
              f"field: {same}")
        bad.check(probe_ok, f"soak {numerics}: recovery_bit_identical")
        bad.check(same, f"soak {numerics}: depth 2 differs from depth 1")
        out[numerics] = {d: {k: v for k, v in r.items() if k != "votes"}
                         for d, r in runs.items()}
    return out


def fault_serve_argv(mode, numerics, depth):
    argv = ["--mode", mode, "--numerics", numerics, "--slots", str(SLOTS),
            "--chunk-samples", str(CHUNK), "--init-seed", "0",
            "--train-steps", "0", "--faults",
            SERVE_FAULTS, "--fault-seed", str(SERVE_FAULT_SEED)]
    if depth == 1:
        argv.append("--sync-loop")
    if mode == "kws-audio":
        return argv + ["--requests", str(REQUESTS), "--degrade-thresholds",
                       "0.2,0.4", "--max-queue", "48"]
    argv += ["--stream-seconds", str(SERVE_FAULT_SECONDS),
             "--fire-threshold", str(DETECT_FIRE), "--release-threshold",
             str(DETECT_RELEASE)]
    if mode == "kws-cascade":
        wake, sleep, hang = CASCADE_SERVE
        argv += ["--wake-threshold", str(wake), "--sleep-threshold",
                 str(sleep), "--hangover-frames", str(hang)]
    return argv


def fault_path(mode, numerics):
    gru = "delta_gru_seq_int" if numerics == "int8" else "delta_gru_seq"
    fex = "batched_iir_fex_int" if numerics == "int8" else "batched_iir_fex"
    return {"kws-audio": (fex, gru),
            "kws-detect": (fex, gru, "detect_head"),
            "kws-cascade": (fex, gru, "wake_head", f"{gru} (masked)",
                            "detect_head")}[mode]


def serve_faulty(torch, wrappers, mode, numerics, depth):
    """One ``serve --faults`` run through the CLI's entry points, with
    every kernel's count set to 0 just before and read just after."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        fault_serve_argv(mode, numerics, depth))
    serve.validate_args(args)
    zero_launches(wrappers)
    if mode == "kws-audio":
        sess, results, _, stats, _ = serve.serve_kws_audio(args)
    else:
        sess, _, stats, _, _ = serve.serve_kws_detect(args)
        results = stats.pop("fires")
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    summ = sess.summary()
    print(f"[faults] serve {mode} {numerics} {depth}: "
          f"{serve._host_blocked_line(stats['slo'])}; "
          f"{serve._robustness_line(sess, summ, stats.get('controller'))}")
    return {"results": results, "stats": stats, "launches": launches,
            "summary": dataclasses.replace(summ, slo={})}


def serve_under_faults(torch, bad):
    """``serve --faults`` in-process, one run after another: kws-audio
    (SLOTS slots, REQUESTS requests, ladder 0.2,0.4, queue 48), kws-detect
    and kws-cascade (SLOTS slots × SERVE_FAULT_SECONDS streams), each in
    both numerics at depth 1 (--sync-loop) and 2.  Depth 2 must equal
    depth 1 in every decision or fire, loop counter, controller stat and
    summary field; each run's launch counts must read one launch of every
    kernel of its path per dispatched piece that held a whole frame, plus
    the warm-up, and none of any other kernel."""
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    launches = {}
    for mode in ("kws-audio", "kws-detect", "kws-cascade"):
        for numerics in ("float32", "int8"):
            r1, r2 = (serve_faulty(torch, wrappers, mode, numerics, d)
                      for d in (1, 2))
            same = r1["results"] == r2["results"]
            for k in ("steps", "pieces", "faults", "frames_served",
                      "pad_frames", "frames", "controller"):
                same &= r1["stats"].get(k) == r2["stats"].get(k)
            s1 = r1["summary"]
            same &= s1 == r2["summary"]
            path = fault_path(mode, numerics)
            launch_ok = True
            for r in (r1, r2):
                want = r["stats"]["pieces"] + 1          # + the warm-up
                launch_ok &= all(r["launches"][k] == want for k in path)
                launch_ok &= not any(v for k, v in r["launches"].items()
                                     if k not in path)
            key = "decisions" if mode == "kws-audio" else "fires"
            n = (len(r1["results"]) if mode == "kws-audio"
                 else sum(map(len, r1["results"])))
            print(f"[faults] serve {mode} {numerics}: depth 1 vs 2 equal "
                  f"{same} ({n} {key}; recoveries {s1.recoveries} "
                  f"{s1.recovery_reasons}; faults {r1['stats']['faults']}; "
                  f"controller {r1['stats'].get('controller')}); pieces "
                  f"with a frame {r1['stats']['pieces']} / "
                  f"{r2['stats']['pieces']} in {r1['stats']['steps']} steps; "
                  f"launches depth 1 {r1['launches']}, depth 2 "
                  f"{r2['launches']}")
            bad.check(same, f"serve {mode} {numerics}: depth 2 differs "
                            f"from depth 1")
            bad.check(launch_ok, f"serve {mode} {numerics}: launches are "
                                 f"not one per piece with a frame")
            bad.check(s1.recoveries >= 1
                      or not r1["stats"]["faults"].get("nan_burst"),
                      f"serve {mode} {numerics}: a NaN burst fired and "
                      f"nothing recovered")
            launches[(mode, numerics)] = {k: r2["launches"][k] for k in path}
    print(f"[faults] 12 serve runs in {time.perf_counter() - t0:.1f} s")
    return launches


def check_no_syncs(torch, np, params, bad, shards: int = 1,
                   resets=(3,), tag: str = "faults"):
    """``torch.cuda.set_sync_debug_mode("error")`` around
    ``process_audio`` and ``reset_streams`` of unsupervised sessions,
    plain in both numerics, detect and cascade: three chunks (one not
    frame-aligned, one a single sample) and a reset wave each, after a
    warm-up chunk outside the mode.  No synchronisation may be
    reported.  ``shards`` > 1: the sessions shard their slots over that
    many shards on the card (each on its own stream)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.launch.mesh import SlotMesh
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models.detector import DetectorConfig
    audio = fault_audio(np, SLOTS, 3 * CHUNK, 5)
    det = dict(detector=DetectorConfig(0.3, 0.095, 0.09, 4),
               vad=VADConfig(0.02))
    kinds = (("plain", "float32", {}), ("plain", "int8", {}),
             ("detect", "float32", det), ("detect", "int8", det),
             ("cascade", "float32", dict(det, cascade=cascade_config(),
                                         stage0_params=stage0(torch))))
    for kind, numerics, kw in kinds:
        mesh = SlotMesh.on("cuda", shards) if shards > 1 else None
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1,
                                   batch=SLOTS, numerics=numerics,
                                   mesh=mesh, **kw)
        sess.process_audio(audio[:, :CHUNK])
        sess.reset_streams([0, 1])
        torch.cuda.synchronize()
        err = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            for lo, hi in ((CHUNK, 2 * CHUNK - 100), (2 * CHUNK - 100,
                                                     2 * CHUNK - 99),
                           (2 * CHUNK - 99, 3 * CHUNK)):
                sess.process_audio(audio[:, lo:hi])
                sess.reset_streams([lo % SLOTS, *resets])
        except RuntimeError as e:
            err = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[{tag}] sync debug mode 'error', unsupervised {kind} "
              f"{numerics} session{f' on {shards} shards' * (shards > 1)}"
              f", process_audio + reset_streams x3: "
              f"{'no synchronisation' if err is None else err}")
        bad.check(err is None, f"{kind} {numerics} process_audio or "
                               f"reset_streams synchronised: {err}")


def always_on_streams(np):
    """ALWAYS_ON_SLOTS streams × ALWAYS_ON_CHUNKS chunks of keyword audio
    (the always-on phases' audio)."""
    from repro_torch.data.gscd import synth_batch
    B, n = ALWAYS_ON_SLOTS, ALWAYS_ON_CHUNKS
    pool, _ = synth_batch(np.random.default_rng(3), 64)
    rng = np.random.default_rng(4)
    per_stream = -(-n * CHUNK // pool.shape[1])
    streams = pool[rng.integers(0, len(pool), (B, per_stream))].reshape(B, -1)
    return np.ascontiguousarray(streams[:, :n * CHUNK])


ENGINE_CONFIGS = ((1, False), (2, False), (1, True), (2, True))
ENGINE_ROUNDS = 5


def engine_timing(torch, np, params, card, profile, numerics, bad):
    """The always-on plain step through ``PipelinedEngine`` at depth 1 and
    2, without and with the default supervisor, in alternating rounds on
    the same audio (ALWAYS_ON_SLOTS slots × ALWAYS_ON_CHUNKS chunks), one
    untimed round each first (the staging rings allocate their pinned
    buffers on first use): medians over ENGINE_ROUNDS rounds of step ms,
    decisions/s and host-blocked ms per phase; every configuration's
    votes equal.  No gate on the times.  ``profile``: the device busy
    share at depth 1 and 2 (unsupervised)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.engine import PipelinedEngine, warm_session
    from repro_torch.launch.streaming import (StreamingKwsSession,
                                              SupervisorConfig)
    streams = always_on_streams(np)
    n = ALWAYS_ON_CHUNKS
    blocks = [streams[:, c * CHUNK:(c + 1) * CHUNK] for c in range(n)]
    sessions = {}
    for depth, sup in ENGINE_CONFIGS:
        sessions[(depth, sup)] = StreamingKwsSession(
            params, CONFIG, threshold=0.1, batch=ALWAYS_ON_SLOTS,
            numerics=numerics, supervisor=SupervisorConfig() if sup else None)
        warm_session(sessions[(depth, sup)], CHUNK)
    res = {cfg: [] for cfg in ENGINE_CONFIGS}
    votes = {}
    for r in range(-1, ENGINE_ROUNDS):               # round -1: untimed
        for cfg in (ENGINE_CONFIGS if r % 2 == 0 else ENGINE_CONFIGS[::-1]):
            sess = sessions[cfg]
            sess.reset()
            eng = PipelinedEngine(sess, depth=cfg[0])
            got = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in blocks:
                eng.begin()
                _, drained = eng.submit([b])
                eng.end()
                got += [f.arrays[0] for f in drained]
            got += [f.arrays[0] for f in eng.flush()]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            votes[(cfg, r)] = np.concatenate(got)
            if r >= 0:
                res[cfg].append((dt * 1e3 / n, sess.summary().frames / dt,
                                 eng.report()["host_blocked_ms_per_step"]))
    ref = votes[(ENGINE_CONFIGS[0], 0)]
    same = all(np.array_equal(v, ref) for v in votes.values())
    bad.check(same, f"engine timing {numerics}: votes differ between "
                    f"depths or with the supervisor")
    out = {}
    for cfg, rows in res.items():
        med = lambda i, k=None: statistics.median(
            (row[i] if k is None else row[i][k]) for row in rows)
        out[cfg] = {"step_ms": med(0), "decisions_per_s": med(1),
                    **{f"host_{k}_ms": med(2, k) for k in
                       ("assemble", "dispatch", "fetch", "total")},
                    "rounds_step_ms": [row[0] for row in rows]}
        o = out[cfg]
        print(f"[engine] {numerics} depth {cfg[0]}, supervisor "
              f"{'on' if cfg[1] else 'off'}: step {o['step_ms']:.3f} ms "
              f"(rounds {[round(x, 3) for x in o['rounds_step_ms']]}), "
              f"{o['decisions_per_s']:.0f} decisions/s, host-blocked per "
              f"step: assemble {o['host_assemble_ms']:.3f}, dispatch "
              f"{o['host_dispatch_ms']:.3f}, fetch {o['host_fetch_ms']:.3f} "
              f"ms [{card}]")
    for sup in (False, True):
        print(f"[engine] {numerics} supervisor {'on' if sup else 'off'}: "
              f"depth 2 / depth 1 step {out[(2, sup)]['step_ms'] / out[(1, sup)]['step_ms']:.3f}x"
              f"; votes equal across all configurations and rounds: {same}")
    if profile:
        for depth in (1, 2):
            profile_engine(torch, sessions[(depth, False)], blocks, depth,
                           numerics)
    return out


def profile_engine(torch, sess, blocks, depth, numerics):
    """torch.profiler over 8 engine steps at ``depth``: device busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.engine import PipelinedEngine
    sess.reset()
    eng = PipelinedEngine(sess, depth=depth)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in blocks[:8]:
            eng.begin()
            eng.submit([b])
            eng.end()
        eng.flush()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages())
    if not busy:
        print("[profile] no device time in the trace: not measured")
        return
    print(f"[profile] engine {numerics} depth {depth}, 8 steps: wall "
          f"{wall_us / 8:.1f} us/step, device busy {busy / 8:.1f} us/step "
          f"({100 * busy / wall_us:.1f}% of wall)")


def faults_phase(torch, np, params, card, profile):
    """Phase 8: fault handling, overload and the pipelined engine."""
    bad = Failures("fault / overload / engine phase")
    t0 = time.perf_counter()
    for numerics in ("float32", "int8"):
        check_faults_against_cpu(torch, np, params, numerics, bad)
        check_set_threshold(torch, np, params, numerics, bad)
    check_no_syncs(torch, np, params, bad)
    soak_res = soak_phase(torch, np, params, card, bad)
    serve_launches = serve_under_faults(torch, bad)
    timing = {numerics: engine_timing(torch, np, params, card, profile,
                                      numerics, bad)
              for numerics in ("float32", "int8")}
    print(f"[faults] phase {time.perf_counter() - t0:.1f} s")
    bad.raise_any()
    return {"soak": soak_res, "serve_launches": serve_launches,
            "timing": timing}


# --------------------------------------------------------- training phase --
TRAIN_STEPS, TRAIN_BATCH = 16, 64         # launch.train --arch deltakws
TRAIN_GRAD_B = 8                          # the CUDA-vs-CPU gradient batch
# CUDA vs CPU gradients, per leaf, times the leaf's max |g|: cuBLAS sums
# Δ·W, the FC and the weight gradients in another order than the CPU
# (measured ≤ 7.3e-7 on the H100, my probe before this phase existed).
TRAIN_GRAD_TOL = 5e-6
TRAIN_FAULT_STEPS, TRAIN_FAULT_AT, TRAIN_FAULT_B = 5, 3, 16
TRAIN_SERVE_STEPS = 2                     # serve --train-steps, per stage
TRAIN_TIMED_STEPS = 2                     # per step kind, after one untimed


def cuda_activities(torch, fn):
    """Run ``fn`` once under torch.profiler, device activity only (the
    host-side trace of ~10^5 eager ops costs tens of seconds): (its
    result, the device activities — every kernel, this package's and
    PyTorch's eager ones, and every copy — and the device's busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (out, sum(e.count for e in dev),
            sum(e.self_device_time_total for e in dev) / 1e3)


def train_grads_against_cpu(torch, np, bad):
    """The gradients of ``kws.loss_fn`` (keyword utterances) and
    ``kws.frame_loss_fn`` (continuous streams with frame labels) at the
    paper model's full width (I = 10, H = 64, K = 12, 62 frames, Δ_TH
    0.1), float and QAT, autograd on the card against autograd on the CPU
    (the plain path the CPU tests hold against ``jax.grad``): transmit
    counts equal, losses within 1e-6 relative, every gradient within
    TRAIN_GRAD_TOL × max|g| of the CPU's.  Returns the largest relative
    gradient difference."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import synth_frame_batch
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.models import kws
    fex = FeatureExtractor()
    params = kws.init_kws(torch.Generator().manual_seed(0), CONFIG,
                          input_dim=10)
    audio, labels = synth_batch(np.random.default_rng(11), TRAIN_GRAD_B)
    stream, frame_labels = synth_frame_batch(
        np.random.default_rng(12), TRAIN_GRAD_B, duration_s=62 * 128 / 8000)
    # The features from the FEx kernel, bit for bit its plain version's
    # (phase 2), copied to the CPU.
    cuda = {"utterance": {"feats": fex(torch.from_numpy(audio).cuda()),
                          "labels": torch.from_numpy(labels).cuda()},
            "frame": {"feats": fex(torch.from_numpy(stream).cuda()),
                      "frame_labels": torch.from_numpy(frame_labels).cuda()}}
    batches = {"cuda": cuda, "cpu": {
        kind: {k: v.cpu() for k, v in b.items()} for kind, b in cuda.items()}}
    worst = 0.0
    for kind, loss in (("utterance", kws.loss_fn),
                       ("frame", kws.frame_loss_fn)):
        for qat in (False, True):
            res = {}
            for dev in ("cpu", "cuda"):
                batch = batches[dev][kind]
                p = {k: v.to(dev).requires_grad_(True)
                     for k, v in params.items()}
                value, _ = loss(p, CONFIG, batch, 0.1, qat=qat)
                grads = torch.autograd.grad(value, list(p.values()))
                with torch.no_grad():
                    _, st = kws.forward(p, CONFIG, batch["feats"], 0.1,
                                        qat=qat)
                res[dev] = (value.item(), {k: g.cpu() for k, g in
                                           zip(p, grads)},
                            st.nz_dx.cpu(), st.nz_dh.cpu())
            (cv, cg, cx, ch), (gv, gg, gx, gh) = res["cpu"], res["cuda"]
            counts = torch.equal(cx, gx) and torch.equal(ch, gh)
            rel = {k: float((cg[k] - gg[k]).abs().max()
                            / cg[k].abs().max()) for k in cg}
            finite = all(bool(torch.isfinite(g).all()) for g in gg.values())
            worst = max(worst, *rel.values())
            print(f"[train] gradients {kind} {'QAT' if qat else 'float'} "
                  f"(B={TRAIN_GRAD_B}, 62 frames): loss cpu {cv:.7f} cuda "
                  f"{gv:.7f}; transmit counts equal {counts} "
                  f"({int(cx.sum())} + {int(ch.sum())} sent); max |Δg| / "
                  f"max |g| " + " ".join(f"{k} {v:.1e}"
                                         for k, v in rel.items()))
            bad.check(counts, f"{kind} {qat}: transmit counts differ "
                              f"between the card and the CPU")
            bad.check(finite and abs(gv - cv) <= 1e-6 * abs(cv),
                      f"{kind} {qat}: loss {gv} on the card, {cv} on "
                      f"the CPU")
            bad.check(max(rel.values()) <= TRAIN_GRAD_TOL,
                      f"{kind} {qat}: gradients differ by {rel}")
    return worst


def train_run(torch, np, tmp, bad):
    """``launch.train --arch deltakws`` in-process at B = 64 for
    TRAIN_STEPS steps (QAT, Δ_TH 0.1, --promote), every kernel's count set
    to 0 just before and read just after: ``batched_iir_fex`` once per
    training batch and once for the evaluation, ``delta_gru_seq`` (the
    float evaluation) and ``delta_gru_seq_int`` (the promoted int8 one)
    once each, nothing else.  The loss must be finite and fall (the mean
    of the last five steps below the first five's)."""
    from repro_torch.launch import train
    wrappers = kernel_wrappers()
    args = train.build_parser().parse_args(
        ["--arch", "deltakws", "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--ckpt-dir", str(tmp / "ckpt"),
         "--ckpt-every", "10", "--promote", str(tmp / "trained.npz")])
    zero_launches(wrappers)
    t0 = time.perf_counter()
    run = train.train_kws(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers)
    hist = run["trainer"].history
    losses = [h.metrics["loss"] for h in hist]
    walls = [h.wall_s * 1e3 for h in hist]
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    want = {"batched_iir_fex": TRAIN_STEPS + 1, "delta_gru_seq": 1,
            "delta_gru_seq_int": 1}
    print(f"[train] launch.train --arch deltakws (QAT, B={TRAIN_BATCH}, "
          f"Δ_TH 0.1) {len(hist)} steps in {secs:.1f} s: loss "
          f"{losses[0]:.4f} → {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}), train acc "
          f"{hist[-1].metrics['acc']:.3f}, sparsity "
          f"{hist[-1].metrics['sparsity']:.3f}; ms/step median "
          f"{statistics.median(walls[1:]):.1f} (first {walls[0]:.1f}, min "
          f"{min(walls):.1f}, max {max(walls):.1f}); eval acc float "
          f"{run['acc_float']:.3f} / int8 {run['acc_int8']:.3f}; "
          f"launches {launches}")
    bad.check(all(np.isfinite(losses)) and last < first,
              f"the training loss did not fall: {losses}")
    bad.check(all(launches[k] == v for k, v in want.items())
              and not any(v for k, v in launches.items() if k not in want),
              f"launch.train launched {launches}, want {want}")
    bad.check(run["trainer"].recoveries == 0, "launch.train recovered")
    trainer = run["trainer"]
    batch = trainer.data_fn(trainer.step)
    _, n, busy = cuda_activities(torch, lambda: trainer.step_fn(
        trainer.params, trainer.opt_state, batch))
    return {"run": run, "losses": losses, "ms": walls, "launches": launches,
            "step_launches": n, "step_busy_ms": busy}


def train_step_times(torch, np, res):
    """ms per training step of the four step kinds — utterance-level at
    B = 64 × 1 s (QAT: the launch.train run's steps; float) and
    frame-level at B = 32 × 2 s streams (float, QAT) — each but the first
    TRAIN_TIMED_STEPS timed steps after an untimed one (host clock around
    the step and a synchronise); device activities per step and the busy
    share of one step under torch.profiler for utterance QAT and
    frame-level float (tracing a step takes ~20 s; the count does not
    depend on the numerics but for QAT's few extra ops)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import synth_frame_batch
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.models import kws
    from repro_torch.train import optimizer as opt
    from repro_torch.train.promote import make_kws_step_fn
    fex = FeatureExtractor()
    out = {("utterance", True): {
        "ms": statistics.median(res["ms"][1:]), "launches":
        res["step_launches"], "busy_ms": res["step_busy_ms"]}}
    for kind, qat in (("utterance", False), ("frame", False),
                      ("frame", True)):
        frame = kind == "frame"
        params = {k: v.cuda() for k, v in kws.init_kws(
            torch.Generator().manual_seed(0), CONFIG, input_dim=10).items()}
        state = opt.init(params)
        step = make_kws_step_fn(CONFIG, opt.AdamWConfig(
            lr=3e-3, weight_decay=0.01, warmup_steps=20, total_steps=100),
            0.1, qat=qat, frame_level=frame)
        rng = np.random.default_rng(0)
        walls = []
        for i in range(TRAIN_TIMED_STEPS + 1):
            if frame:
                audio, labels = synth_frame_batch(rng, 32)
                key = "frame_labels"
            else:
                audio, labels = synth_batch(rng, TRAIN_BATCH)
                key = "labels"
            batch = {"feats": fex(torch.from_numpy(audio).cuda()),
                     key: torch.from_numpy(labels).cuda()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        r = {"ms": statistics.median(walls[1:]), "launches": None,
             "busy_ms": None}
        if (kind, qat) == ("frame", False):
            _, r["launches"], r["busy_ms"] = cuda_activities(
                torch, lambda: step(params, state, batch))
        out[(kind, qat)] = r
    for (kind, qat), r in out.items():
        shape = "B=32 x 2 s" if kind == "frame" else f"B={TRAIN_BATCH} x 1 s"
        traced = ("" if r["launches"] is None else
                  f", {r['launches']} device activities (kernels and copies) "
                  f"per step, device busy {r['busy_ms']:.1f} ms/step "
                  f"({r['busy_ms'] / r['ms']:.3f} of the step)")
        print(f"[train] step {kind} {'QAT' if qat else 'float'} ({shape}): "
              f"{r['ms']:.1f} ms/step{traced}")
    return out


def train_fault_resume(torch, np, tmp, bad):
    """A Trainer on the card (QAT, B = TRAIN_FAULT_B, a checkpoint every
    2 steps) whose step TRAIN_FAULT_AT raises once: it restores step 2,
    replays, and ends on the unfaulted run's params bit for bit."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.models import kws
    from repro_torch.train import optimizer as opt
    from repro_torch.train.promote import make_kws_step_fn
    from repro_torch.train.trainer import Trainer, TrainerConfig
    fex = FeatureExtractor()
    step = make_kws_step_fn(CONFIG, opt.AdamWConfig(
        lr=3e-3, weight_decay=0.01, warmup_steps=2, total_steps=10), 0.1)

    def data_fn(i):
        audio, labels = synth_batch(np.random.default_rng(i), TRAIN_FAULT_B)
        return {"feats": fex(torch.from_numpy(audio).cuda()),
                "labels": torch.from_numpy(labels).cuda()}

    def trainer(name):
        params = {k: v.cuda() for k, v in kws.init_kws(
            torch.Generator().manual_seed(0), CONFIG, input_dim=10).items()}
        return Trainer(TrainerConfig(ckpt_dir=str(tmp / name), ckpt_every=2),
                       step, params, opt.init(params), data_fn)

    ref = trainer("ref")
    ref.run(TRAIN_FAULT_STEPS)
    armed = [True]

    def hook(i):
        if i == TRAIN_FAULT_AT and armed[0]:
            armed[0] = False
            raise RuntimeError("injected device loss")

    ft = trainer("faulted")
    ft.run(TRAIN_FAULT_STEPS, fault_hook=hook)
    same = all(torch.equal(ft.params[k], ref.params[k]) for k in ref.params)
    same &= all(torch.equal(a, b) for a, b in zip(
        (ft.opt_state.m[k] for k in ref.params),
        (ref.opt_state.m[k] for k in ref.params)))
    print(f"[train] fault at step {TRAIN_FAULT_AT}: {ft.recoveries} "
          f"recovery, resumed from step 2, {ft.step} steps; params and "
          f"moments equal to the unfaulted run's bit for bit: {same}")
    bad.check(ft.recoveries == 1 and ft.step == ref.step and same,
              "the faulted run did not resume to the unfaulted params")


def train_bundle_serves(torch, res, bad):
    """The promoted bundle of the launch.train run: saved, loaded back
    code for code, and served by ``serve --bundle`` (kws-audio, SLOTS
    slots, REQUESTS requests) through the integer kernels, each once per
    step (+ the warm-up), nothing else."""
    from repro_torch.launch import serve
    from repro_torch.train.promote import load_bundle
    run = res["run"]
    back = load_bundle(run["bundle_path"])
    b = run["bundle"]
    same = all(torch.equal(x.cpu(), y) for x, y in (
        (b.gru.w_x, back.gru.w_x), (b.gru.w_h, back.gru.w_h),
        (b.gru.b, back.gru.b), (b.w_fc, back.w_fc), (b.b_fc, back.b_fc),
        (b.coef, back.coef))) and (b.gfmt, b.ffmt) == (back.gfmt, back.ffmt)
    wrappers = kernel_wrappers()
    args = serve.build_parser().parse_args(
        ["--mode", "kws-audio", "--slots", str(SLOTS), "--requests",
         str(REQUESTS), "--chunk-samples", str(CHUNK), "--init-seed", "0",
         "--bundle", str(run["bundle_path"])])
    serve.validate_args(args)
    zero_launches(wrappers)
    sess, done, labels, stats, dt = serve.serve_kws_audio(args)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    path = ("batched_iir_fex_int", "delta_gru_seq_int")
    want = stats["steps"] + 1
    correct = sum(1 for r, p in done if p == int(labels[r]))
    print(f"[train] bundle {run['bundle_path'].name}: codes and formats "
          f"round-trip {same}; served int8 {len(done)} requests, "
          f"{correct} correct (chance 1/12), {stats['steps']} "
          f"steps, launches {launches}")
    bad.check(same, "the saved bundle does not load back code for code")
    bad.check(len(done) == REQUESTS and sess.numerics == "int8",
              f"the bundle served {len(done)} requests as {sess.numerics}")
    bad.check(all(launches[k] == want for k in path) and not any(
        v for k, v in launches.items() if k not in path),
        f"the bundle's serve run launched {launches}, want {path} x {want}")
    return correct


def serve_trained(torch, bad):
    """``serve --train-steps TRAIN_SERVE_STEPS`` for kws-detect and
    kws-cascade in both numerics (SLOTS slots × DETECT_SECONDS streams at
    the default operating point), counts set to 0 just before and read
    just after: the float FEx kernel once per training batch (stage 1's,
    and stage 0's in the cascade), the serving path's kernels once per
    step (+ the warm-up) as in phases 5–6, nothing else.  Prints the
    trained model's fires and stage-1 duty (not gated)."""
    from repro_torch.launch import serve
    wrappers = kernel_wrappers()
    out = {}
    for mode in ("kws-detect", "kws-cascade"):
        for numerics in ("float32", "int8"):
            args = serve.build_parser().parse_args(
                ["--mode", mode, "--numerics", numerics, "--slots",
                 str(SLOTS), "--stream-seconds", str(DETECT_SECONDS),
                 "--chunk-samples", str(CHUNK), "--init-seed", "0",
                 "--train-steps", str(TRAIN_SERVE_STEPS)])
            serve.validate_args(args)
            zero_launches(wrappers)
            t0 = time.perf_counter()
            sess, point, stats, dt, _ = serve.serve_kws_detect(args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches(wrappers)
            summ = sess.summary()
            batches = TRAIN_SERVE_STEPS * (2 if mode == "kws-cascade" else 1)
            want = dict.fromkeys(fault_path(mode, numerics),
                                 stats["steps"] + 1)
            want["batched_iir_fex"] = want.get("batched_iir_fex", 0) + batches
            duty = (f", stage-1 duty {summ.stage1_duty:.3f}"
                    if mode == "kws-cascade" else "")
            print(f"[train] serve {mode} {numerics} --train-steps "
                  f"{TRAIN_SERVE_STEPS}: {secs:.1f} s ({secs - dt:.1f} s "
                  f"training); {point.n_events} events, {point.hits} hits, "
                  f"{point.false_alarms} false alarms "
                  f"({point.fa_per_hour:.1f} FA/hr){duty}, vad duty "
                  f"{summ.vad_duty:.3f}; launches {launches}")
            bad.check(launches == {**dict.fromkeys(launches, 0), **want},
                      f"serve {mode} {numerics} --train-steps launched "
                      f"{launches}, want {want}")
            out[(mode, numerics)] = {
                "fires": point.hits + point.false_alarms,
                "hits": point.hits, "events": point.n_events,
                "duty": summ.stage1_duty if mode == "kws-cascade" else None}
    return out


def training_phase(torch, np):
    """Phase 9: training on the card (~2 min)."""
    import tempfile
    bad = Failures("training phase")
    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append(f"{what} {time.perf_counter() - t0:.1f}")

    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        worst = train_grads_against_cpu(torch, np, bad)
        mark("gradients")
        res = train_run(torch, np, tmp, bad)
        mark("launch.train")
        steps = train_step_times(torch, np, res)
        mark("step times")
        train_fault_resume(torch, np, tmp, bad)
        mark("fault resume")
        correct = train_bundle_serves(torch, res, bad)
        mark("bundle")
        served = serve_trained(torch, bad)
        mark("serve --train-steps")
    print(f"[train] phase {time.perf_counter() - t0:.1f} s (elapsed at the "
          f"end of each part: {', '.join(marks)} s)")
    bad.raise_any()
    return {"grad_rel_err": worst, "launches": res["launches"],
            "steps": steps, "served": served, "bundle_correct": correct}


# --------------------------------------------------- phase 10: tuning --
TUNE_ITERS = 20                # timed calls per candidate (median)
TUNE_STEPS = 4                 # session steps: tuned, untuned, forced
# Recorded on purpose for one session: every knob off its default, so the
# session's knob path runs whatever the sweep finds.
FORCED_TUNING = {"batched_iir_fex": {"block_b": 64, "unroll": 4},
                 "batched_iir_fex_int": {"block_b": 64, "unroll": 4},
                 "delta_gru_seq": {"block_b": 128, "block_t": 8},
                 "delta_gru_seq_int": {"block_b": 128, "block_t": 8}}
TUNED_KERNELS = ("batched_iir_fex", "batched_iir_fex_int", "delta_gru_seq",
                 "delta_gru_seq_int")
# The examples at small flags, in this process.
EXAMPLES = (
    ("torch_quickstart", ["--steps", "2", "--batch", "8", "--eval-n", "64"]),
    ("torch_serve_streaming_kws", ["--train-steps", "2", "--batch", "8"]),
    ("torch_train_kws_e2e", ["--steps", "4", "--batch", "8", "--ckpt-every",
                             "2", "--eval-n", "64"]))


def tuning_runs(torch, np, fex, params, bundle):
    """The four tuned kernels on serving data, 256 slots, from the state
    one chunk of keyword audio left: ``{kernel: run(config) → outputs}``
    (a config maps knob names to values, None = the default launch)."""
    from repro_torch.core import delta_gru as dg
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    from repro_torch.models import kws
    B, th = ALWAYS_ON_SLOTS, 0.1
    x = keyword_audio(torch, np, B, 5)
    x1, x2 = x[:, :CHUNK].contiguous(), x[:, CHUNK:].contiguous()
    coef = fex.coef.cuda()
    C = coef.shape[1]
    f1, s1 = iir_fex.batched_iir_fex(x1, coef,
                                     iir_fex.init_fex_kernel_state(B, C, "cuda"))
    f2, _ = iir_fex.batched_iir_fex(x2, coef, s1)
    ffmt, gfmt = bundle.ffmt, bundle.gfmt
    xc = fp.to_code(x, ffmt.feat_frac, 16, torch.int16)
    xc1, xc2 = xc[:, :CHUNK].contiguous(), xc[:, CHUNK:].contiguous()
    fi1, si1 = iir_fex.batched_iir_fex_int(
        xc1, bundle.coef, fp.init_int_fex_state(B, C, "cuda"), fmt=ffmt)
    fi2, _ = iir_fex.batched_iir_fex_int(xc2, bundle.coef, si1, fmt=ffmt)
    gru, _, _ = kws.serving_weights({k: v.cuda() for k, v in params.items()})
    H = gru.w_h.shape[0]
    frames = lambda f: f.movedim(1, 0).contiguous()
    _, g1, _, _ = dgs.delta_gru_seq(frames(f1), *dg.init_delta_state(
        B, C, H, gru), gru.w_x, gru.w_h, th)
    w, thc = bundle.gru, gfmt.th_codes(th)
    _, i1, _, _ = dgs.delta_gru_seq_int(
        frames(fi1), *fp.init_int_delta_state(B, C, H, w), w.w_x, w.w_h, thc,
        fmt=gfmt)
    xs2, xi2 = frames(f2), frames(fi2)
    return {
        "batched_iir_fex": lambda cfg: iir_fex.batched_iir_fex(
            x2, coef, s1, **cfg),
        "batched_iir_fex_int": lambda cfg: iir_fex.batched_iir_fex_int(
            xc2, bundle.coef, si1, fmt=ffmt, **cfg),
        "delta_gru_seq": lambda cfg: dgs.delta_gru_seq(
            xs2, *g1, gru.w_x, gru.w_h, th, **cfg),
        "delta_gru_seq_int": lambda cfg: dgs.delta_gru_seq_int(
            xi2, *i1, w.w_x, w.w_h, thc, fmt=gfmt, **cfg)}


def tuning_candidates(kernel, report):
    """Every configuration the tuner can reach at this shape: each axis's
    candidates with the other knob at its default (block_b = 1 of the
    float FEx included, which the sweep skips, and the FEx's legal unrolls
    above 16), then the sweep's own."""
    from repro_torch.kernels import autotune
    B = report["shape"][0]
    if kernel.startswith("batched_iir_fex"):
        other = ("unroll", autotune._tile_candidates(report["shape"][2],
                                                     cap=16) + [32, 64, 128])
    else:
        other = ("block_t", autotune._tile_candidates(report["T"]))
    axes = (other, ("block_b", autotune._block_b_candidates(B)))
    default = {name: None for name, _ in axes}
    cfgs = [dict(default, **{name: v}) for name, cands in axes
            for v in cands]
    cfgs += [{k: v for k, v in e.items() if k not in ("us", "role")}
             for e in report["sweep"]]
    out = []
    for c in cfgs:
        if c not in out:
            out.append(c)
    return out


def flat_outputs(out) -> list:
    res = []
    for o in out:
        res.extend(o if isinstance(o, (tuple, list)) else [o])
    return res


def same_outputs(torch, ref, got) -> bool:
    """Every output bit for bit (floats by their bit patterns)."""
    ref, got = flat_outputs(ref), flat_outputs(got)
    if len(ref) != len(got):
        return False
    for a, b in zip(ref, got):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype.is_floating_point:
            if bits_differ(torch, a, b):
                return False
        elif not torch.equal(a, b):
            return False
    return True


def check_ragged_unrolls(torch, np, fex, bundle, bad):
    """Both FEx kernels at frame_shift 100 (B = 8, T = 1000 + 37): the
    unrolls that divide it but not the 64-sample tile (5, 25, 50) and 100,
    with block_b 8 and 2, bit for bit against the default launch."""
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import iir_fex
    B, T, fs = 8, 1037, 100
    g = torch.Generator().manual_seed(11)
    x = (torch.rand((B, T), generator=g) * 2 - 1).mul(0.5).cuda()
    coef = fex.coef.cuda()
    xc = fp.to_code(x, bundle.ffmt.feat_frac, 16, torch.int16)
    runs = {
        "batched_iir_fex": lambda **kw: iir_fex.batched_iir_fex(
            x, coef, iir_fex.init_fex_kernel_state(B, 10, "cuda"),
            frame_shift=fs, **kw),
        "batched_iir_fex_int": lambda **kw: iir_fex.batched_iir_fex_int(
            xc, bundle.coef, fp.init_int_fex_state(B, 10, "cuda"),
            fmt=bundle.ffmt, frame_shift=fs, **kw)}
    n = 0
    for k, run in runs.items():
        ref = run()
        for unroll in (5, 25, 50, 100):
            for block_b in (None, 2):
                n += 1
                if not same_outputs(torch, ref, run(unroll=unroll,
                                                    block_b=block_b)):
                    bad.append(f"{k} frame_shift 100 unroll {unroll} "
                               f"block_b {block_b} differs from the default")
    print(f"[tune] frame_shift 100: {n} configurations of both FEx kernels "
          f"(unroll 5, 25, 50, 100 × block_b 8, 2) bit for bit against the "
          f"default launch")


def check_illegal_knobs(torch, runs, bad):
    """An illegal knob raises the reference's ValueError naming the
    kernel, on the card as on the CPU, before anything launches."""
    for kernel, cfg, text in (
            ("batched_iir_fex", {"block_b": 3}, "block_b=3"),
            ("batched_iir_fex", {"unroll": 3}, "unroll=3"),
            ("batched_iir_fex_int", {"block_b": 0}, "block_b=0"),
            ("batched_iir_fex_int", {"unroll": 48}, "unroll=48"),
            ("delta_gru_seq", {"block_t": 5}, "block_t=5"),
            ("delta_gru_seq", {"block_b": 7}, "block_b=7"),
            ("delta_gru_seq_int", {"block_b": 6}, "block_b=6"),
            ("delta_gru_seq_int", {"block_t": 0}, "block_t=0")):
        try:
            runs[kernel](cfg)
        except ValueError as e:
            if not str(e).startswith(f"{kernel}: {text} is not a positive "
                                     f"divisor"):
                bad.append(f"{kernel} {cfg}: unexpected message {e}")
            continue
        bad.append(f"{kernel} {cfg} did not raise")
    print("[tune] illegal knobs: 8 cases raise the reference's ValueError")


def tuned_session(torch, np, params, numerics, streams, env):
    """A 256-slot always-on session built under ``env`` (set while it is
    built, then restored), run TUNE_STEPS steps with the counts zeroed
    just before and read just after: (report, launches, outputs)."""
    import os

    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.kernels import autotune
    from repro_torch.launch.streaming import StreamingKwsSession
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        autotune.clear_memo()
        sess = StreamingKwsSession(params, CONFIG, threshold=0.1,
                                   batch=ALWAYS_ON_SLOTS, input_dim=10,
                                   fex=FeatureExtractor(),
                                   numerics=numerics, device="cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.clear_memo()
    report = sess.kernel_tuning_report()
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    zero_launches(wrappers)
    outs = []
    for c in range(TUNE_STEPS):
        r = sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK])
        outs.append((r.votes, r.logits, r.nz))
    torch.cuda.synchronize()
    return report, read_launches(wrappers), outs


def record_forced(forced):
    """FORCED_TUNING into the cache file ``forced``, under the keys a
    256-slot always-on session looks up on this card."""
    import os

    from repro_torch.kernels import autotune
    saved = os.environ.get(autotune.ENV_CACHE)
    os.environ[autotune.ENV_CACHE] = str(forced)
    try:
        B = ALWAYS_ON_SLOTS
        for k, shape, dtype, th in (
                ("batched_iir_fex", (B, 10, 128), "float32", 0.0),
                ("batched_iir_fex_int", (B, 10, 128), "int16", 0.0),
                ("delta_gru_seq", (B, 10, 64), "float32", 0.1),
                ("delta_gru_seq_int", (B, 10, 64), "int8", 0.1)):
            autotune.record(k, shape, dtype, th, FORCED_TUNING[k],
                            tuned_us=0.0, default_us=0.0, device="cuda")
    finally:
        os.environ[autotune.ENV_CACHE] = saved
        autotune.clear_memo()


def tuning_sessions(torch, np, params, reports, cache, bad):
    """Sessions that pick the recorded configurations up, against a
    session with autotuning off: the report lists the winners (and then a
    forced configuration), each kernel launches B / block_b times a step,
    and votes, logits and transmit counts equal the untuned session's
    bit for bit."""
    from repro_torch.kernels import autotune
    streams = always_on_streams(np)[:, :TUNE_STEPS * CHUNK]
    forced = cache.with_name("forced.json")
    record_forced(forced)
    for numerics in ("float32", "int8"):
        fex_k, gru_k = (("batched_iir_fex_int", "delta_gru_seq_int")
                        if numerics == "int8"
                        else ("batched_iir_fex", "delta_gru_seq"))
        _, plain_launch, plain = tuned_session(
            torch, np, params, numerics, streams,
            {autotune.ENV_ENABLE: "0"})
        winners = {k: {n: v for n, v in reports[k]["best_config"].items()
                       if v is not None} for k in (fex_k, gru_k)}
        for label, env, want in (
                ("tuned", {}, winners),
                ("forced", {autotune.ENV_CACHE: str(forced)},
                 {k: FORCED_TUNING[k] for k in (fex_k, gru_k)})):
            report, launches, outs = tuned_session(
                torch, np, params, numerics, streams, env)
            listed = {k: v["config"] for k, v in report["kernels"].items()}
            if listed != want:
                bad.append(f"{label} {numerics} session reports {listed}, "
                           f"recorded {want}")
            for k in (fex_k, gru_k):
                per_step = ALWAYS_ON_SLOTS // want[k].get(
                    "block_b", ALWAYS_ON_SLOTS)
                if launches[k] != TUNE_STEPS * per_step:
                    bad.append(f"{label} {numerics} session launched {k} "
                               f"{launches[k]} times in {TUNE_STEPS} steps, "
                               f"want {TUNE_STEPS * per_step}")
            equal = all(same_outputs(torch, a, b)
                        for a, b in zip(plain, outs))
            if not equal:
                bad.append(f"{label} {numerics} session's votes, logits or "
                           f"counts differ from the untuned session's")
            print(f"[tune] {label} {numerics} session: report {listed}, "
                  f"launches {launches[fex_k]} {fex_k} / {launches[gru_k]} "
                  f"{gru_k} in {TUNE_STEPS} steps (untuned "
                  f"{plain_launch[fex_k]} / {plain_launch[gru_k]}), "
                  f"outputs {'equal' if equal else 'DIFFER'}")


def run_examples(bad):
    """The three examples' ``main`` at small flags, on the card, in this
    process; each must print the registry's commands."""
    import contextlib
    import importlib.util
    import io

    from repro_torch import commands
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        out = buf.getvalue()
        shown = [k for k, c in commands.ALL_COMMANDS.items() if c in out]
        last = [ln for ln in out.splitlines() if ln.strip()][-4:]
        print(f"[tune] examples/{name}.py {' '.join(argv)}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s, prints {shown}")
        for ln in last:
            print(f"[tune]   {ln}")
        if rc != 0 or not shown or "cuda" not in out:
            bad.append(f"examples/{name}.py failed on the card (rc {rc}, "
                       f"commands {shown})")


def tuning_phase(torch, np, fex, params, bundle, card, cache):
    """Sweep the four serving kernels at the always-on shapes, hold every
    candidate bit for bit against the default launch, check the illegal
    knobs, serve sessions that pick the winners (and a forced
    configuration) up against an untuned one, and run the examples."""
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    bad = []
    reports = {}
    for variant in ("float", "int"):
        rep = autotune.tune_batched_iir_fex(
            B=ALWAYS_ON_SLOTS, seconds=CHUNK / 8000, variant=variant,
            iters=TUNE_ITERS, device="cuda")
        reports[rep["kernel"]] = rep
        rep = autotune.tune_delta_gru_seq(
            T=CHUNK // 128, B=ALWAYS_ON_SLOTS, I=10, H=64, threshold=0.1,
            variant=variant, iters=TUNE_ITERS, device="cuda")
        reports[rep["kernel"]] = rep
    for k in TUNED_KERNELS:
        rep = reports[k]
        print(f"[tune] {k} {rep['shape']}: default {rep['default_us']:.1f} "
              f"µs {rep['default_config']}, best {rep['best_us']:.1f} µs "
              f"{rep['best_config']} ({len(rep['sweep'])} timed, median of "
              f"{TUNE_ITERS}) [{card}]")
        for e in rep["sweep"]:
            cfg = {n: v for n, v in e.items() if n not in ("us", "role")}
            print(f"[tune]   {cfg}: {e['us']:.1f} µs")
    runs = tuning_runs(torch, np, fex, params, bundle)
    n_checked = 0
    for k in TUNED_KERNELS:
        cands = tuning_candidates(k, reports[k])
        ref = runs[k]({})
        for cfg in cands:
            n_checked += 1
            if not same_outputs(torch, ref, runs[k](cfg)):
                bad.append(f"{k} {cfg} differs from the default launch")
        print(f"[tune] {k}: {len(cands)} configurations bit for bit "
              f"against the default launch (outputs, state, counts)")
    check_ragged_unrolls(torch, np, fex, bundle, bad)
    torch.cuda.synchronize()
    check_illegal_knobs(torch, runs, bad)
    tuning_sessions(torch, np, params, reports, cache, bad)
    run_examples(bad)
    secs = time.perf_counter() - t0
    print(f"[tune] phase {secs:.1f} s, {n_checked} configurations checked")
    if bad:
        for b in bad:
            print(f"FAIL: {b}")
        fail(f"{len(bad)} tuning checks failed")
    return {k: {"default_us": reports[k]["default_us"],
                "best_us": reports[k]["best_us"],
                "default_config": reports[k]["default_config"],
                "best_config": reports[k]["best_config"],
                "timed": len(reports[k]["sweep"])} for k in TUNED_KERNELS}


# ------------------------------------------------- phase 11: LM stacks --
# The seed's LM stacks (``models/``) run as eager PyTorch: no kernel of
# the port lies on their path (the reference's attention, MoE dispatch
# and SSD scan are plain JAX), so the phase holds the card's results to
# the CPU's, checks the decode cache paths and prints the figures.
LM_F32_TOL = 1e-4          # smoke configs in float32, CUDA vs CPU, of max|·|
LM_CONSIST_TOL = 0.15      # the reference's rtol = atol (test_arch_smoke)
LM_CONSIST_LAYERS = 4      # depth of the gated cache check (full width)
LM_PROBE_LAYERS = (4, 8)   # depths of the chaos probe, besides the full one
LM_DELTA_TOL = 1e-3        # Δ decode at Δ_TH 0 vs dense, f32, of max|·|
LM_FULL = ("qwen2-0.5b", "mamba2-370m", "granite-moe-3b-a800m")
LM_B, LM_PROMPT, LM_NEW, LM_CACHE = 4, 128, 32, 192
LM_PREFILL_REPS, LM_DELTA_STEPS = 5, 8


def _lm_rel(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _lm_inputs(torch, np, cfg, B, S, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32)).to(device)
    emb = None
    if cfg.frontend != "none":
        emb = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).to(
                device)
    return toks, emb


def _lm_outputs(torch, api, params, toks, emb, S, P, cache_len):
    """(loss, prefill logits of P tokens, the next token's decode logits)."""
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    if emb is not None:
        batch["embeds"] = emb
    with torch.no_grad():
        loss, _ = api.loss(params, batch)
    cache, lp = api.prefill(params, toks[:, :P],
                            api.init_cache(toks.shape[0], cache_len), emb)
    ld, _ = api.decode_step(params, cache, toks[:, P:P + 1])
    return loss, lp, ld


def lm_smoke_against_cpu(torch, np, bad):
    """Every ARCH_ID at smoke width: float32 on the card against the same
    weights on the CPU (loss, prefill logits, one decode step's logits
    within LM_F32_TOL of max|·|: cuBLAS sums in another order), then the
    bf16 config on the card, everything finite."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import tree_map
    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        params, _ = get_api(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        toks, emb = _lm_inputs(torch, np, cfg, 2, 32, 0)
        cpu = _lm_outputs(torch, get_api(cfg, device="cpu"), params, toks,
                          emb, 32, 16, 64)
        gpu = _lm_outputs(torch, get_api(cfg, device="cuda"),
                          tree_map(lambda t: t.cuda(), params), toks.cuda(),
                          emb.cuda() if emb is not None else None, 32, 16,
                          64)
        errs = [_lm_rel(g, c) for g, c in zip(gpu, cpu)]
        worst[arch] = max(errs)
        bad.check(max(errs) <= LM_F32_TOL,
                  f"{arch} smoke float32 CUDA vs CPU: relative errors "
                  f"(loss, prefill, decode) {errs} > {LM_F32_TOL}")
        bcfg = get_smoke_config(arch)
        bapi = get_api(bcfg, device="cuda")
        bparams, _ = bapi.init(torch.Generator(device="cuda").manual_seed(0))
        out = _lm_outputs(torch, bapi, bparams, toks.cuda(),
                          emb.cuda() if emb is not None else None, 32, 16,
                          64)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in out)
        bad.check(finite and out[1].dtype == torch.bfloat16,
                  f"{arch} smoke bf16 on the card: not finite or not bf16")
        print(f"[lm] {arch:22s} smoke f32 CUDA vs CPU: loss {errs[0]:.1e}, "
              f"prefill {errs[1]:.1e}, decode {errs[2]:.1e} of max|·|; "
              f"bf16 on the card finite: {finite} (loss "
              f"{float(out[0]):.4f})")
    return worst


def _first_layers(params, cfg, n):
    """The first ``n`` layers of a stack's full-width weights (every
    per-layer subtree sliced on its leading L dim)."""
    from repro_torch.parallel.sharding import tree_map
    stacked = {"attn", "norm1", "norm2", "mlp", "moe", "mamba"}
    return {k: tree_map(lambda t: t[:n], v) if k in stacked else v
            for k, v in params.items()}


def _qkv_bias_params(cfg) -> int:
    """The q/k/v biases, which ``costmodel.param_count`` leaves out, as
    the reference's does."""
    return (cfg.num_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
            if cfg.qkv_bias else 0)


def _score_std(torch, cfg, params, tokens) -> float:
    """The std of layer 0's causal attention scores, q·k/√Dh after the
    norm, the q/k biases and rope (float32 weights)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import Sharder
    lp = {k: L.layer_slice(params[k], 0) for k in ("attn", "norm1")}
    x = L.apply_norm(lp["norm1"], L.embed_tokens(params["embed"], tokens,
                                                 Sharder()), cfg.norm_type)
    a, pos = lp["attn"], torch.arange(tokens.shape[1], device=tokens.device)
    q = torch.einsum("bsd,dhe->bshe", x, a["wq"]) + a.get("bq", 0.0)
    k = torch.einsum("bsd,dke->bske", x, a["wk"]) + a.get("bk", 0.0)
    q, k = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
    k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    s = torch.einsum("bshe,bthe->bhst", q, k) / cfg.d_head ** 0.5
    causal = torch.ones(s.shape[-2:], dtype=torch.bool,
                        device=s.device).tril()
    return float(s[..., causal].std())


def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_full_width(torch, np, arch, card, bad) -> dict:
    """One full-width model on the card with the port's seeded init (bf16):
    its parameter count, prefill of LM_B prompts × LM_PROMPT tokens and
    LM_NEW greedy decode steps (ms, tokens/s, device activities and busy
    share of a decode step, peak memory, FLOP/s from the cost model),
    prefill-then-decode against the longer prefill (gated in float32 at
    LM_CONSIST_LAYERS of its layers, the MoE's gap at capacity 1.25 held
    to the CPU's; printed in bf16 and at full depth beside the chaos
    probe), and for the SSM the Δ decode at Δ_TH 0 against the dense
    decode."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costmodel
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import tree_leaves, tree_map
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = get_api(cfg, device="cuda")
    params, _ = api.init(torch.Generator(device="cuda").manual_seed(0))
    n_init = sum(t.numel() for t in tree_leaves(params))
    n_model = costmodel.param_count(cfg)
    bad.check(n_init == n_model + _qkv_bias_params(cfg),
              f"{arch}: init holds {n_init} parameters, the cost model "
              f"{n_model} and the q/k/v biases {_qkv_bias_params(cfg)}")
    toks, _ = _lm_inputs(torch, np, cfg, LM_B, LM_PROMPT, 1, "cuda")
    prompt = toks[:, :LM_PROMPT]

    def prefill():
        return api.prefill(params, prompt, api.init_cache(LM_B, LM_CACHE))

    prefill()                                         # warm-up
    pre_ms = []
    for _ in range(LM_PREFILL_REPS):
        (cache, logits), ms = _sync_ms(torch, prefill)
        pre_ms.append(ms)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    dec_ms, finite = [], True
    for _ in range(LM_NEW):
        (logits, cache), ms = _sync_ms(
            torch, lambda: api.decode_step(params, cache, tok))
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        finite &= bool(torch.isfinite(logits.float()).all())
        dec_ms.append(ms)
    bad.check(finite, f"{arch}: decode logits not finite")
    (_, acts, busy_ms) = cuda_activities(
        torch, lambda: api.decode_step(params, cache, tok))
    peak = torch.cuda.max_memory_allocated()
    pre = statistics.median(pre_ms)
    dec = statistics.median(dec_ms[2:])
    c_pre = costmodel.step_costs(cfg, ShapeConfig("p", LM_PROMPT, LM_B,
                                                  "prefill"))
    c_dec = costmodel.step_costs(cfg, ShapeConfig("d", LM_CACHE, LM_B,
                                                  "decode"))
    # Prefill-then-decode against the longer prefill, in float32 on the
    # first LM_CONSIST_LAYERS layers of the same full-width weights.  The
    # seed's init (``layers.py::_init``) takes fan-in from shape[-2], so
    # wq (D, H, Dh) is scaled by 1/√H and wk by 1/√K, not 1/√D: layer 0's
    # attention scores have a std of ~10² and the softmax is a hard max.
    # Past a few layers two orders of summation then part by O(1) (the
    # probe below; the JAX reference does the same on the CPU,
    # benchmarks/lm_chaos_witness.py); bf16 and the full depth are
    # printed.  MoE at the reference's capacity 1.25: a 129-token group
    # keeps other (token, expert) pairs than a 128-token one, so the two
    # part by design (the reference's own check leaves MoE out), and the
    # card's gap is held to the CPU's on the same weights instead.
    def paths(c, p, device="cuda"):
        capi = get_api(c, device=device)
        t = toks.to(device)
        c1, _ = capi.prefill(p, t[:, :LM_PROMPT],
                             capi.init_cache(LM_B, LM_CACHE))
        step, _ = capi.decode_step(p, c1, t[:, LM_PROMPT:LM_PROMPT + 1])
        _, full = capi.prefill(p, t, capi.init_cache(LM_B, LM_CACHE))
        return step.float(), full.float()

    def gap(c, p):
        step, full = paths(c, p)
        ok = torch.allclose(step, full, rtol=LM_CONSIST_TOL,
                            atol=LM_CONSIST_TOL)
        return float((step - full).abs().max()), ok

    f32 = tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    n_cut = min(LM_CONSIST_LAYERS, cfg.num_layers)
    cut32 = dataclasses.replace(cfg32, num_layers=n_cut)
    w32 = _first_layers(f32, cfg, n_cut)
    gated = f"{n_cut} layers, float32"
    moe_gap = None
    if cfg.family == "moe":
        step, full = paths(cut32, w32)
        on_cpu = paths(cut32, tree_map(lambda t: t.cpu(), w32), "cpu")
        g_card, g_cpu = (step - full).cpu(), on_cpu[0] - on_cpu[1]
        ok = torch.allclose(g_card, g_cpu, rtol=LM_CONSIST_TOL,
                            atol=LM_CONSIST_TOL)
        moe_gap = {"card": float(g_card.abs().max()),
                   "cpu": float(g_cpu.abs().max()),
                   "card_vs_cpu": float((g_card - g_cpu).abs().max()),
                   "ok": ok}
        consist = {gated: (moe_gap["card"], torch.allclose(
            step, full, rtol=LM_CONSIST_TOL, atol=LM_CONSIST_TOL))}
        bad.check(ok, f"{arch}: the prefill-then-decode gap at capacity "
                      f"1.25, {n_cut} full-width layers, float32, on the "
                      f"card against the CPU's: {moe_gap} beyond rtol = "
                      f"atol = {LM_CONSIST_TOL}")
    else:
        consist = {gated: gap(cut32, w32)}
        d, ok = consist[gated]
        bad.check(ok, f"{arch}: prefill-then-decode vs the longer prefill "
                      f"at {n_cut} full-width layers, float32, max|Δ| "
                      f"{d:.2e} beyond rtol = atol = {LM_CONSIST_TOL}")
    del w32
    consist[f"{n_cut} layers"] = gap(
        dataclasses.replace(cfg, num_layers=n_cut),
        _first_layers(params, cfg, n_cut))
    consist["full depth"] = gap(cfg, params)
    consist["full depth, float32"] = gap(cfg32, f32)
    # the chaos probe: float32, the embedding scaled by 1 + 1e-6
    probe = {}
    for n in sorted({*LM_PROBE_LAYERS, cfg.num_layers}):
        if n > cfg.num_layers:
            continue
        c = dataclasses.replace(cfg32, num_layers=n)
        w = _first_layers(f32, cfg, n)
        api32 = get_api(c, device="cuda")
        nudged = dict(w, embed={"table": w["embed"]["table"] * (1 + 1e-6)})
        _, a = api32.prefill(w, toks, api32.init_cache(LM_B, LM_CACHE))
        _, b = api32.prefill(nudged, toks, api32.init_cache(LM_B, LM_CACHE))
        probe[n] = float((a - b).abs().max())
        del w, nudged, a, b
    score_std = (_score_std(torch, cfg, f32, prompt)
                 if cfg.family in ("dense", "moe") else None)
    del f32
    delta = None
    if cfg.family == "ssm":
        del cache
        f32 = tree_map(lambda t: t.float(), params)
        del params
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    use_delta=True, delta_threshold=0.0)
        apis = [get_api(c, device="cuda") for c in
                (cfg32, dataclasses.replace(cfg32, use_delta=False))]
        caches = [a.init_cache(LM_B, LM_CACHE) for a in apis]
        delta = 0.0
        for t in range(LM_DELTA_STEPS):
            outs = []
            for i, a in enumerate(apis):
                lg, caches[i] = a.decode_step(f32, caches[i], toks[:, t:t + 1])
                outs.append(lg)
            delta = max(delta, _lm_rel(outs[0], outs[1]))
        bad.check(delta <= LM_DELTA_TOL,
                  f"{arch}: Δ decode at Δ_TH 0 vs dense {delta:.2e} > "
                  f"{LM_DELTA_TOL}")
        del f32, caches
    res = {"arch": arch, "params": n_init, "param_count": n_model,
           "prefill_ms": pre, "prefill_tok_s": LM_B * LM_PROMPT / pre * 1e3,
           "decode_ms_per_token": dec, "decode_tok_s": LM_B / dec * 1e3,
           "decode_activities": acts, "decode_busy_ms": busy_ms,
           "decode_busy_share": busy_ms / dec, "peak_bytes": peak,
           "prefill_flops_s": c_pre.hlo_flops / (pre / 1e3),
           "decode_flops_s": c_dec.hlo_flops / (dec / 1e3),
           "prefill_model_flops_s": c_pre.model_flops / (pre / 1e3),
           "consistency_max_abs": {k: v[0] for k, v in consist.items()},
           "moe_gap_max_abs": moe_gap, "chaos_probe_max_abs": probe,
           "layer0_score_std": score_std, "delta_vs_dense": delta}
    print(f"[lm] {arch} full width on {card}: {n_init / 1e6:.1f} M params "
          f"(cost model {n_model / 1e6:.1f} M), peak "
          f"{peak / 2**30:.2f} GiB; prefill {LM_B}x{LM_PROMPT} "
          f"{pre:.2f} ms median of {LM_PREFILL_REPS} "
          f"({res['prefill_tok_s']:.0f} tok/s, "
          f"{res['prefill_flops_s'] / 1e12:.2f} TFLOP/s); decode "
          f"{dec:.2f} ms per token step of {LM_B} "
          f"({res['decode_tok_s']:.0f} tok/s, "
          f"{res['decode_flops_s'] / 1e12:.3f} TFLOP/s), {acts} device "
          f"activities a step, busy {busy_ms:.2f} ms = "
          f"{100 * res['decode_busy_share']:.1f} % of the step")
    print(f"[lm] {arch} prefill-then-decode vs the longer prefill: "
          + ", ".join(f"{k} max|Δ| {d:.2e} ({'ok' if ok else 'beyond'} "
                      f"{LM_CONSIST_TOL})" for k, (d, ok) in consist.items())
          + ("" if moe_gap is None else
             f"; the {gated} gap at capacity 1.25, card {moe_gap['card']:.4f}"
             f" against the CPU's {moe_gap['cpu']:.4f} (max|Δ| "
             f"{moe_gap['card_vs_cpu']:.2e}, "
             f"{'ok' if moe_gap['ok'] else 'beyond'} {LM_CONSIST_TOL})")
          + "; float32, embedding × (1 + 1e-6): max|Δ| "
          + ", ".join(f"{v:.4f} at {n} layers" for n, v in probe.items())
          + ("" if score_std is None else
             f"; layer 0's attention scores: std {score_std:.1f}")
          + ("" if delta is None else
             f"; Δ decode at Δ_TH 0 vs dense (f32, {LM_DELTA_STEPS} steps) "
             f"{delta:.2e} of max|·|"))
    torch.cuda.empty_cache()
    return res


def lm_clis(torch, np, bad) -> dict:
    """The LM CLIs on the card, in this process: ``serve --mode lm``, the
    full-config ``train`` and its resume; then the reference's smoke
    check that AdamW on one repeated batch lowers the loss."""
    import contextlib
    import io
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train import optimizer as opt
    out = {}
    argv = ["--mode", "lm", "--arch", "qwen2-0.5b", "--requests", "8",
            "--slots", "4"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    text = buf.getvalue()
    print(f"[lm] serve {' '.join(argv)}: rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s: {text.splitlines()[0]}")
    bad.check(rc == 0 and "served 8 requests" in text,
              f"serve --mode lm: rc {rc}, printed {text[:200]!r}")
    out["serve_line"] = text.splitlines()[0]
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", "qwen2-0.5b", "--full-config", "--batch", "8",
                "--seq", "128", "--ckpt-dir", d]
        t0 = time.perf_counter()
        run = train.train_lm(train.build_parser().parse_args(
            base + ["--steps", "4"]))
        t_run = time.perf_counter() - t0
        losses = [h.metrics["loss"] for h in run["trainer"].history]
        walls = [h.wall_s * 1e3 for h in run["trainer"].history]
        bad.check(len(losses) == 4 and all(np.isfinite(losses)),
                  f"train --full-config: losses {losses}")
        t0 = time.perf_counter()
        run2 = train.train_lm(train.build_parser().parse_args(
            base + ["--steps", "1"]))
        t_resume = time.perf_counter() - t0
        bad.check(run2["start"] == 4 and run2["trainer"].step == 5,
                  f"train resume: restored step {run2['start']}, ended at "
                  f"{run2['trainer'].step}")
        print(f"[lm] train {' '.join(base[:-2])} --steps 4: losses "
              f"{[round(x, 4) for x in losses]}, step ms {[round(w, 1) for w in walls]}, "
              f"{t_run:.1f} s with its checkpoint; resumed from step "
              f"{run2['start']} to {run2['trainer'].step} in "
              f"{t_resume:.1f} s")
        out.update(train_losses=losses, train_step_ms=walls,
                   train_run_s=t_run, resume_s=t_resume)
        del run, run2
    torch.cuda.empty_cache()
    cfg = get_smoke_config("qwen2-0.5b")
    fn, _ = build_train_step(cfg, ShapeConfig("tiny", 32, 4, "train"),
                             Sharder(), opt_cfg=opt.AdamWConfig(
                                 lr=1e-2, warmup_steps=0, weight_decay=0.0,
                                 total_steps=1000))
    params, _ = get_api(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    state = opt.init(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).cuda()
    losses = []
    for _ in range(12):
        params, state, m = fn(params, state, {"tokens": toks,
                                              "labels": toks})
        losses.append(float(m["loss"]))
    bad.check(losses[-1] < losses[0] - 0.5,
              f"smoke AdamW on one batch: losses {losses}")
    print(f"[lm] smoke qwen2-0.5b, 12 AdamW steps on one batch: loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}")
    out["smoke_losses"] = losses
    return out


def lm_phase(torch, np, card) -> dict:
    """Phase 11: the LM stacks on the card (no kernel of the port runs:
    every wrapper's count stays 0)."""
    bad = Failures("LM phase")
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    worst = lm_smoke_against_cpu(torch, np, bad)
    t_smoke = time.perf_counter() - t0
    full = [lm_full_width(torch, np, arch, card, bad) for arch in LM_FULL]
    t_full = time.perf_counter() - t0
    clis = lm_clis(torch, np, bad)
    launched = {k: v for k, v in read_launches(wrappers).items() if v}
    bad.check(not launched, f"the LM path launched kernels: {launched}")
    secs = time.perf_counter() - t0
    print(f"[lm] phase {secs:.1f} s (smoke {t_smoke:.1f} s, full width "
          f"{t_full - t_smoke:.1f} s, CLIs {secs - t_full:.1f} s); "
          f"kernel launches on the LM path: 0")
    print("[lm] " + json.dumps({"card": card, "smoke_f32_rel_err": worst,
                                "full_width": full, "clis": clis}))
    bad.raise_any()
    return {"seconds": secs, "full_width": full}


# ------------------------------------------------------- the slot mesh --
MESH_SHARDS = 2                # phase 12: shards on one card, own streams
MESH_CHUNKS = 4                # the bit-for-bit runs: SLOTS × 4 chunks
MESH_TIMED_CHUNKS, MESH_ROUNDS = 16, 5    # the 256-slot timing
MESH_CPU_CUTS = ((0, 1000), (1000, 1001), (1001, 2048))


def mesh_kinds(torch, cascade_cfg=CASCADE_SERVE):
    """(kind, numerics, session keywords, path kernels) of the serving
    modes phase 12 shards."""
    from repro_torch.frontend.vad import VADConfig
    from repro_torch.models.detector import DetectorConfig
    det = dict(detector=DetectorConfig(0.3, 0.095, 0.09, 4),
               vad=VADConfig(0.02))
    cas = dict(det, cascade=cascade_config(cascade_cfg),
               stage0_params=stage0(torch))
    kinds = []
    for numerics in ("float32", "int8"):
        fex, gru = (("batched_iir_fex_int", "delta_gru_seq_int")
                    if numerics == "int8"
                    else ("batched_iir_fex", "delta_gru_seq"))
        kinds += [("plain", numerics, {}, (fex, gru)),
                  ("detect", numerics, det, (fex, gru, "detect_head")),
                  ("cascade", numerics, cas,
                   (fex, gru, f"{gru} (masked)", "wake_head",
                    "detect_head"))]
    return kinds


def trace_tensors(torch, sess, outs) -> dict:
    """A session's chunk results (concatenated over chunks) and its
    joined per-stream state, by name, on the host."""
    from repro_torch.parallel.sharding import tensors_of
    got = {f: torch.cat([getattr(o, f) for o in outs])
           for f in outs[0]._fields if getattr(outs[0], f) is not None}
    for name in ("state", "fex_state", "vad_state", "det_state",
                 "cas_state"):
        for k, t in enumerate(tensors_of(getattr(sess, name))):
            got[f"{name}[{k}]"] = t
    return {k: v.cpu() for k, v in got.items()}


def differing(torch, a: dict, b: dict) -> dict:
    """Elements differing bit for bit, by name (floats by bit pattern)."""
    out = {}
    for k, x in a.items():
        y = b.get(k)
        if y is None or x.shape != y.shape or x.dtype != y.dtype:
            out[k] = "shape or dtype"
            continue
        n = (bits_differ(torch, x, y) if x.dtype == torch.float32
             else int((x != y).sum()))
        if n:
            out[k] = n
    return out


def no_slo(summary):
    return dataclasses.replace(summary, slo={})


def mesh_bit_for_bit(torch, np, params, mesh, bad, tag: str) -> dict:
    """Every serving mode in both numerics, SLOTS slots × MESH_CHUNKS
    chunks of keyword streams with a reset of one slot per shard between
    chunks: the sharded session against the unsharded one on the card,
    every output, state and summary bit for bit; launch counts zeroed
    just before the sharded run and read just after: each path kernel
    once per shard per step, nothing else."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.streaming import StreamingKwsSession
    wrappers = kernel_wrappers()
    n, B = mesh.size, SLOTS
    per = B // n
    audio = fault_audio(np, B, MESH_CHUNKS * CHUNK, 12)
    resets = [[i * per + (5 * c + 1) % per for i in range(n)]
              for c in range(MESH_CHUNKS - 1)]
    launches = {}
    for kind, numerics, kw, path in mesh_kinds(torch):
        runs = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            sess = StreamingKwsSession(params, CONFIG, threshold=0.1,
                                       batch=B, numerics=numerics, mesh=m,
                                       **kw)
            torch.cuda.synchronize()
            zero_launches(wrappers)
            outs = []
            for c in range(MESH_CHUNKS):
                outs.append(sess.process_audio(
                    audio[:, c * CHUNK:(c + 1) * CHUNK]))
                if c < MESH_CHUNKS - 1:
                    sess.reset_streams(resets[c])
            torch.cuda.synchronize()
            got = read_launches(wrappers)
            runs[label] = (trace_tensors(torch, sess, outs),
                           no_slo(sess.summary()))
        diff = differing(torch, runs["unsharded"][0], runs["sharded"][0])
        same_summary = runs["unsharded"][1] == runs["sharded"][1]
        want = n * MESH_CHUNKS
        off = {k: v for k, v in got.items()
               if v != (want if k in path else 0)}
        launches[(kind, numerics)] = {k: got[k] for k in path}
        summ = runs["sharded"][1]
        events = runs["sharded"][0].get("events")
        fires = -1 if events is None else int((events >= 0).sum())
        print(f"[mesh] {tag}: {kind} {numerics}, {B} slots x {MESH_CHUNKS} "
              f"chunks of {CHUNK}, against the unsharded session: "
              f"differing {diff or 'nothing'}, summaries "
              f"{'equal' if same_summary else 'DIFFER'}, launches "
              f"{launches[(kind, numerics)]} (want {want} each), fires "
              f"{fires}, vad duty {summ.vad_duty:.3f}, stage-1 duty "
              f"{summ.stage1_duty:.3f}")
        bad.check(not diff and same_summary,
                  f"{tag} {kind} {numerics}: sharded != unsharded {diff}")
        bad.check(not off, f"{tag} {kind} {numerics}: launches {off}, "
                           f"want {want} of {path} and 0 of the others")
    return launches


def mesh_against_cpu(torch, np, params, bad):
    """Two-shard CUDA sessions against two-shard CPU sessions (the plain
    versions) in every mode and numerics: 4 continuous streams, three
    unaligned chunks of 2048 samples with a reset of slots 1 and 2 (one
    per shard) after the first.  int8: every code, vote, event, gate,
    awake bit and state equal; float: those equal but the float values,
    logits and float state within 1e-4, and the CPU's stage-0 scores more
    than SCORE_MARGIN from both thresholds."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import make_streams
    from repro_torch.launch import streaming
    from repro_torch.launch.mesh import SlotMesh
    streams = make_streams(7, 4, duration_s=1.5, snr_db=20.0,
                           events_per_min=60.0)
    audio = np.stack([s.audio[:MESH_CPU_CUTS[-1][1]] for s in streams])
    for kind, numerics, kw, _ in mesh_kinds(torch, CASCADE_CHECK):
        res, scores = {}, None
        for dev in ("cuda", "cpu"):
            sess = streaming.StreamingKwsSession(
                params, CONFIG, threshold=0.1, batch=4, numerics=numerics,
                mesh=SlotMesh.on(dev, MESH_SHARDS), **kw)
            outs = []
            with capture_args(streaming, "cascade_wake_scan") as cap:
                for k, (lo, hi) in enumerate(MESH_CPU_CUTS):
                    outs.append(sess.process_audio(audio[:, lo:hi]))
                    if k == 0:
                        sess.reset_streams([1, 2])
            res[dev] = trace_tensors(torch, sess, outs)
            if dev == "cpu" and cap.calls:
                scores = torch.cat([a[3].reshape(-1) for a, _ in cap.calls])
        c, p = res["cuda"], res["cpu"]
        exact = numerics == "int8"
        floats = [k for k, v in p.items() if v.is_floating_point()
                  and not exact]
        mism = differing(torch, {k: c[k] for k in p if k not in floats},
                         {k: p[k] for k in p if k not in floats})
        err = max([(c[k] - p[k]).abs().max().item() for k in floats
                   if p[k].numel()] or [0.0])
        margin = (min((scores - t).abs().min().item()
                      for t in CASCADE_CHECK[:2])
                  if scores is not None else None)
        print(f"[mesh] {kind} {numerics}, {MESH_SHARDS} shards, CUDA vs "
              f"CPU, 4 streams x 2048 samples: mismatches "
              f"{mism or 'none'}, float values max abs diff {err:.3g}"
              + (f", CPU stage-0 scores' least distance to a threshold "
                 f"{margin:.3g}" if margin is not None else ""))
        bad.check(not mism and err <= 1e-4,
                  f"{kind} {numerics} sharded CUDA vs CPU: {mism}, {err}")
        if kind == "cascade" and not exact:
            bad.check(margin > SCORE_MARGIN,
                      f"a stage-0 score lies {margin} from a threshold")


def fc_row_probe(torch, bad) -> dict:
    """Why the float FC sums in a fixed order (``streaming._fc``): cuBLAS's
    ``hs @ w + b`` over each shard's block of streams against the same
    rows of the whole batch, at the serving FC's (64 → 12) and stage 0's
    (16 → 2) widths, F = 16 and 32 frames, B = 32 and 256 streams, 2 and 4
    shards: the cases whose bits differ, for cuBLAS and for ``_fc``
    (which must have none)."""
    from repro_torch.launch.streaming import _fc
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = diff_mm = diff_fc = 0
    for H, K in ((64, 12), (16, 2)):
        w = torch.randn(H, K, device="cuda", generator=gen)
        b = torch.randn(K, device="cuda", generator=gen)
        for F in (16, 32):
            for B in (32, 256):
                hs = torch.rand(F, B, H, device="cuda", generator=gen) * 2 - 1
                full_mm, full_fc = hs @ w + b, _fc(hs, w, b)
                for n in (2, 4):
                    blocks = [x.contiguous() for x in hs.chunk(n, dim=1)]
                    mm = torch.cat([x @ w + b for x in blocks], dim=1)
                    fc = torch.cat([_fc(x, w, b) for x in blocks], dim=1)
                    cases += 1
                    diff_mm += bits_differ(torch, mm, full_mm) > 0
                    diff_fc += bits_differ(torch, fc, full_fc) > 0
    print(f"[mesh] the float FC over each shard's streams against the same "
          f"rows of the whole batch, {cases} cases (64 -> 12 and 16 -> 2, "
          f"F 16 and 32, B 32 and 256, 2 and 4 shards): cuBLAS hs @ w + b "
          f"differs in {diff_mm}, streaming._fc in {diff_fc}")
    bad.check(diff_fc == 0, f"_fc depends on the row count in {diff_fc} "
                            f"cases")
    return {"cases": cases, "cublas_differs": diff_mm, "fc_differs": diff_fc}


def mesh_timing(torch, np, params, card, profile, numerics, mesh, bad):
    """The always-on plain step at ALWAYS_ON_SLOTS slots, unsharded
    against ``mesh``, MESH_ROUNDS alternating rounds of MESH_TIMED_CHUNKS
    chunks on the same audio (each step's votes fetched, the host clock
    between synchronisations; medians); the last round's outputs bit for
    bit equal.  ``--profile``: device activities and busy share of
    each."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.launch.engine import warm_session
    from repro_torch.launch.streaming import StreamingKwsSession
    B, n = ALWAYS_ON_SLOTS, MESH_TIMED_CHUNKS
    streams = always_on_streams(np)
    sessions = {1: StreamingKwsSession(params, CONFIG, threshold=0.1,
                                       batch=B, numerics=numerics),
                mesh.size: StreamingKwsSession(params, CONFIG, threshold=0.1,
                                               batch=B, numerics=numerics,
                                               mesh=mesh)}
    for sess in sessions.values():
        warm_session(sess, CHUNK)
    ms = {k: [] for k in sessions}
    last = {}
    for r in range(MESH_ROUNDS):
        for k in (list(sessions) if r % 2 == 0 else list(sessions)[::-1]):
            sess = sessions[k]
            sess.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = []
            for c in range(n):
                out = sess.process_audio(streams[:, c * CHUNK:(c + 1) * CHUNK])
                out.votes.cpu()
                outs.append(out)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3 / n)
            last[k] = outs
    same = all(not bits_differ(torch, a.logits, b.logits)
               and torch.equal(a.votes, b.votes)
               for a, b in zip(last[1], last[mesh.size]))
    med = {k: statistics.median(v) for k, v in ms.items()}
    devs = ", ".join(str(d) for d in mesh.devices)
    print(f"[mesh] always-on plain {numerics}, {B} slots x {n} chunks of "
          f"{CHUNK}, {MESH_ROUNDS} alternating rounds: unsharded "
          f"{med[1]:.3f} ms per step {[round(x, 3) for x in ms[1]]}, "
          f"{mesh.size} shards ({devs}) {med[mesh.size]:.3f} ms "
          f"{[round(x, 3) for x in ms[mesh.size]]} "
          f"({med[mesh.size] / med[1]:.2f}x), outputs "
          f"{'equal bit for bit' if same else 'DIFFER'} [{card}]")
    bad.check(same, f"{numerics} 256-slot sharded step differs from the "
                    f"unsharded one")
    if profile:
        for k, sess in sessions.items():
            sess.reset()
            print(f"[mesh] profile of the {numerics} step, {k} shard(s):")
            profile_steps(torch, sess, streams, numerics)
    return {"unsharded_ms": med[1], "sharded_ms": med[mesh.size],
            "shards": mesh.size}


def serve_on_cards(torch, n: int, bad):
    """``serve --mode kws-audio --devices n`` (one shard per card) against
    ``--devices 1`` through the CLI's entry point, counts zeroed just
    before each run and read just after: the same decisions and summary;
    the path's kernels once per shard per step (+ the warm-up step)."""
    from repro_torch.launch import serve
    wrappers = kernel_wrappers()
    runs = {}
    for d in (1, n):
        args = serve.build_parser().parse_args(
            ["--mode", "kws-audio", "--devices", str(d), "--slots",
             str(SLOTS), "--requests", str(REQUESTS), "--chunk-samples",
             str(CHUNK), "--train-steps", "0"])
        serve.validate_args(args)
        zero_launches(wrappers)
        sess, done, _, stats, dt = serve.serve_kws_audio(args)
        torch.cuda.synchronize()
        runs[d] = (done, no_slo(sess.summary()), read_launches(wrappers),
                   stats["steps"], dt)
    (done1, summ1, _, _, dt1), (done_n, summ_n, got, steps, dt_n) = \
        runs[1], runs[n]
    want = n * (steps + 1)
    print(f"[mesh] serve --mode kws-audio --devices {n}: {len(done_n)} "
          f"requests in {dt_n:.2f} s ({dt1:.2f} s at --devices 1), "
          f"decisions {'equal' if done_n == done1 else 'DIFFER'}, "
          f"summaries {'equal' if summ_n == summ1 else 'DIFFER'}, "
          f"launches {got['batched_iir_fex']} / {got['delta_gru_seq']} "
          f"(want {want})")
    bad.check(done_n == done1 and summ_n == summ1,
              f"serve --devices {n} decides otherwise than --devices 1")
    bad.check(got["batched_iir_fex"] == got["delta_gru_seq"] == want,
              f"serve --devices {n} launches {got}, want {want}")


def mesh_phase(torch, np, params, card, profile) -> dict:
    """Phase 12: the slot mesh — two shards on the one card, each on its
    own stream, in every serving mode and numerics; then ``serve
    --devices``."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import SlotMesh, make_slot_mesh
    bad = Failures("slot mesh phase")
    t0 = time.perf_counter()
    probe = fc_row_probe(torch, bad)
    one_card = SlotMesh.on("cuda", MESH_SHARDS)
    launches = mesh_bit_for_bit(torch, np, params, one_card, bad,
                                f"{MESH_SHARDS} shards on one card")
    mesh_against_cpu(torch, np, params, bad)
    check_no_syncs(torch, np, params, bad, shards=MESH_SHARDS,
                   resets=(3, SLOTS - 1), tag="mesh")
    timing = {numerics: mesh_timing(torch, np, params, card, profile,
                                    numerics, one_card, bad)
              for numerics in ("float32", "int8")}
    count = torch.cuda.device_count()
    args = serve.build_parser().parse_args(
        ["--mode", "kws-audio", "--devices", "2", "--slots", str(SLOTS),
         "--train-steps", "0"])
    serve.validate_args(args)
    if count < 2:
        try:
            serve.slot_mesh(args)
            err = None
        except ValueError as e:
            err = str(e)
        print(f"[mesh] serve --mode kws-audio --devices 2 with {count} "
              f"card: ValueError: {err}")
        bad.check(err is not None and "visible" in err,
                  "--devices 2 on one card did not raise 'beyond visible'")
        print(f"[mesh] this machine has {count} card: the slot mesh over "
              f"distinct cards (make_slot_mesh, steps 1 and 4) did not run")
    else:
        mesh = make_slot_mesh(min(count, 4))
        mesh_bit_for_bit(torch, np, params, mesh, bad,
                         f"make_slot_mesh({mesh.size})")
        for numerics in ("float32", "int8"):
            timing[f"{numerics} cards"] = mesh_timing(
                torch, np, params, card, profile, numerics, mesh, bad)
        serve_on_cards(torch, mesh.size, bad)
    print(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    bad.raise_any()
    return {"launches": launches, "timing": timing, "fc_probe": probe}


# ------------------------------------------------ phase 13: the LM mesh --
# The reference's GSPMD placement as DTensor on a DeviceMesh, one process
# per rank (NCCL takes one rank per card).  No kernel of the port lies on
# this path: every launch count stays 0.
LMM_ARCH = "qwen2-0.5b"
LMM_B, LMM_S = 8, 128          # the train batch: 8 sequences × 128 tokens
LMM_STEPS_ONE, LMM_STEPS = 2, 3
LMM_PROMPT, LMM_NEW_ONE, LMM_NEW = 32, 8, 32
LMM_F32_LAYERS = 4             # depth of the float32 checks
LMM_LOSS_TOL, LMM_LEAF_TOL, LMM_LEAF_FRAC = 0.05, 0.05, 0.97   # reference's
LMM_F32_TOL = 1e-4             # float32 loss (relative), logits (of max|·|)
LMM_GATED_STEPS = 4            # decode steps whose logits are gated
LMM_WITNESS = 1e-7             # the chaos witness: embedding × (1 + this)
LMM_WITNESS_FACTOR = 4         # float32 gaps past step 1: ≤ 4 × witness
LMM_OPT = {"lr": 1e-2, "warmup_steps": 0, "weight_decay": 0.0}
# float32 at lr 1e-4: at 1e-2 Adam's first step is lr·sign(g), a
# gradient component at float32 noise level (sharded sums in another
# order, ~1e-6 of max|g|) flips to a full ±lr step, and the randomly
# initialised stack (chaotic: PERF.md §6) parts past 1e-4 by step 3
# (qwen2-0.5b smoke on 4 CPU ranks: 5e-3 at lr 1e-2, 1.6e-3 with eps
# 1e-3, 2.6e-5 at lr 1e-4).
LMM_F32_OPT = {**LMM_OPT, "lr": 1e-4}
LMM_MAX_RANKS = 4


def _lmm_cfg(full: bool, dtype=None, layers=None):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_config(LMM_ARCH) if full else get_smoke_config(LMM_ARCH)
    kw = {"dtype": dtype} if dtype is not None else {}
    if layers is not None:
        kw["num_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _lmm_tokens(torch, np, cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32))


def _lmm_sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _lmm_init(torch, cfg, shd, dev, perturb=False):
    """The seeded init (the same values on every rank), placed by ``shd``:
    (params, logical axes).  ``perturb``: the embedding scaled by
    1 + LMM_WITNESS (the chaos witness)."""
    from repro_torch.models import get_api
    gen = torch.Generator(device=dev if dev == "cpu" else
                          f"cuda:{torch.cuda.current_device()}")
    params, axes = get_api(cfg, shd, dev).init(gen.manual_seed(0))
    if perturb:
        params["embed"]["table"] = params["embed"]["table"] * (
            1 + LMM_WITNESS)
    return shd.shard_params(params, axes), axes


def _lmm_train(torch, np, cfg, shd, dev, steps_n, count=False,
               perturb=False):
    """``steps_n`` AdamW steps (the reference's test settings; float32 at
    LMM_F32_OPT) from the seeded init on LMM_B × LMM_S tokens: (losses,
    params, opt state, axes, ms per step, collectives of the last step by
    op)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import inputs, steps
    from repro_torch.train import optimizer as opt
    opt_kw = LMM_F32_OPT if cfg.dtype == torch.float32 else LMM_OPT
    params, axes = _lmm_init(torch, cfg, shd, dev, perturb)
    state = opt.init(params)
    fn, _ = steps.build_train_step(
        cfg, ShapeConfig("lm_mesh", seq_len=LMM_S, global_batch=LMM_B,
                         kind="train"), shd,
        opt_cfg=opt.AdamWConfig(**opt_kw))
    toks = _lmm_tokens(torch, np, cfg, LMM_B, LMM_S).to(dev)
    batch = inputs.place_batch({"tokens": toks[:, :LMM_S],
                                "labels": toks[:, 1:]}, shd)
    losses, ms, comm = [], [], {}
    for i in range(steps_n):
        _lmm_sync(torch, dev)
        t = time.perf_counter()
        if count and i == steps_n - 1:
            from torch.distributed.tensor.debug import CommDebugMode
            with CommDebugMode() as cm:
                params, state, m = fn(params, state, batch)
            comm = {str(k).split(".")[-1]: v
                    for k, v in cm.get_comm_counts().items()}
        else:
            params, state, m = fn(params, state, batch)
        _lmm_sync(torch, dev)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    return losses, params, state, axes, ms, comm


def _lmm_full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _lmm_greedy(torch, np, cfg, shd, dev, params, new, count=False):
    """Prefill of LMM_PROMPT tokens and ``new`` greedy tokens with the
    serving Sharder ``shd``: (tokens (B, new), logits (new, B, V) float32
    on the CPU, ms per decode step, collectives of the last step, the KV
    cache's placements, None without a mesh)."""
    from repro_torch.launch import inputs
    from repro_torch.models import get_api
    api = get_api(cfg, shd, dev)
    prompt = _lmm_tokens(torch, np, cfg, LMM_B, LMM_PROMPT, seed=2)[
        :, :LMM_PROMPT].to(dev)
    cache = api.init_cache(LMM_B, LMM_PROMPT + new)
    cache, logits = api.prefill(
        params, inputs.place_batch({"tokens": prompt}, shd)["tokens"], cache)
    toks, outs, ms, comm = [], [], [], {}
    for i in range(new):
        lg = _lmm_full(logits)[:, -1].float()
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        toks.append(nxt.cpu())
        outs.append(lg.cpu())
        if i == new - 1:
            break
        step_in = inputs.place_batch({"tokens": nxt}, shd)["tokens"]
        _lmm_sync(torch, dev)
        t = time.perf_counter()
        if count and i == new - 2:
            from torch.distributed.tensor.debug import CommDebugMode
            with CommDebugMode() as cm:
                logits, cache = api.decode_step(params, cache, step_in)
            comm = {str(k).split(".")[-1]: v
                    for k, v in cm.get_comm_counts().items()}
        else:
            logits, cache = api.decode_step(params, cache, step_in)
        _lmm_sync(torch, dev)
        ms.append((time.perf_counter() - t) * 1e3)
    kv = cache["k"]
    placed = str(tuple(kv.placements)) if hasattr(kv, "placements") else None
    return torch.cat(toks, dim=1), torch.stack(outs), ms, comm, placed


def _lmm_decode_params(torch, cfg, mesh, dev, perturb=False):
    """(serving Sharder with DECODE_RULES, params placed by it)."""
    from repro_torch.parallel.sharding import DECODE_RULES, Sharder
    shd = Sharder(mesh=mesh, rules=DECODE_RULES if mesh is not None
                  else None)
    return shd, _lmm_init(torch, cfg, shd, dev, perturb)[0]


def _lmm_peak_gb(torch, dev) -> float:
    return (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else 0.0)


def _lmm_baseline(torch, np, full, dev, new) -> dict:
    """The one-device runs the meshes are held to (no mesh): bf16 and
    float32 (first LMM_F32_LAYERS layers) training, greedy decode in
    both, and the float32 chaos witness (the same runs with the embedding
    scaled by 1 + LMM_WITNESS); every tensor kept is on the CPU."""
    from repro_torch.parallel.sharding import Sharder, tree_leaves
    one = Sharder(mesh=None)
    out = {}
    for tag, cfg, perturb in (
            ("bf16", _lmm_cfg(full), False),
            ("f32", _lmm_cfg(full, torch.float32, LMM_F32_LAYERS), False),
            ("f32_witness", _lmm_cfg(full, torch.float32, LMM_F32_LAYERS),
             True)):
        losses, params, _, _, ms, _ = _lmm_train(torch, np, cfg, one, dev,
                                                 LMM_STEPS, perturb=perturb)
        leaf = tree_leaves(params)[0].float().cpu()
        del params
        dshd, dparams = _lmm_decode_params(torch, cfg, None, dev, perturb)
        toks, logits, dms, _, _ = _lmm_greedy(torch, np, cfg, dshd, dev,
                                              dparams, new)
        del dparams
        out[tag] = {"losses": losses, "leaf": leaf, "train_ms": ms,
                    "tokens": toks, "logits": logits, "decode_ms": dms}
    out["peak_gb"] = _lmm_peak_gb(torch, dev)
    return out


def _lmm_rank(rank, n, full, dev, workdir):
    """One rank of the multi-rank half (``launch.mesh.run_ranks``): the
    sharded runs on ``(n/2, 2)``, the elastic restore ``(n, 1)`` →
    ``(n/2, 2)`` and a float32 loss on ``(1, n)``."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import Sharder, tree_leaves
    from repro_torch.train import checkpoint as ckpt
    res = {}
    mesh = make_host_mesh(model=2, device=dev)
    shd = Sharder(mesh=mesh)
    for tag, cfg in (("bf16", _lmm_cfg(full)),
                     ("f32", _lmm_cfg(full, torch.float32, LMM_F32_LAYERS))):
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, params, state, axes, ms, comm = _lmm_train(
            torch, np, cfg, shd, dev, LMM_STEPS, count=True)
        leaf = _lmm_full(tree_leaves(params)[0]).float().cpu()
        res[tag] = {"losses": losses, "leaf": leaf, "train_ms": ms,
                    "train_comm": comm,
                    "train_peak_gb": _lmm_peak_gb(torch, dev)}
        del params, state
        dshd, dparams = _lmm_decode_params(torch, cfg, mesh, dev)
        toks, logits, dms, dcomm, placed = _lmm_greedy(
            torch, np, cfg, dshd, dev, dparams, LMM_NEW, count=True)
        res[tag].update({"tokens": toks, "logits": logits,
                         "decode_ms": dms, "decode_comm": dcomm,
                         "cache_placements": placed})
        del dparams
    # The elastic restore: params saved from (n, 1), restored onto (n/2, 2).
    cfg = _lmm_cfg(full, torch.float32, LMM_F32_LAYERS)
    wide = Sharder(mesh=make_host_mesh(model=1, device=dev))
    params, axes = _lmm_init(torch, cfg, wide, dev)
    ckpt.save(workdir, 7, {"params": params})
    back = ckpt.restore(workdir, 7, {"params": params}, shardings={
        "params": shd.param_shardings(params, axes)})["params"]
    want = shd.param_shardings(params, axes)
    same = all(torch.equal(_lmm_full(a), _lmm_full(b)) for a, b in
               zip(tree_leaves(params), tree_leaves(back)))
    placed = all(b.device_mesh == mesh and tuple(b.placements)
                 == w.placements for b, w in
                 zip(tree_leaves(back), tree_leaves(want)))
    res["elastic"] = {"equal": same, "placed": placed}
    del params, back
    # (1, n): 14 heads and 2 KV heads fall back to replicated at model = n.
    tall = Sharder(mesh=make_host_mesh(model=n, device=dev))
    losses = _lmm_train(torch, np, cfg, tall, dev, 1)[0]
    res["tall"] = {"loss": losses[0],
                   "heads_spec": str(tall.spec((cfg.d_model, cfg.n_heads,
                                                cfg.d_head),
                                               ("embed", "heads",
                                                "head_dim"))),
                   "kv_spec": str(tall.spec((cfg.d_model, cfg.n_kv_heads,
                                             cfg.d_head),
                                            ("embed", "kv_heads",
                                             "head_dim")))}
    launched = {k: v for k, v in read_launches(kernel_wrappers()).items()
                if v}
    res["launched"] = launched
    return res


def _lmm_world1(torch, np, full, dev, workdir, bad) -> dict:
    """A world-1 process group and ``make_host_mesh(model=1)``: 2 train
    steps and LMM_NEW_ONE greedy tokens with DTensor params against the
    same without a mesh, bit for bit; a save → restore(shardings=) round
    trip of the meshed params."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import Sharder, tree_leaves
    from repro_torch.train import checkpoint as ckpt
    kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
        if dev == "cuda" else {}
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"file://{workdir}/store", rank=0,
                            world_size=1, **kw)
    try:
        mesh = make_host_mesh(model=1, device=dev)
        cfg = _lmm_cfg(full)
        runs = {}
        for tag, shd in (("plain", Sharder(mesh=None)),
                         ("mesh", Sharder(mesh=mesh))):
            losses, params, state, axes, ms, _ = _lmm_train(
                torch, np, cfg, shd, dev, LMM_STEPS_ONE)
            leaves = [_lmm_full(x) for x in tree_leaves(
                {"params": params, "opt": state})]
            dshd, dparams = _lmm_decode_params(
                torch, cfg, mesh if tag == "mesh" else None, dev)
            toks, logits, dms, _, _ = _lmm_greedy(torch, np, cfg, dshd,
                                                  dev, dparams, LMM_NEW_ONE)
            runs[tag] = (losses, leaves, ms, toks, logits, dms)
            if tag == "mesh":
                ckpt.save(workdir, 1, {"params": params})
                back = ckpt.restore(workdir, 1, {"params": params},
                                    shardings={"params": shd.param_shardings(
                                        params, axes)})["params"]
                round_trip = all(
                    torch.equal(a.to_local(), b.to_local())
                    and b.placements == a.placements
                    for a, b in zip(tree_leaves(params), tree_leaves(back)))
                del back
            del params, state, dparams, leaves
        (l0, p0, ms0, t0, g0, d0), (l1, p1, ms1, t1, g1, d1) = \
            runs["plain"], runs["mesh"]
        same_train = l0 == l1 and all(torch.equal(a, b)
                                      for a, b in zip(p0, p1))
        same_decode = torch.equal(t0, t1) and torch.equal(g0, g1)
        print(f"[lm-mesh] world 1, make_host_mesh(model=1), {LMM_ARCH} "
              f"full width bf16, B = {LMM_B} × {LMM_S}: {LMM_STEPS_ONE} "
              f"AdamW steps with DTensor params "
              f"{'equal' if same_train else 'DIFFER'} bit for bit "
              f"(losses {l1}), {LMM_NEW_ONE} greedy tokens "
              f"{'equal' if same_decode else 'DIFFER'}; ms per train step "
              f"{ms1[-1]:.1f} meshed / {ms0[-1]:.1f} plain (first "
              f"{ms1[0]:.1f} / {ms0[0]:.1f}); ms per decode step "
              f"{statistics.median(d1):.2f} / {statistics.median(d0):.2f}; "
              f"save → restore(shardings=) "
              f"{'equal' if round_trip else 'DIFFERS'}")
        bad.check(same_train, "world-1 mesh training differs from the plain")
        bad.check(same_decode, "world-1 mesh decode differs from the plain")
        bad.check(round_trip, "world-1 save → restore(shardings=) differs")
        return {"train_ms": ms1[-1], "train_ms_plain": ms0[-1],
                "decode_ms": statistics.median(d1),
                "decode_ms_plain": statistics.median(d0),
                "losses": l1, "equal": same_train and same_decode}
    finally:
        dist.destroy_process_group()


def _lmm_multi(torch, np, full, dev, n, workdir, bad) -> dict:
    """``n`` ranks on ``(n/2, 2)`` against one device without a mesh."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    base = _lmm_baseline(torch, np, full, dev, LMM_NEW)
    if dev == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_ranks(_lmm_rank, n, full, dev, str(workdir / "ckpt"),
                      device=dev, workdir=workdir / "ranks")
    t2 = time.perf_counter()
    r0 = ranks[0]
    out = {"ranks": n, "mesh": [n // 2, 2], "baseline_s": t1 - t0,
           "ranks_s": t2 - t1}
    b, s = base["bf16"], r0["bf16"]
    gap = abs(b["losses"][-1] - s["losses"][-1])
    frac = float((b["leaf"] - s["leaf"]).abs().lt(LMM_LEAF_TOL).float()
                 .mean())
    agree = float((b["tokens"] == s["tokens"]).float().mean())
    bad.check(gap < LMM_LOSS_TOL, f"sharded bf16 loss {s['losses']} vs "
              f"one device {b['losses']}")
    bad.check(frac >= LMM_LEAF_FRAC, f"first leaf within {LMM_LEAF_TOL}: "
              f"{frac:.4f} < {LMM_LEAF_FRAC}")
    fb, fs, fw = base["f32"], r0["f32"], base["f32_witness"]

    def loss_rel(got):
        return [abs(x - y) / abs(x) for x, y in zip(fb["losses"], got)]

    def logit_gap(got, k):
        want = fb["logits"][:k]
        return float((want - got[:k]).abs().max() / want.abs().max())

    # The first loss is a forward pass on equal weights: gated at 1e-4.
    # Later steps and the logits are gated against the chaos witness:
    # the one-card run itself, with its embedding scaled by 1 + 1e-7,
    # moves by as much as a change of summation order does (the seed's
    # init makes the stack chaotic: PERF.md §6).
    rels, wit = loss_rel(fs["losses"]), loss_rel(fw["losses"])
    rel = max(rels)
    k = LMM_GATED_STEPS + 1
    lg, lg_wit = logit_gap(fs["logits"], k), logit_gap(fw["logits"], k)
    lg_all = logit_gap(fs["logits"], LMM_NEW)
    f32_tokens = float((fb["tokens"] == fs["tokens"]).float().mean())
    bad.check(rels[0] < LMM_F32_TOL, f"sharded float32 first loss "
              f"{fs['losses'][0]} vs {fb['losses'][0]} (rel {rels[0]:.2e})")
    bad.check(rel <= max(LMM_F32_TOL, LMM_WITNESS_FACTOR * max(wit)),
              f"sharded float32 losses {fs['losses']} vs {fb['losses']} "
              f"(rel {rel:.2e}; the witness moves {max(wit):.2e})")
    bad.check(lg <= max(LMM_F32_TOL, LMM_WITNESS_FACTOR * lg_wit),
              f"sharded float32 decode logits {lg:.2e} of max|·| over the "
              f"prefill and {LMM_GATED_STEPS} steps (the witness moves "
              f"{lg_wit:.2e})")
    tall_rel = abs(r0["tall"]["loss"] - fb["losses"][0]) / abs(
        fb["losses"][0])
    bad.check(tall_rel < LMM_F32_TOL, f"(1, {n}) float32 loss "
              f"{r0['tall']['loss']} vs {fb['losses'][0]}")
    bad.check(r0["elastic"]["equal"] and r0["elastic"]["placed"],
              f"elastic restore ({n}, 1) → ({n // 2}, 2): {r0['elastic']}")
    launched = [r["launched"] for r in ranks if r["launched"]]
    bad.check(not launched, f"the LM mesh ranks launched kernels: "
              f"{launched}")
    # The KV cache (layers, batch, seq, kv heads, head dim) must be split
    # on its sequence (dim 2) over 'model' ((n/2, 2): the second mesh
    # dim), so that every decode step above attends it where it lies and
    # combines the ranks' softmax partials over NCCL.
    seq_split = {t: r0[t]["cache_placements"] for t in ("bf16", "f32")}
    bad.check(all(p == "(Shard(dim=1), Shard(dim=2))"
                  for p in seq_split.values()),
              f"the decode cache is not split on its sequence over "
              f"'model': {seq_split}")
    out.update({
        "bf16": {"loss_one": b["losses"], "loss_sharded": s["losses"],
                 "loss_gap": gap, "leaf_frac_within": frac,
                 "greedy_token_agreement": agree,
                 "train_ms_one": b["train_ms"][-1],
                 "train_ms_sharded": s["train_ms"][-1],
                 "decode_ms_one": statistics.median(b["decode_ms"]),
                 "decode_ms_sharded": statistics.median(s["decode_ms"]),
                 "train_collectives": s["train_comm"],
                 "decode_collectives": s["decode_comm"],
                 "decode_cache_placements": s["cache_placements"],
                 "peak_gb_rank": [r["bf16"]["train_peak_gb"]
                                  for r in ranks],
                 "peak_gb_one": base["peak_gb"]},
        "f32": {"layers": LMM_F32_LAYERS, "loss_one": fb["losses"],
                "loss_sharded": fs["losses"], "loss_rel": rel,
                "loss_rel_by_step": rels, "witness_loss_rel_by_step": wit,
                "logits_rel": lg, "witness_logits_rel": lg_wit,
                "logits_rel_all_steps": lg_all,
                "greedy_token_agreement": f32_tokens,
                "train_collectives": fs["train_comm"]},
        "elastic": r0["elastic"],
        "tall": {**r0["tall"], "loss_rel": tall_rel}})
    print(f"[lm-mesh] {n} ranks on ({n // 2}, 2), {LMM_ARCH} "
          f"{'full width' if full else 'smoke'}: bf16 loss {s['losses']} "
          f"vs one device {b['losses']} (gap {gap:.4f}), first leaf "
          f"{frac:.4f} within {LMM_LEAF_TOL}, greedy tokens {agree:.3f} "
          f"equal; float32 × {LMM_F32_LAYERS} layers loss rel "
          f"{rel:.2e} (witness {max(wit):.2e}), decode logits {lg:.2e} of "
          f"max|·| (witness {lg_wit:.2e}; prefill + "
          f"{LMM_GATED_STEPS} steps; {lg_all:.2e} over {LMM_NEW}, tokens "
          f"{f32_tokens:.3f} equal); ms per train step "
          f"{s['train_ms'][-1]:.1f} sharded / {b['train_ms'][-1]:.1f} one "
          f"device, per decode step "
          f"{statistics.median(s['decode_ms']):.2f} / "
          f"{statistics.median(b['decode_ms']):.2f}; collectives per "
          f"train step {s['train_comm']}, per decode step "
          f"{s['decode_comm']}; the decode cache placed "
          f"{s['cache_placements']} (batch over 'data', sequence over "
          f"'model': each step attends it where it lies); peak GiB per rank "
          f"{[round(r['bf16']['train_peak_gb'], 2) for r in ranks]} "
          f"(one device {base['peak_gb']:.2f}); elastic {r0['elastic']}; "
          f"(1, {n}) heads {r0['tall']['heads_spec']} kv "
          f"{r0['tall']['kv_spec']}, loss rel {tall_rel:.2e}")
    return out


def lm_mesh_phase(torch, np, card, dev: str = "cuda", full: bool = True,
                  ranks: int | None = None) -> dict:
    """Phase 13: the LM mesh (DTensor on a DeviceMesh).  One device: a
    world-1 mesh bit for bit against no mesh.  With ≥ 2 (``ranks``, by
    default min(cards, LMM_MAX_RANKS)): the sharded runs against one
    device."""
    import tempfile
    bad = Failures("LM mesh phase")
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    n = ranks if ranks is not None else min(torch.cuda.device_count(),
                                            LMM_MAX_RANKS)
    with tempfile.TemporaryDirectory(prefix="lm_mesh_") as tmp:
        tmp = pathlib.Path(tmp)
        one = _lmm_world1(torch, np, full, dev, tmp, bad)
        multi = None
        if n >= 2:
            multi = _lmm_multi(torch, np, full, dev, n - n % 2, tmp, bad)
        else:
            print(f"[lm-mesh] {card}: the multi-rank half needs ≥ 2 cards "
                  f"(NCCL refuses two ranks on one card); this machine has "
                  f"{torch.cuda.device_count() if dev == 'cuda' else 0}")
    launched = {k: v for k, v in read_launches(wrappers).items() if v}
    bad.check(not launched, f"the LM mesh path launched kernels: {launched}")
    secs = time.perf_counter() - t0
    print(f"[lm-mesh] phase {secs:.1f} s; kernel launches on the LM mesh "
          f"path: 0")
    print("[lm-mesh] " + json.dumps({"card": card, "world1": one,
                                     "multi": multi}))
    bad.raise_any()
    return {"seconds": secs, "world1": one, "multi": multi,
            "launches": read_launches(wrappers)}


# Phase 14: the LM dry-run, held against the reference's.  One full-size
# cell per family, each on both production meshes, in a process of its
# own (all started together); each record beside the reference's record
# of the same cell, committed from the unchanged JAX package's own
# dry-run (`python -m repro.launch.dryrun --all --mesh both`, read here as
# plain JSON).
DRYRUN_CELLS = (("qwen3-32b", "decode_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
                ("mamba2-370m", "long_500k"), ("zamba2-2.7b", "prefill_32k"),
                ("seamless-m4t-large-v2", "decode_32k"))
DRYRUN_TIMEOUT_S = 600
DRYRUN_REFERENCE = "tests/fixtures/reference_dryrun.json"
# Collective bytes (GB) of each record as the port moved them before it
# attended the split KV cache where it lies and kept Mamba2's projection
# split (PERF.md §6: the card's records, torch 2.11.0+cu128, collective
# seconds × chips × 50 GB/s): no record may rise above the larger of its
# figure here and 2× the reference's.
DRYRUN_BEFORE_GB = {
    "qwen3-32b|decode_32k": (1102.08, 550.4),
    "qwen2-moe-a2.7b|decode_32k": (839.68, 422.4),
    "mamba2-370m|long_500k": (0.034944, 0.035072),
    "zamba2-2.7b|prefill_32k": (23936.0, 2088.96),
    "seamless-m4t-large-v2|decode_32k": (207.36, 103.936)}
DRYRUN_BYTES_X = 2.0           # decode cells: collective bytes ≤ 2× GSPMD's
DRYRUN_ZAMBA_PEAK_GB = {"single": 37.3, "multi": 13.3}   # ¼ of the above
DRYRUN_SPLIT_FNS = ("models/mamba2.py:_split_proj", "models/mamba2.py:_split_xbc")


def dryrun_cell(arch: str, shape: str, out: str) -> int:
    """One phase-14 worker: ``run_cell`` on the card for ``arch`` ×
    ``shape`` on both meshes (with ``--trace-dir``'s collectives by
    computation and the peak's holders), with every kernel wrapper's
    launch count zeroed before and read after; writes {records, traces,
    launches} to ``out``."""
    import tempfile
    import torch
    from repro_torch.launch.dryrun import run_cell
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    recs, traces = [], []
    with tempfile.TemporaryDirectory(prefix="dryrun_trace_") as tmp:
        for mesh in ("single", "multi"):
            recs.append(run_cell(arch, shape, mesh, tmp, device="cuda"))
            cell = pathlib.Path(tmp) / f"{arch}__{shape}__{mesh}"
            traces.append({
                "calls": json.loads(pathlib.Path(f"{cell}.json").read_text()),
                "peak": json.loads(pathlib.Path(f"{cell}.peak.json")
                                   .read_text())})
    pathlib.Path(out).write_text(json.dumps(
        {"records": recs, "traces": traces,
         "launches": read_launches(wrappers), "torch": torch.__version__}))
    return 0


def _dryrun_against_reference(rec, trace, ref, bad) -> dict:
    """One record beside the reference's record of its cell: peak GB per
    rank and collective GB, with their ratios, and the gates."""
    cell = f"{rec['arch']}|{rec['shape']}"
    key = f"{cell}|{rec['mesh']}"
    r = ref.get(key)
    bad.check(r is not None and r.get("status") == "ok",
              f"{key}: no ok record in {DRYRUN_REFERENCE}")
    if r is None:
        return {}
    multi = rec["mesh"] == "multi"
    peak, ref_peak = (rec["memory"]["per_device_total_gb"],
                      r["memory"]["per_device_total_gb"])
    coll, ref_coll = (rec["collectives"]["total_bytes"] / 1e9,
                      r["collectives"]["total_bytes"] / 1e9)
    before = DRYRUN_BEFORE_GB[cell][multi]
    limit = max(before, DRYRUN_BYTES_X * ref_coll)
    bad.check(coll <= limit, f"{key}: {coll:.4g} GB of collectives, above "
              f"max(before {before:.4g}, {DRYRUN_BYTES_X:g}× the "
              f"reference's {ref_coll:.4g}) GB")
    if rec["shape"] == "decode_32k" and rec["arch"] != "mamba2-370m":
        bad.check(coll <= DRYRUN_BYTES_X * ref_coll,
                  f"{key}: {coll:.4g} GB of collectives, above "
                  f"{DRYRUN_BYTES_X:g}× the reference's {ref_coll:.4g} GB")
    gathers = [c for c in trace["calls"] if c["kind"] == "all-gather"
               and c["computation"].endswith(DRYRUN_SPLIT_FNS)]
    if cell == "zamba2-2.7b|prefill_32k":
        cap = DRYRUN_ZAMBA_PEAK_GB[rec["mesh"]]
        bad.check(rec["memory"]["fits_hbm"] and peak <= cap,
                  f"{key}: peak {peak:.2f} GB a rank (≤ {cap} GB, fits "
                  f"{rec['memory']['fits_hbm']})")
        bad.check(not gathers, f"{key}: all-gathers splitting the Mamba2 "
                  f"projection: {gathers}")
    holder = trace["peak"]["largest"][0] if trace["peak"]["largest"] else {}
    print(f"[dryrun] against the reference | {key}: peak GB/rank "
          f"{peak:.3f} vs {ref_peak:.3f} ({peak / ref_peak:.2f}×); "
          f"collective GB {coll:.4g} vs {ref_coll:.4g} "
          f"({coll / ref_coll:.3g}×; before {before:.4g}); peak at "
          f"{trace['peak']['computation']}, largest {holder.get('bytes')} B "
          f"{holder.get('shape')} from {holder.get('computation')}")
    return {"cell": key, "peak_gb": peak, "ref_peak_gb": ref_peak,
            "coll_gb": coll, "ref_coll_gb": ref_coll, "before_gb": before,
            "peak_at": trace["peak"]["computation"]}


def dryrun_phase(torch, card) -> dict:
    """Phase 14: the LM dry-run (``repro_torch.launch.dryrun``) on the card:
    the fake-tensor trace of each DRYRUN_CELLS cell's sharded step on the
    256- and 512-rank production meshes.  Every record must end ``ok`` with
    its fields filled, no kernel launches (fake tensors run nothing), and
    each is held against the reference's record of its cell
    (DRYRUN_REFERENCE): collective bytes and peak per rank side by side,
    the decode cells at most DRYRUN_BYTES_X× the reference's bytes, no
    record above its bytes before this check existed or that bound, and
    zamba2-2.7b's prefill within a quarter of its earlier peak, without
    gathering its Mamba2 projection to split it."""
    import tempfile
    bad = Failures("dry-run phase")
    t0 = time.perf_counter()
    ref = json.loads((ROOT / DRYRUN_REFERENCE).read_text())
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = []
        for arch, shape in DRYRUN_CELLS:
            out = pathlib.Path(tmp) / f"{arch}__{shape}.json"
            log = open(pathlib.Path(tmp) / f"{arch}__{shape}.log", "w")
            procs.append((arch, shape, out, log, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-cell",
                 arch, shape, str(out)], stdout=log, stderr=subprocess.STDOUT)))
        try:
            for arch, shape, out, log, proc in procs:
                rc = proc.wait(timeout=max(
                    1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
                log.close()
                if rc:
                    tail = pathlib.Path(log.name).read_text()[-3000:]
                    fail(f"dry-run of {arch} {shape} exited {rc}:\n{tail}")
        finally:
            for *_, log, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        results = [json.loads(out.read_text()) for *_, out, _, _ in procs]
    launches, compared = {}, []
    for res in results:
        for name, n in res["launches"].items():
            launches[name] = launches.get(name, 0) + n
        for rec, trace in zip(res["records"], res["traces"]):
            key = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
            mem, roof = rec["memory"], rec["roofline"]
            bad.check(rec["status"] == "ok", f"{key}: {rec['status']}")
            bad.check(rec["chips"] == (512 if rec["mesh"] == "multi"
                                       else 256), f"{key}: {rec['chips']}")
            bad.check(mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0,
                      f"{key}: memory {mem}")
            bad.check(rec["cost_analysis_flops"] > 0
                      and rec["collectives"]["count"] > 0,
                      f"{key}: no FLOPs or no collectives recorded")
            print(f"[dryrun] {card} | {key} ok micro={rec['microbatches']} "
                  f"GB/dev={mem['per_device_total_gb']:.2f} "
                  f"fits={mem['fits_hbm']} "
                  f"flops/dev={rec['cost_analysis_flops']:.4g} "
                  f"hlo_flops/chips={rec['hlo_flops'] / rec['chips']:.4g} "
                  f"calls={json.dumps(rec['collective_calls'])} "
                  f"compute={roof['compute_s']:.4g}s "
                  f"memory={roof['memory_s']:.4g}s "
                  f"coll={roof['collective_s']:.4g}s "
                  f"dominant={roof['dominant']} trace={rec['compile_s']}s")
            compared.append(_dryrun_against_reference(rec, trace, ref, bad))
    launched = {k: v for k, v in launches.items() if v}
    bad.check(not launched, f"the dry-run launched kernels: {launched}")
    secs = time.perf_counter() - t0
    print(f"[dryrun] phase {secs:.1f} s ({len(DRYRUN_CELLS)} processes, "
          f"torch {results[0]['torch']}); kernel launches: 0; "
          f"{len(compared)} records held against {DRYRUN_REFERENCE}")
    bad.raise_any()
    return {"seconds": secs, "launches": launches, "compared": compared,
            "records": [r for res in results for r in res["records"]]}


def dryrun_table(records: str, trace_dir: str | None = None) -> int:
    """Print every record of a dry-run campaign (``python -m
    repro_torch.launch.dryrun --all --mesh both --out RECORDS``) beside
    the reference's record of its cell (DRYRUN_REFERENCE), one markdown
    row per cell, single ; multi: microbatches, peak GB a rank, collective
    GB and their ratios to the reference's.  A record above 2× the
    reference's collective bytes or 4× its peak names its holder from
    the campaign's ``--trace-dir``: the function at the peak with the
    largest storage live then, or the function that moved the most
    collective bytes."""
    port = json.loads(pathlib.Path(records).read_text())
    ref = json.loads((ROOT / DRYRUN_REFERENCE).read_text())
    print("| Cell | µb | peak GB/rank | × ref | collective GB | × ref | "
          "holder |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    cells = sorted({k.rsplit("|", 1)[0] for k in ref})
    n_ok = 0
    for cell in cells:
        cols = {c: [] for c in ("mb", "peak", "xp", "coll", "xc")}
        holders = []
        for mesh in ("single", "multi"):
            p, r = port.get(f"{cell}|{mesh}"), ref[f"{cell}|{mesh}"]
            if p is None or p.get("status") != "ok":
                for v in cols.values():
                    v.append("—")
                holders.append(f"{mesh}: {p and p.get('error')}")
                continue
            n_ok += 1
            pk, rk = (p["memory"]["per_device_total_gb"],
                      r["memory"]["per_device_total_gb"])
            pc, rc = (p["collectives"]["total_bytes"] / 1e9,
                      r["collectives"]["total_bytes"] / 1e9)
            cols["mb"].append(f"{p['microbatches']} ({r['microbatches']})")
            cols["peak"].append(f"{pk:.2f} ({rk:.2f})")
            cols["xp"].append(f"{pk / rk:.2f}")
            cols["coll"].append(f"{pc:.4g} ({rc:.4g})")
            cols["xc"].append(f"{pc / rc:.3g}")
            if trace_dir and (pc > 2 * rc or pk > 4 * rk):
                stem = pathlib.Path(trace_dir) / (
                    cell.replace("|", "__") + f"__{mesh}")
                if pk > 4 * rk:
                    pj = json.loads(pathlib.Path(f"{stem}.peak.json")
                                    .read_text())
                    big = pj["largest"][0]
                    holders.append(
                        f"{mesh} peak: at {pj['computation']}, largest "
                        f"{big['bytes'] / 1e9:.2f} GB {big['shape']} from "
                        f"{big['computation']}")
                if pc > 2 * rc:
                    by: dict = {}
                    for c in json.loads(pathlib.Path(f"{stem}.json")
                                        .read_text()):
                        k = f"{c['kind']} in {c['computation']}"
                        by[k] = by.get(k, 0) + (
                            (2 if c["kind"] == "all-reduce" else 1)
                            * c["bytes_per_device"] * c["participants"]
                            * c["calls"])
                    top = max(by, key=by.get)
                    holders.append(f"{mesh} bytes: {top} "
                                   f"({by[top] / 1e9:.4g} GB)")
        print(f"| {cell.replace('|', ' ')} | " + " | ".join(
            " ; ".join(cols[c]) for c in cols) + " | "
            + "; ".join(holders) + " |")
    print(f"{n_ok} / {len(ref)} records ok, held against "
          f"{DRYRUN_REFERENCE}")
    return 0 if n_ok == len(ref) else 1


def bits_view(torch, t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the always-on serving steps")
    ap.add_argument("--lm-mesh-only", action="store_true",
                    help="run only phase 13, the LM mesh (no kernel build; "
                         "no final line)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run only phase 14, the LM dry-run (no kernel "
                         "build; no final line)")
    ap.add_argument("--dryrun-cell", nargs=3,
                    metavar=("ARCH", "SHAPE", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-table", nargs="+",
                    metavar=("RECORDS", "TRACE_DIR"),
                    help="print a dry-run campaign's records beside the "
                         "reference's (no card needed) and exit")
    args = ap.parse_args()
    if args.dryrun_cell:
        return dryrun_cell(*args.dryrun_cell)
    if args.dryrun_table:
        return dryrun_table(*args.dryrun_table[:2])
    # No autotune cache of the machine may change a phase's launches: the
    # run keeps its own, removed at exit.
    import atexit
    import os
    import shutil
    import tempfile
    tune_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    atexit.register(shutil.rmtree, tune_dir, ignore_errors=True)
    tune_cache = tune_dir / "autotune.json"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(tune_cache)
    os.environ.pop("REPRO_AUTOTUNE", None)
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
    if args.lm_mesh_only:
        lm_mesh_phase(torch, np, card)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.dryrun_only:
        dryrun_phase(torch, card)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    build_kernels()

    x, fex, params = make_inputs(torch, np)
    fex_res = compare_fex(torch, x, fex)
    compare_fex(torch, keyword_audio(torch, np, ALWAYS_ON_SLOTS, 2), fex)
    compare_fex_edges(torch, np, fex)
    gru_res = compare_gru(torch, fex_res["feats"], params)
    compare_gru_edges(torch, np, gru_res)
    bundle = promote(params, fex)
    fex_int_res = compare_fex_int(torch, x, bundle)
    compare_fex_int_tails(torch, np, bundle)
    gru_int_res = compare_gru_int(torch, fex_int_res["feats"], bundle)
    compare_gru_int_edges(torch, np, fex_int_res["feats"], bundle)
    compare_nan_semantics(torch, np, gru_res, bundle)
    times = time_kernels(torch, x, fex, gru_res, fex_res["plain_ms"])
    times.update(time_int_kernels(torch, x, gru_int_res, bundle,
                                  fex_int_res["plain_ms"]))
    wide_shapes = ((ALWAYS_ON_SLOTS, 10, 3 * WIDE_H, 10, 128),
                   (ALWAYS_ON_SLOTS, WIDE_H, 3 * WIDE_H, 128, 128))
    mv_res = compare_delta_matvec(torch, wide_shapes)
    cell_res = compare_cell(torch, gru_res)
    compare_blocked(torch, gru_res)
    times.update(time_block_sparse(torch, gru_res))
    launches = serve_main_path(torch, "float32")
    launches.update(serve_main_path(torch, "int8"))
    launches.update(serve_wide(torch, np))
    check_against_cpu(torch, np, params)
    check_int8_against_cpu(torch, np, params)
    head_res = compare_detect_head(torch, np)
    times["detect_head"] = time_detect_head(torch)
    head_launches = {}
    for numerics in ("float32", "int8"):
        head_launches[numerics] = serve_detect(torch, numerics)
        check_detect_against_cpu(torch, np, params, numerics)
    masked_err = compare_masked(torch, np, gru_res, fex_int_res["feats"],
                                bundle)
    time_masked_duties(torch, gru_res, fex_int_res["feats"], bundle)
    compare_wake_head(torch, np)
    times["wake_head"] = time_wake_head(torch)
    cascade_launches = {}
    for numerics in ("float32", "int8"):
        cascade_launches.update(serve_cascade(torch, numerics))
        check_cascade_against_cpu(torch, np, params, numerics)
    cascade_res = {}
    for numerics in ("float32", "int8"):
        step_s = always_on(torch, np, params, card, args.profile, numerics)
        det_res = detect_always_on(torch, np, params, card, args.profile,
                                   numerics, step_s)
        cascade_res[numerics] = cascade_always_on(
            torch, np, params, card, args.profile, numerics,
            det_res["step_ms"])
    for numerics in ("float32", "int8"):
        event_driven_on_card(torch, np, params, numerics)
    fault_res = faults_phase(torch, np, params, card, args.profile)
    fault_launches = fault_res["serve_launches"]
    train_res = training_phase(torch, np)
    tune_res = tuning_phase(torch, np, fex, params, bundle, card, tune_cache)
    lm_phase(torch, np, card)
    mesh_res = mesh_phase(torch, np, params, card, args.profile)
    lm_mesh_launch = lm_mesh_phase(torch, np, card)["launches"]
    dryrun_launch = dryrun_phase(torch, card)["launches"]
    mesh_launch = {}
    for (kind, numerics), counts in mesh_res["launches"].items():
        for name, v in counts.items():
            mesh_launch.setdefault(name, v)

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
        ms, bnd, by, call = times[(kind, SLOTS)]
        numerics = "int8" if kind.endswith("int") else "float32"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_slot_mesh": mesh_launch[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": times[(kind + "_plain", SLOTS)], "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "call_ms": call,
            "ms_b256": times[(kind, ALWAYS_ON_SLOTS)][0],
            "bound_ms_b256": times[(kind, ALWAYS_ON_SLOTS)][1],
            "launches_faults_run": fault_launches.get(
                ("kws-audio", numerics), {}).get(name),
            "launches_train_run": train_res["launches"][name],
            "autotune": tune_res[name],
            "shape": (f"B={SLOTS} S={CHUNK} C={C}" if kind.startswith("fex")
                      else f"T=32 B={SLOTS} I={C} H={H}")})
        if kind + "_chain" in times:
            cycles, chain_ms, *rows = times[kind + "_chain"]
            unit = "frame" if kind.startswith("gru") else "sample"
            kernels[-1].update({
                "chain_bound_ms": chain_ms,
                f"chain_cycles_per_{unit}": cycles})
            if rows:
                kernels[-1].update({
                    "chain_rows_per_frame": list(rows[0]),
                    "chain_bound_ms_every_row":
                        times[kind + "_chain_every_row"][1]})
    ms, plain, lib, bnd, by, call, fmul = times[("matvec", WIDE_H)]
    ms10, plain10, lib10, bnd10, by10, _, _ = times[("matvec", 10)]
    kernels.append({
        "name": "delta_matvec", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_matvec.cu",
        "replaces": "src/repro/kernels/delta_matvec.py:49",
        "launches": launches["delta_matvec"], "launches_slot_mesh": 0,
        "max_abs_err": mv_res["max_abs_err"], "ms": ms, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": lib, "call_ms": call,
        "shape": f"B={ALWAYS_ON_SLOTS} I={WIDE_H} O={3 * WIDE_H} "
                 f"block_i=128",
        "path": f"the ΔGRU's block-sparse path, H={WIDE_H} serve run",
        "ms_i10": ms10, "plain_ms_i10": plain10, "library_ms_i10": lib10,
        "bound_ms_i10": bnd10, "bound_by_i10": by10,
        "fmul_fadd_bound_ms": fmul})
    ms, plain, _, bnd, by, call, _, empty, trip = times[("cell", SLOTS)]
    kernels.append({
        "name": "delta_gru_cell", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_gru_cell.cu",
        "replaces": "src/repro/kernels/delta_gru_cell.py:46",
        "launches": 0, "launches_slot_mesh": 0,
        "max_abs_err": cell_res["max_abs_err"], "ms": ms,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "call_ms": call,
        "shape": f"B={SLOTS} I={C} H={H}",
        "path": "none: the reference runs it only in tests and benchmarks",
        "ms_b256": times[("cell", ALWAYS_ON_SLOTS)][0],
        "plain_ms_b256": times[("cell", ALWAYS_ON_SLOTS)][1],
        "bound_ms_b256": times[("cell", ALWAYS_ON_SLOTS)][3],
        "launch_floor_empty_ms": empty, "launch_floor_ms": trip,
        "launch_floor_ms_b256": times[("cell", ALWAYS_ON_SLOTS)][8]})
    hd, hd256 = times["detect_head"][SLOTS], times["detect_head"][ALWAYS_ON_SLOTS]
    kernels.append({
        "name": "detect_head", "route": "cuda",
        "source": "src/repro_torch/csrc/detect_head.cu",
        "replaces": "src/repro/models/detector.py:162",
        "note": "no Pallas counterpart: the XLA-fused plain JAX head "
                "(jax.nn.softmax, src/repro/launch/streaming.py:587, then "
                "detector_scan)",
        "launches": head_launches["float32"],
        "launches_slot_mesh": mesh_launch["detect_head"],
        "launches_int8_run": head_launches["int8"],
        "launches_faults_run": fault_launches.get(
            ("kws-detect", "float32"), {}).get("detect_head"),
        "max_abs_err": head_res["max_abs_err"], "ms": hd["ms"],
        "plain_ms": hd["plain"], "bound_ms": hd["bound"],
        "bound_by": hd["by"], "library_ms": None, "call_ms": hd["call"],
        "shape": f"F=32 B={SLOTS} K=12",
        "path": "kws-detect, one launch per step",
        "ms_f1": hd["ms_f1"], "launch_floor_ms": hd["floor"],
        "ms_b256": hd256["ms"], "plain_ms_b256": hd256["plain"],
        "bound_ms_b256": hd256["bound"],
        "launch_floor_ms_b256": hd256["floor"]})
    for numerics, base, source, replaces, err in (
            ("float32", "delta_gru_seq", "src/repro_torch/csrc/delta_gru_seq.cu",
             "src/repro/core/delta_gru.py:376", masked_err),
            ("int8", "delta_gru_seq_int",
             "src/repro_torch/csrc/delta_gru_seq_int.cu",
             "src/repro/core/fixed_point.py:476", 0.0)):
        r = cascade_res[numerics]
        kind = "gru_int" if numerics == "int8" else "gru"
        cycles, chain_ms, _ = times[kind + "_chain"]
        kernels.append({
            "name": f"{base} (masked)", "route": "cuda", "source": source,
            "replaces": replaces,
            "note": "no Pallas counterpart: the masked instantiation "
                    "(template argument kMasked) of the kernel above, the "
                    "port of the XLA-fused plain JAX masked scan",
            "launches": cascade_launches[f"{base} (masked)"],
            "launches_slot_mesh": mesh_launch[f"{base} (masked)"],
            "launches_faults_run": fault_launches.get(
                ("kws-cascade", numerics), {}).get(f"{base} (masked)"),
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"],
            "path": f"kws-cascade {numerics}, stage 1, one launch per step",
            "duty": r["step_duty"], "ms_awake_everywhere": r["ms_awake"],
            "ms_unmasked_same_inputs": r["ms_unmasked"],
            "chain_bound_ms_at_duty": chain_ms * r["busiest_awake"] / 32})
    wk, wk256 = times["wake_head"][SLOTS], times["wake_head"][ALWAYS_ON_SLOTS]
    kernels.append({
        "name": "wake_head", "route": "cuda",
        "source": "src/repro_torch/csrc/wake_head.cu",
        "replaces": "src/repro/launch/streaming.py:197",
        "note": "no Pallas counterpart: the XLA-fused plain JAX stage-0 "
                "posterior (jax.nn.softmax(...)[..., 1], "
                "src/repro/launch/streaming.py:712) and cascade_wake_scan",
        "launches": cascade_launches["wake_head"],
        "launches_slot_mesh": mesh_launch["wake_head"],
        "launches_faults_run": fault_launches.get(
            ("kws-cascade", "float32"), {}).get("wake_head"),
        "max_abs_err": 0.0, "ms": wk["ms"], "plain_ms": wk["plain"],
        "bound_ms": wk["bound"], "bound_by": wk["by"], "library_ms": None,
        "call_ms": wk["call"], "shape": f"F=32 B={SLOTS} K=2",
        "path": "kws-cascade, one launch per step",
        "launch_floor_ms": wk["floor"], "ms_b256": wk256["ms"],
        "plain_ms_b256": wk256["plain"], "bound_ms_b256": wk256["bound"],
        "launch_floor_ms_b256": wk256["floor"]})
    for k in kernels:
        k["launches_lm_mesh"] = lm_mesh_launch[k["name"]]
        k["launches_dryrun"] = dryrun_launch[k["name"]]
    if len(kernels) != 10:
        fail(f"the kernels line lists {len(kernels)} kernels, not 10")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
