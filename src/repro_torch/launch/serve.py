"""Serve CLI of the port: ``python -m repro_torch.launch.serve --mode kws-audio``.

Continuous batching of synthesized 1 s utterances over ``--slots`` stream
slots: each step runs one ``--chunk-samples`` chunk per slot through the
FEx and ΔGRU kernels, finished utterances are decided by majority vote
and their slots re-admitted.  Weights come from ``--params`` (a
checkpoint's ``arrays.npz``, as the JAX package writes it) or, without
it, from the seeded ``models.kws.init_kws``.  Runs on ``--device``
(default ``cuda``; raises without a GPU).

``--numerics int8`` serves the deployed integer datapath (integer FEx →
int8-weight ΔGRU → integer FC, one launch of each integer kernel per
step): the float weights are promoted into the integer bundle at session
creation, or ``--bundle X.npz`` serves a promoted bundle as
``train.promote.save_bundle`` writes it (one the JAX package wrote loads
unchanged) and implies ``--numerics int8``.

Training, ``--devices``, the admission controller, faults and the
pipelined engine are later slices of the port.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["kws-audio"], default="kws-audio")
    ap.add_argument("--slots", type=int, default=4,
                    help="stream slots served together")
    ap.add_argument("--requests", type=int, default=8,
                    help="1 s utterances to serve")
    ap.add_argument("--chunk-samples", type=int, default=4096,
                    help="raw samples per serve step (keep it a multiple "
                         "of the 128-sample frame shift so slot resets "
                         "stay frame-aligned)")
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="delta threshold Δ_TH")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    ap.add_argument("--params", default="",
                    help="arrays.npz of a KWS checkpoint (default: random "
                         "weights from --seed)")
    ap.add_argument("--numerics", choices=["float32", "int8"],
                    default="float32",
                    help="serving datapath: the float kernels or the "
                         "bit-true integer pipeline (weights promoted at "
                         "session creation)")
    ap.add_argument("--bundle", default="",
                    help="a promoted int8 bundle (.npz of "
                         "train.promote.save_bundle, or of the JAX "
                         "package's); implies --numerics int8")
    return ap


def validate_args(args):
    """Reject nonsensical flags with a clear ``ValueError``."""
    for name in ("slots", "chunk_samples"):
        if getattr(args, name) < 1:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 1, "
                             f"got {getattr(args, name)}")
    if args.requests < 0:
        raise ValueError(f"--requests must be >= 0, got {args.requests}")
    if not math.isfinite(args.threshold) or args.threshold < 0:
        raise ValueError(f"--threshold must be finite and >= 0, "
                         f"got {args.threshold}")


def serve_kws_audio(args):
    """Build the model and session and serve ``args.requests`` utterances.

    Returns ``(sess, done, labels, stats, seconds)``: the session (for
    its ``summary()``), the [(request, predicted class)] list, the
    requests' true labels, the loop's stats and the wall seconds of the
    serve loop (warm-up included).
    """
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import T as UTT_SAMPLES
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.launch.engine import run_audio_requests
    from repro_torch.launch.streaming import SlotScheduler, StreamingKwsSession
    from repro_torch.models import kws

    device = resolve_device(args.device)
    fex = FeatureExtractor()
    bundle = params = None
    if args.bundle:
        from repro_torch.train.promote import load_bundle
        args.numerics = "int8"                  # a bundle IS int8 weights
        bundle = load_bundle(args.bundle)
    elif args.params:
        params = kws.load_npz_params(args.params, device)
    else:
        gen = torch.Generator().manual_seed(args.seed)
        params = kws.init_kws(gen, CONFIG, input_dim=fex.cfg.n_active)
    audio_q, label_q = synth_batch(np.random.default_rng(args.seed + 1),
                                   args.requests)
    sess = StreamingKwsSession(params, CONFIG, threshold=args.threshold,
                               batch=args.slots, fex=fex, device=device,
                               numerics=args.numerics, bundle=bundle)
    sched = SlotScheduler(sess)
    for req in range(args.requests):
        sched.submit(req)
    chunk = args.chunk_samples
    t0 = time.perf_counter()
    done, stats = run_audio_requests(
        sess, sched, None, audio_q=audio_q, chunk=chunk,
        chunks_per_utt=-(-UTT_SAMPLES // chunk),
        real_frames=UTT_SAMPLES // fex.cfg.frame_shift)
    return sess, done, label_q, stats, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        validate_args(args)
    except ValueError as e:
        ap.error(str(e))
    sess, done, labels, stats, dt = serve_kws_audio(args)
    dev = sess.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain PyTorch versions of the kernels)")
    correct = sum(1 for req, pred in done if pred == int(labels[req]))
    summ = sess.summary()
    slo = stats["slo"]
    audio_s = len(done) * 1.0
    steady_s = max(slo["steady_state_s"], 1e-9)
    print(f"served {len(done)} utterances ({audio_s:.0f} s audio) on "
          f"{args.slots} slots in {dt:.2f} s end-to-end (warm-up "
          f"{stats['warmup_s']:.2f} s) on {name} [{sess.numerics}, Δ_TH "
          f"{sess.threshold}]: "
          f"{correct}/{len(done)} correct")
    print(f"steady-state: {audio_s / steady_s:.1f}x realtime, "
          f"{stats['frames_served'] / steady_s:.0f} decisions/s, step "
          f"latency p50 {slo['step_ms']['p50']:.2f} / p99 "
          f"{slo['step_ms']['p99']:.2f} ms ({stats['steps']} steps)")
    print(f"stream sparsity {summ.sparsity:.3f}, "
          f"{summ.energy_nj_per_decision:.1f} nJ/decision modeled "
          f"(FEx {summ.fex_energy_nj_per_decision:.1f} nJ), "
          f"{len(sess.unhealthy_slots())} unhealthy slots"
          + (", counters overflowed" if summ.overflowed else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
