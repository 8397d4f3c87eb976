"""Serving example of the PyTorch/CUDA port: always-on KWS from RAW AUDIO.

The IC's deployment mode is audio in, decisions out: 8 kHz samples enter
the FEx, one decision leaves per 16 ms frame.  This example mirrors that
end to end with a ``StreamingKwsSession`` on the card: raw audio arrives
in chunks, and each chunk is one FEx kernel launch (``csrc/iir_fex.cu``,
filter and envelope state carried on the device) feeding one ΔGRU kernel
launch (``csrc/delta_gru_seq.cu``) and the FC head, with no host hop
between the stages.  FEx state, ΔGRU state and the op-count telemetry
carry across chunk boundaries on the device; the host fetches each
chunk's votes once and the energy/sparsity summary once at the end.  The
session uses the kernels' tuned launch configurations where the autotune
cache has them (``python -m repro_torch.kernels.autotune``).

The detector is trained first with the port's own training step
(``train.promote.make_kws_step_fn``).  Runs on the GPU unless given
``--device cpu`` (the kernels' plain versions: keep the flags small).

Run with the exact command README.md documents (repro_torch.commands is
the single source of truth for both):

    PYTHONPATH=src python examples/torch_serve_streaming_kws.py
"""
import argparse

import numpy as np
import torch

from repro_torch import commands
from repro_torch.configs.deltakws import CONFIG
from repro_torch.core.energy_model import frame_cost
from repro_torch.data.gscd import (_SPECS, _synth_keyword, _synth_silence,
                                   _synth_unknown, synth_batch)
from repro_torch.frontend import FeatureExtractor
from repro_torch.kernels.platform import resolve_device
from repro_torch.launch.streaming import StreamingKwsSession
from repro_torch.models import kws
from repro_torch.models.kws import CLASSES
from repro_torch.train import optimizer as opt
from repro_torch.train.promote import make_kws_step_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=4000,
                    help="raw samples per chunk (~0.5 s of 8 kHz audio)")
    ap.add_argument("--segments", default="yes,silence,stop,unknown",
                    help="the stream's 1 s segments, in order")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def train_detector(fex, device, steps: int, batch: int) -> dict:
    """QAT-free utterance-level training at Δ_TH 0.1 (AdamW, lr 3e-3)."""
    params = {k: v.to(device) for k, v in kws.init_kws(
        torch.Generator().manual_seed(0), CONFIG,
        input_dim=fex.cfg.n_active).items()}
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=min(20, steps // 4),
                           total_steps=max(steps, 1))
    state = opt.init(params)
    step = make_kws_step_fn(CONFIG, ocfg, 0.1, qat=False)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        audio, labels = synth_batch(rng, batch)
        params, state, m = step(params, state, {
            "feats": fex(torch.from_numpy(audio).to(device)),
            "labels": torch.from_numpy(labels).to(device)})
    if steps:
        print(f"  loss {float(m['loss']):.3f}  acc {float(m['acc']):.3f}")
    return params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    fex = FeatureExtractor()
    print(f"training detector for {args.train_steps} steps ({device}) ...")
    params = train_detector(fex, device, args.train_steps, args.batch)

    rng = np.random.default_rng(5)
    segs, truth = [], args.segments.split(",")
    for name in truth:
        if name == "silence":
            segs.append(_synth_silence(rng))
        elif name == "unknown":
            segs.append(_synth_unknown(rng))
        else:
            segs.append(_synth_keyword(rng, _SPECS[name]))
    stream = np.concatenate(segs).astype(np.float32)
    samples_per_seg = len(stream) // len(truth)

    sess = StreamingKwsSession(params, CONFIG, threshold=0.1, fex=fex,
                               device=device)
    n_chunks = -(-len(stream) // args.chunk)
    print(f"\nstreaming {len(stream)} raw samples in {n_chunks} chunks of "
          f"{args.chunk} (one FEx and one ΔGRU launch per chunk, all "
          f"state carried on {device}):")
    frame0 = 0
    for c in range(n_chunks):
        lo = c * args.chunk
        out = sess.process_audio(stream[lo:lo + args.chunk])
        # ONE host fetch per chunk: frame votes + per-frame transmit counts.
        votes = out.votes[:, 0].cpu().numpy()
        nz = out.nz[:, 0].cpu().numpy()
        if len(votes) == 0:
            continue
        seg = min((lo + args.chunk // 2) // samples_per_seg, len(truth) - 1)
        top = np.bincount(votes, minlength=len(CLASSES)).argmax()
        macs_pf = nz.mean() * 3 * CONFIG.d_model
        print(f"  chunk {c} frames {frame0:3d}-{frame0 + len(votes) - 1:3d} "
              f"[truth={truth[seg]:8s}] vote={CLASSES[top]:8s} "
              f"avg_macs/frame={macs_pf:6.0f} "
              f"energy={frame_cost(macs_pf).energy_nj_per_decision:6.1f}nJ")
        frame0 += len(votes)

    s = sess.summary()                               # ONE telemetry fetch
    print(f"\nstream sparsity: {s.sparsity:.3f}  "
          f"avg energy {s.energy_nj_per_decision:.1f} nJ/decision "
          f"(FEx share {s.fex_energy_nj_per_decision:.1f} nJ from "
          f"{s.fex_samples} counted samples)  "
          f"avg latency {s.latency_ms:.2f} ms "
          f"(dense would be {s.dense_energy_nj:.1f} nJ)")
    report = sess.kernel_tuning_report()
    tuned = {k: v["config"] for k, v in report["kernels"].items()}
    print(f"kernel launch configurations ({report['platform']}, cache "
          f"{report['cache']}): {tuned}")
    print("\nto serve MANY concurrent streams (commands as documented "
          "in README.md):")
    print(f"  a slot pool:       {commands.SERVE_CMD}")
    print(f"  always-on detect:  {commands.SERVE_DETECT_CMD}")
    print(f"  tune the kernels:  {commands.TUNE_CMD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
