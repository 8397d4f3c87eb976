"""Quickstart of the PyTorch/CUDA port: the paper's pipeline on the card.

  audio (12-bit, 8 kHz) → IIR BPF FEx → ΔGRU(64) → FC(12)

Trains on SynthCommands (features from the FEx kernel, the gradient
through the port's differentiable ΔGRU), then shows the paper's headline
trade-off through the serving kernels: accuracy / temporal sparsity /
energy / latency vs the delta threshold.  Runs on the GPU unless given
``--device cpu`` (the kernels' plain versions: keep the flags small).

Run with the exact command README.md documents (repro_torch.commands is
the single source of truth for both):

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import argparse

import numpy as np
import torch

from repro_torch import commands
from repro_torch.configs.deltakws import CONFIG
from repro_torch.core import temporal_sparsity
from repro_torch.core.energy_model import cost_from_sparsity
from repro_torch.data.gscd import synth_batch
from repro_torch.frontend import FeatureExtractor
from repro_torch.kernels.platform import resolve_device
from repro_torch.models import kws
from repro_torch.train import optimizer as opt
from repro_torch.train.promote import make_kws_step_fn

TRAIN_TH = 0.1      # threshold-aware training (DeltaRNN recipe)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-n", type=int, default=512,
                    help="held-out utterances of the threshold sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = CONFIG
    fex = FeatureExtractor()
    params = {k: v.to(device) for k, v in kws.init_kws(
        torch.Generator().manual_seed(0), cfg,
        input_dim=fex.cfg.n_active).items()}
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=min(20, args.steps // 4),
                           total_steps=max(args.steps, 1))
    state = opt.init(params)
    step = make_kws_step_fn(cfg, ocfg, TRAIN_TH, qat=False)
    rng = np.random.default_rng(0)

    print(f"training ΔGRU KWS on SynthCommands ({device}) ...")
    for i in range(args.steps):
        audio, labels = synth_batch(rng, args.batch)
        feats = fex(torch.from_numpy(audio).to(device))
        params, state, m = step(params, state, {
            "feats": feats, "labels": torch.from_numpy(labels).to(device)})
        if i % 50 == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {float(m['loss']):.3f}  "
                  f"acc {float(m['acc']):.3f}")

    audio, labels = synth_batch(np.random.default_rng(99), args.eval_n)
    labels = torch.from_numpy(labels).to(device)
    print("\n Δ_TH   acc12  acc11  sparsity  nJ/decision  latency_ms")
    with torch.no_grad():
        feats = fex(torch.from_numpy(audio).to(device))
        for th in [0.0, 0.05, 0.1, 0.2]:
            logits, stats = kws.forward(params, cfg, feats, threshold=th,
                                        backend="pallas")
            acc = float((logits.argmax(-1) == labels).float().mean())
            acc11 = float(kws.accuracy_11class(logits, labels))
            sp = float(temporal_sparsity(stats))
            c = cost_from_sparsity(sp)
            print(f"  {th:.2f}  {acc:6.3f} {acc11:6.3f}  {sp:8.3f}"
                  f"  {c.energy_nj_per_decision:11.2f}"
                  f"  {c.latency_ms:10.2f}")
    print("\npaper design point: 87% sparsity → 36.11 nJ, 6.9 ms "
          "(3.4× / 2.4× vs dense)")
    print("\nnext steps (commands as documented in README.md):")
    print(f"  stream raw audio:   {commands.STREAM_EXAMPLE_CMD}")
    print(f"  serve a slot pool:  {commands.SERVE_CMD}")
    print(f"  tune the kernels:   {commands.TUNE_CMD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
