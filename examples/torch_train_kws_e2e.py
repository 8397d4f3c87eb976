"""End-to-end driver of the PyTorch/CUDA port: train the paper's KWS
model with the port's Trainer — checkpointing, fault injection and
recovery, straggler watchdog — then PROMOTE it to the deployed integer
numerics.

Training runs QAT by default (8-bit STE weights, Q0.15 hidden grid —
``models.kws.loss_fn(qat=True)``), so the final fold into the int8
bundle (``core.fixed_point.promote_kws``) serves within a hair of the
float accuracy; the script prints both.  Features come from the FEx
kernel, the gradient from the differentiable ΔGRU, and the evaluation
runs the serving kernels.  Runs on the GPU unless given ``--device cpu``.

Run with the exact command README.md documents (repro_torch.commands is
the single source of truth for both):

    PYTHONPATH=src python examples/torch_train_kws_e2e.py
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import commands
from repro_torch.configs.deltakws import CONFIG
from repro_torch.data.gscd import synth_batch
from repro_torch.frontend import FeatureExtractor
from repro_torch.kernels.platform import resolve_device
from repro_torch.models import kws
from repro_torch.train import optimizer as opt
from repro_torch.train.promote import eval_promotion, make_kws_step_fn
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--eval-n", type=int, default=256,
                    help="held-out utterances of the float/int8 eval")
    ap.add_argument("--no-fault", action="store_true",
                    help="do not inject the simulated node failure")
    ap.add_argument("--no-qat", action="store_true",
                    help="train in pure float (skips deployment numerics)")
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
    qat = not args.no_qat
    step_fn = make_kws_step_fn(cfg, ocfg, 0.1, qat=qat)

    def data_fn(step):               # replayable: pure function of step
        audio, labels = synth_batch(np.random.default_rng(step), args.batch)
        return {"feats": fex(torch.from_numpy(audio).to(device)),
                "labels": torch.from_numpy(labels).to(device)}

    print(f"training the KWS model for {args.steps} steps on {device} "
          f"({'QAT' if qat else 'float'}) ...")
    ckpt_dir = tempfile.mkdtemp(prefix="deltakws_torch_ckpt_")
    try:
        trainer = Trainer(TrainerConfig(ckpt_dir=ckpt_dir,
                                        ckpt_every=args.ckpt_every),
                          step_fn, params, opt.init(params), data_fn)
        fault = {"armed": not args.no_fault}

        def fault_hook(step):
            if step == args.steps // 2 and fault["armed"]:
                fault["armed"] = False
                print(f"  !! injected node failure at step {step} — "
                      f"recovering from checkpoint")
                raise RuntimeError("simulated preemption")

        hist = trainer.run(args.steps, fault_hook=fault_hook)
        for h in hist[::max(1, len(hist) // 10)]:
            print(f"  step {h.step:4d}  loss {h.metrics['loss']:.3f} "
                  f"acc {h.metrics['acc']:.3f} "
                  f"sparsity {h.metrics.get('sparsity', 0):.3f} "
                  f"{'STRAGGLER' if h.is_straggler else ''}")
        print(f"recoveries: {trainer.recoveries}, "
              f"stragglers flagged: {len(trainer.straggler_steps)}")
        if hist:
            print(f"final acc: {hist[-1].metrics['acc']:.3f}")

        # Train→deploy promotion: fold into the integer bundle and compare
        # the float path against the bit-true int8 pipeline on held-out
        # data.
        acc_f, acc_i, _ = eval_promotion(trainer.params, cfg, fex, 0.1,
                                         n=args.eval_n)
        print(f"promotion ({'QAT' if qat else 'float'}-trained): "
              f"float acc {acc_f:.3f} → int8 acc {acc_i:.3f} "
              f"(Δ {acc_i - acc_f:+.3f})")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("\nthe same through the launcher, then served (commands as "
          "documented in README.md):")
    print(f"  train + promote:  {commands.TRAIN_PROMOTE_CMD}")
    print(f"  serve the bundle: {commands.SERVE_BUNDLE_CMD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
