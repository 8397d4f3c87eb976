"""Training launcher of the port: ``python -m repro_torch.launch.train``.

``--arch <lm>`` (default ``qwen2-0.5b``) trains one of the LM stacks on
the replayable ``data.lm_data.SyntheticLM`` batches (``--batch`` × ``--seq``
tokens, zero frame/patch embeddings for the vlm and audio stubs) through
``launch.steps.build_train_step`` and the fault-tolerant
``train.trainer.Trainer``: the smoke config by default, the full
(assigned) one with ``--full-config``; weights from the port's seeded
init.  It prints the loss over the run and the step time.

``--arch deltakws`` trains the paper's KWS model on synthetic utterances
(``data.gscd.synth_batch`` of ``default_rng(step)``, the reference's
replayable batches): QAT by default (8-bit STE weights + the Q0.15 hidden
grid, so training sees the deployed integer numerics), through the
fault-tolerant ``train.trainer.Trainer`` (periodic atomic checkpoints,
restore on start, recovery by replay).  It prints the loss over the run,
the step time, and the float and promoted-int8 accuracy on a held-out
batch; ``--promote out.npz`` folds the trained weights into the int8
bundle that ``repro_torch.launch.serve --numerics int8 --bundle out.npz``
(or the JAX package's serve) serves bit-true.

Runs on ``--device`` (default ``cuda``; raises without a GPU; ``cpu`` runs
the kernels' plain versions).  On the card each batch's features come
from the ``iir_fex`` kernel; the step itself is the eager, differentiable
ΔGRU loop under ``torch.autograd`` (no kernel has a backward, as no
Pallas kernel of the reference has one), and the evaluation runs the
serving kernels.

Checkpoints go to ``--ckpt-dir``, by default one directory per arch
under the temporary directory, so two architectures never mix
checkpoints; a run restores from the newest one found there.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

import numpy as np
import torch

EVAL_N = 256                 # held-out utterances of the float/int8 eval


def train_kws(args) -> dict:
    """QAT train → checkpoint → evaluate → promote: the KWS
    train-to-deploy path behind ``--arch deltakws``.  Returns the run's
    record: ``trainer`` (its ``params``, ``history``, ``recoveries``…),
    ``device``, ``acc_float`` / ``acc_int8`` on the held-out batch, the
    promoted ``bundle`` and the ``bundle_path`` written (or None)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import synth_batch
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.models import kws
    from repro_torch.train import optimizer as opt
    from repro_torch.train.promote import (eval_promotion, make_kws_step_fn,
                                           save_bundle)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = CONFIG
    fex = FeatureExtractor()
    params = {k: v.to(device) for k, v in kws.init_kws(
        torch.Generator().manual_seed(0), cfg,
        input_dim=fex.cfg.n_active).items()}
    ocfg = opt.AdamWConfig(lr=args.lr, weight_decay=0.01,
                           warmup_steps=min(20, args.steps // 4),
                           total_steps=args.steps)
    step_fn = make_kws_step_fn(cfg, ocfg, args.threshold,
                               qat=not args.no_qat)

    def data_fn(step):               # replayable: pure function of step
        audio, labels = synth_batch(np.random.default_rng(step), args.batch)
        return {"feats": fex(torch.from_numpy(audio).to(device)),
                "labels": torch.from_numpy(labels).to(device)}

    trainer = Trainer(TrainerConfig(ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every),
                      step_fn, params, opt.init(params), data_fn)
    start = trainer.maybe_restore()
    if start:
        print(f"restored from step {start}")
    trainer.run(args.steps)
    # Eval: float forward vs the promoted integer pipeline.
    acc_f, acc_i, bundle = eval_promotion(trainer.params, cfg, fex,
                                          args.threshold, n=EVAL_N)
    out = save_bundle(args.promote, bundle) if args.promote else None
    return {"trainer": trainer, "device": device, "acc_float": acc_f,
            "acc_int8": acc_i, "bundle": bundle, "bundle_path": out}


def _kws_main(args) -> int:
    run = train_kws(args)
    trainer = run["trainer"]
    hist = trainer.history
    walls = [h.wall_s * 1e3 for h in hist]
    print(f"deltakws ({'float' if args.no_qat else 'QAT'}, batch "
          f"{args.batch}, Δ_TH {args.threshold}) on {run['device']}: "
          f"loss {hist[0].metrics['loss']:.3f} → "
          f"{hist[-1].metrics['loss']:.3f}, "
          f"acc {hist[-1].metrics['acc']:.3f}, "
          f"sparsity {hist[-1].metrics['sparsity']:.3f}")
    print(f"step time: median {statistics.median(walls):.1f} ms, first "
          f"{walls[0]:.1f} ms over {len(walls)} steps; "
          f"stragglers={len(trainer.straggler_steps)} "
          f"recoveries={trainer.recoveries}")
    acc_f, acc_i = run["acc_float"], run["acc_int8"]
    print(f"eval acc ({EVAL_N} utterances): float {acc_f:.3f}, "
          f"promoted int8 {acc_i:.3f} (Δ {acc_i - acc_f:+.3f})")
    if run["bundle_path"] is not None:
        print(f"promoted int8 bundle → {run['bundle_path']}  (serve with: "
              f"python -m repro_torch.launch.serve --numerics int8 "
              f"--bundle {run['bundle_path']})")
    return 0


def train_lm(args) -> dict:
    """The LM half: ``args.arch`` smoke (or ``--full-config``) trained
    ``args.steps`` AdamW steps on SyntheticLM.  Returns the run's record:
    ``trainer``, ``device``, ``cfg`` and ``start`` (the restored step)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    shape = ShapeConfig("launch", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    shd = Sharder(mesh=None)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 4),
                           total_steps=args.steps)
    fn, _ = build_train_step(cfg, shape, shd, opt_cfg=ocfg)
    params, _ = get_api(cfg, shd, device).init(
        torch.Generator(device=device).manual_seed(0))
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)

    def data_fn(step):               # replayable: pure function of step
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(step).items()}
        if cfg.frontend != "none":
            b["embeds"] = torch.zeros((args.batch, cfg.frontend_tokens,
                                       cfg.d_model), device=device)
        return b

    trainer = Trainer(TrainerConfig(ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every),
                      fn, params, opt.init(params), data_fn)
    start = trainer.maybe_restore()
    trainer.run(args.steps)
    return {"trainer": trainer, "device": device, "cfg": cfg,
            "start": start}


def _lm_main(args) -> int:
    run = train_lm(args)
    trainer, cfg = run["trainer"], run["cfg"]
    if run["start"]:
        print(f"restored from step {run['start']}")
    hist = trainer.history
    walls = [h.wall_s * 1e3 for h in hist]
    print(f"{args.arch} ({'full' if args.full_config else 'smoke'} config, "
          f"{cfg.n_params() / 1e6:.1f} M params, batch {args.batch} x "
          f"{args.seq}) on {run['device']}: "
          f"loss {hist[0].metrics['loss']:.3f} → "
          f"{hist[-1].metrics['loss']:.3f}; "
          f"stragglers={len(trainer.straggler_steps)} "
          f"recoveries={trainer.recoveries}")
    print(f"step time: median {statistics.median(walls):.1f} ms, first "
          f"{walls[0]:.1f} ms over {len(walls)} steps")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="an LM of configs.ARCH_IDS, or deltakws (the "
                         "paper's KWS model)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences per step (deltakws: utterances; "
                         "the default 8 becomes 64 there)")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM tokens per sequence")
    ap.add_argument("--full-config", action="store_true",
                    help="LM: the full (assigned) config instead of smoke")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (restored from on start); "
                         "default: one per arch under the temporary "
                         "directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="deltakws: train/deploy Δ_TH")
    ap.add_argument("--no-qat", action="store_true",
                    help="deltakws: disable quantization-aware training")
    ap.add_argument("--promote", default="",
                    help="deltakws: fold the trained model into an int8 "
                         "bundle (.npz) at this path after training")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    from repro_torch.configs import ARCH_IDS
    if args.arch != "deltakws" and args.arch not in ARCH_IDS:
        ap.error(f"--arch {args.arch!r}: not one of deltakws, "
                 f"{', '.join(ARCH_IDS)}")
    for name in ("steps", "batch", "ckpt_every", "seq"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.arch == "deltakws":
        if args.batch == 8:          # the LM default is tiny for KWS
            args.batch = 64
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(tempfile.gettempdir(),
                                     f"repro_torch_{args.arch}_train")
    if args.arch == "deltakws":
        return _kws_main(args)
    return _lm_main(args)


if __name__ == "__main__":
    sys.exit(main())
