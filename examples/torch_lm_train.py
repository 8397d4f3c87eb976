"""Framework example of the PyTorch/CUDA port: train a reduced LM from the
architecture zoo on the synthetic token stream, with checkpoint/restore
(the port's counterpart of ``examples/lm_train.py``).

One device, ``Sharder(mesh=None)``, as the reference's example; runs on
the GPU unless given ``--device cpu``.  Any of the 10 architectures works
(its smoke config).  Run with the exact command README.md documents
(repro_torch.commands is the single source of truth for both)::

    PYTHONPATH=src python examples/torch_lm_train.py \
        --arch qwen2-0.5b --steps 60
"""
import argparse
import tempfile

import torch

from repro_torch import commands
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.kernels.platform import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import get_api
from repro_torch.parallel.sharding import Sharder
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    shape = ShapeConfig("example", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    shd = Sharder(mesh=None)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    fn, _ = build_train_step(cfg, shape, shd, opt_cfg=ocfg)

    api = get_api(cfg, shd, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)

    def data_fn(step):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch_at(step).items()}
        if cfg.frontend != "none":
            batch["embeds"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.d_model),
                dtype=torch.float32, device=device)
        return batch

    with tempfile.TemporaryDirectory(prefix=f"lm_{args.arch}_") as ckpt:
        trainer = Trainer(TrainerConfig(ckpt_dir=ckpt, ckpt_every=25),
                          fn, params, state, data_fn)
        hist = trainer.run(args.steps)
    losses = [h.metrics["loss"] for h in hist]
    print(f"{args.arch}: loss {losses[0]:.3f} → {losses[-1]:.3f} over "
          f"{args.steps} steps (checkpoints every 25 steps)")
    print(f"as a command: {commands.LM_TRAIN_EXAMPLE_CMD}")
    if not losses[-1] < losses[0]:
        print("the loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
