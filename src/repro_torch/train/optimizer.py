"""AdamW with linear warmup and cosine decay, on dicts of tensors.

Port of ``repro/train/optimizer.py``: the optimizer state keeps a float32
master copy of the parameters and float32 moments (m, v); gradients are
clipped by their global norm and applied to the master, and the returned
parameters are cast from it.  ``AdamWState`` has the reference's fields,
so a checkpoint's keys (``opt/step``, ``opt/master/w_x``, …) are the same
in both packages.  The step counter, the learning rate and the clip factor
stay tensors on the parameters' device: an update reads nothing back to
the host.  The parameters may be a flat dict (the KWS model) or nested
dicts whose leaves mix dtypes (the LM stacks: bf16 weights, an f32 MoE
router and norm scales); the state mirrors their structure.  On an LM
mesh the leaves are DTensors: master, m and v keep their parameter's
placements, and the clip norm is one plain scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import is_dtensor, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    master: Any          # f32 param copy (a dict like the params)
    m: Any
    v: Any


def init(params: dict) -> AdamWState:
    """Zero moments and a float32 master copy that never aliases a
    parameter tensor."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    dev = tree_leaves(master)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      master=master, m=tree_map(torch.zeros_like, master),
                      v=tree_map(torch.zeros_like, master))


def opt_axes(param_axes) -> AdamWState:
    """Logical-axes tree for the optimizer state (mirrors the params)."""
    return AdamWState(step=(), master=param_axes, m=param_axes, v=param_axes)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _sq_sum(x) -> torch.Tensor:
    """Σ x² in float32; a DTensor's partial sums are reduced to one plain
    scalar, the same on every rank."""
    s = torch.sum(torch.square(x.to(torch.float32)))
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree: dict) -> torch.Tensor:
    """√Σ x² over every leaf: one plain scalar, whatever the leaves'
    placements."""
    return torch.sqrt(sum(_sq_sum(x) for x in tree_leaves(tree)))


def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict
           ) -> tuple[dict, AdamWState, dict]:
    """Returns (new_params (each in its param's dtype), new_state,
    metrics {"grad_norm", "lr"}).  Functional: nothing is updated in
    place."""
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(g, mst, m, v):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        return (mst - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                            + cfg.weight_decay * mst), m, v)

    out = tree_map(upd, grads, state.master, state.m, state.v)
    master, m, v = (tree_map(lambda o: o[i], out) for i in range(3))
    new_params = tree_map(lambda mst, p: mst.to(p.dtype, copy=True),
                          master, params)
    return (new_params, AdamWState(step=step, master=master, m=m, v=v),
            {"grad_norm": gnorm, "lr": lr})
