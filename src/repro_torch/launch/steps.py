"""Step-function factories shared by the trainer and the server.

Port of ``repro/launch/steps.py``.  Each builder returns (fn, arg_specs)
where arg_specs are ``meta``-device tensors (shapes and dtypes, no
allocation) for shaping real buffers.  The functions are eager PyTorch:
the reference's ``jax.jit`` and buffer donation have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import inputs as inputs_lib
from repro_torch.models import get_api
from repro_torch.parallel.sharding import Sharder, tree_leaves, tree_map
from repro_torch.train import optimizer as opt_lib


def param_specs(cfg: ArchConfig, shd: Sharder):
    """(parameter ``meta`` tensors, logical axes) — no allocation."""
    specs, axes = get_api(cfg, shd).init(None)
    shd.param_shardings(specs, axes)         # raises on a mesh (item 9c)
    return specs, axes


def opt_specs(cfg: ArchConfig, shd: Sharder, p_specs, p_axes):
    state = opt_lib.init(p_specs)
    shd.param_shardings(state.master, opt_lib.opt_axes(p_axes).master)
    return state


def _grads(loss_fn, params, batch):
    """(loss, metrics, grads in each parameter's dtype)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), leaves))


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder,
                     opt_cfg: opt_lib.AdamWConfig | None = None,
                     microbatches: int = 1):
    """microbatches > 1 → gradient accumulation: the global batch is split
    into ``microbatches`` sequential chunks, grads accumulate in f32, one
    optimizer step at the end.  Activation memory scales down
    ~1/microbatches."""
    api = get_api(cfg, shd)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    p_specs, p_axes = param_specs(cfg, shd)
    o_specs = opt_specs(cfg, shd, p_specs, p_axes)
    batch_specs = inputs_lib.train_batch_specs(cfg, shape, shd)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _grads(api.loss, params, batch)
        else:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lacc = 0.0
            for i in range(microbatches):
                b = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:])[i] for k, v in batch.items()}
                loss_i, metrics, g = _grads(api.loss, params, b)
                gacc = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                gacc, g)
                lacc = lacc + loss_i
            grads = tree_map(lambda g: g / microbatches, gacc)
            loss = lacc / microbatches
        new_params, new_opt, om = opt_lib.update(opt_cfg, grads, opt_state,
                                                 params)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step, (p_specs, o_specs, batch_specs)


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder,
                       device=None):
    api = get_api(cfg, shd, device)
    p_specs, _ = param_specs(cfg, shd)
    cache_specs = api.cache_specs(shape.global_batch, shape.seq_len)
    in_specs = inputs_lib.prefill_specs(cfg, shape, shd)

    def prefill_step(params, cache, batch):
        return api.prefill(params, batch["tokens"], cache,
                           batch.get("embeds"))

    return prefill_step, (p_specs, cache_specs, in_specs)


def build_serve_step(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder,
                     device=None):
    from repro_torch.parallel.sharding import DECODE_RULES
    if shd.mesh is not None:
        rules = dict(shd.rules)
        rules.update(DECODE_RULES)
        shd = Sharder(mesh=shd.mesh, rules=rules)
    api = get_api(cfg, shd, device)
    p_specs, _ = param_specs(cfg, shd)
    cache_specs = api.cache_specs(shape.global_batch, shape.seq_len)
    in_specs = inputs_lib.decode_specs(cfg, shape, shd)

    def serve_step(params, cache, batch):
        return api.decode_step(params, cache, batch["tokens"])

    return serve_step, (p_specs, cache_specs, in_specs)


def build_step(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder,
               microbatches: int = 1):
    """Dispatch on the shape kind: train | prefill | decode."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, shd, microbatches=microbatches)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, shd)
    return build_serve_step(cfg, shape, shd)
