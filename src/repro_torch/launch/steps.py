"""Step-function factories shared by the trainer and the server.

Port of ``repro/launch/steps.py``.  Each builder returns (fn, arg_specs)
where arg_specs are ``meta``-device tensors (shapes and dtypes, no
allocation) whose ``sharding`` attribute is their NamedSharding on the
Sharder's mesh (None without one), for shaping real buffers.  The
functions are eager PyTorch: the reference's ``jax.jit`` and buffer
donation have no counterpart here.  On a mesh the train step returns
parameters and optimizer moments with exactly their ``param_shardings``
placements (the reference's out-shardings): gradients are reduced onto
their parameter's placements before the update.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import inputs as inputs_lib
from repro_torch.models import get_api
from repro_torch.parallel.sharding import (Sharder, is_dtensor, place,
                                          tree_leaves, tree_map)
from repro_torch.train import optimizer as opt_lib


def _with_shardings(specs, shardings):
    def tag(t, sh):
        t.sharding = sh
        return t
    return tree_map(tag, specs, shardings)


def param_specs(cfg: ArchConfig, shd: Sharder):
    """(parameter ``meta`` tensors with their shardings, logical axes) —
    no allocation."""
    specs, axes = get_api(cfg, shd).init(None)
    return _with_shardings(specs, shd.param_shardings(specs, axes)), axes


def opt_specs(cfg: ArchConfig, shd: Sharder, p_specs, p_axes):
    """Optimizer-state ``meta`` tensors with their shardings (master, m
    and v take their parameter's; the step counter stays a plain tensor
    on every rank)."""
    state = opt_lib.init(p_specs)
    sh = shd.param_shardings(state, opt_lib.opt_axes(p_axes))
    return _with_shardings(state, sh._replace(step=None))


def _plain(x):
    """A DTensor's whole value as a plain tensor (``x`` otherwise)."""
    return x.full_tensor() if is_dtensor(x) else x


def _grads(loss_fn, params, batch, shardings=None):
    """(loss, metrics, grads in each parameter's dtype).  On a mesh the
    loss is reduced to a replicated scalar before the backward, each
    gradient is placed as its parameter (``shardings``), and the loss and
    metrics come back as plain tensors."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    if is_dtensor(loss):
        from torch.distributed.tensor import Replicate
        loss = loss.redistribute(
            loss.device_mesh, (Replicate(),) * loss.device_mesh.ndim)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), leaves)
    if shardings is not None:
        grads = tree_map(place, grads, shardings)
    return (_plain(loss.detach()),
            {k: _plain(v.detach()) for k, v in metrics.items()}, grads)


def microbatch(batch: dict, i: int, n: int, shd: Sharder) -> dict:
    """Microbatch ``i`` of ``n``: rows ``[i·B/n, (i+1)·B/n)`` of every
    entry (the reference's reshape grouping), placed by the batch's
    logical axes."""
    part = {}
    for k, v in batch.items():
        v = _plain(v)
        part[k] = v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    return inputs_lib.place_batch(part, shd) if shd.mesh is not None \
        else part


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
    p_sh = tree_map(lambda s: s.sharding, p_specs)
    o_sh = tree_map(lambda s: getattr(s, "sharding", None), o_specs)
    mesh = shd.mesh is not None

    def train_step(params, opt_state, batch):
        with shd.scope():
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _grads(api.loss, params, batch,
                                          p_sh if mesh else None)
        else:
            gacc = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lacc = 0.0
            for i in range(microbatches):
                b = microbatch(batch, i, microbatches, shd)
                loss_i, metrics, g = _grads(api.loss, params, b,
                                            p_sh if mesh else None)
                gacc = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                gacc, g)
                lacc = lacc + loss_i
            grads = tree_map(lambda g: g / microbatches, gacc)
            loss = lacc / microbatches
        new_params, new_opt, om = opt_lib.update(opt_cfg, grads, opt_state,
                                                 params)
        if mesh:                     # the reference's out_shardings
            new_params = tree_map(place, new_params, p_sh)
            new_opt = tree_map(place, new_opt, o_sh)
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
