"""Helpers of the LM-mesh tests (``test_torch_lm_mesh*.py``): a fake
process group for one process, and the bodies the spawned gloo ranks run.

No JAX here: every rank imports only the port.  The parent computes the
JAX references first (unsharded: GSPMD placement does not change the
math) and hands the ranks the reference's weights and tokens as numpy
trees, carried across by ``params_from_numpy``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

B, S, PREFILL, DECODE_STEPS, CACHE = 8, 32, 8, 4, 16
# The reference's test_distributed.py optimizer; float32 runs add eps
# 1e-3 (as test_torch_lm_models.py does): with 1e-8 Adam's first step is
# lr·sign(g), and a gradient component at rounding-noise level, summed in
# another order across ranks, flips to a full ±lr step.
OPT = {"lr": 1e-2, "warmup_steps": 0, "weight_decay": 0.0}
OPT_F32 = {**OPT, "eps": 1e-3}
# qwen2-0.5b smoke with fewer heads or KV heads than a 4-wide 'model'
# axis: 2 heads and 1 KV head (no head split), and its own 4 heads over 2
# KV heads (a head split the KV heads do not divide).
FEW_HEADS = {"h2_kv1": {"n_heads": 2, "n_kv_heads": 1}, "h4_kv2": {}}
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "mamba2-370m", "zamba2-2.7b",
                "seamless-m4t-large-v2")


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A ``fake`` process group of ``world`` ranks seen from ``rank``
    (collectives are counted, not run), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def full(x):
    """A DTensor's whole value (``x`` otherwise), detached on the CPU."""
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().cpu()


def comm_counts(cm) -> dict:
    """CommDebugMode's counts by the collective's short name."""
    return {str(k).split(".")[-1]: v for k, v in cm.get_comm_counts().items()}


def torch_cfg(arch: str, dtype):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def train_losses(cfg, shd, host_params, tokens, opt_kw, steps=3,
                 microbatches=1):
    """``steps`` AdamW steps of ``build_train_step`` on the placed batch:
    (losses, params, opt state)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import inputs, steps as steps_lib
    from repro_torch.models import get_api, params_from_numpy
    from repro_torch.train import optimizer as opt
    _, axes = get_api(cfg, shd, "cpu").init(None)
    params = shd.shard_params(params_from_numpy(host_params), axes)
    state = opt.init(params)
    fn, _ = steps_lib.build_train_step(
        cfg, ShapeConfig("t", seq_len=S, global_batch=B, kind="train"), shd,
        opt_cfg=opt.AdamWConfig(**opt_kw), microbatches=microbatches)
    tok = torch.from_numpy(tokens)
    batch = inputs.place_batch({"tokens": tok[:, :S], "labels": tok[:, 1:]},
                               shd)
    losses = []
    for _ in range(steps):
        params, state, m = fn(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, params, state


# ------------------------------------- group 1: qwen2-0.5b and the cases
def qwen2_rank(rank, n, ref, workdir):
    """The reference's three distributed cases at 4 ranks and qwen2-0.5b
    smoke on ``(2, 2)``: 3 AdamW steps in bf16 and float32, prefill + 4
    decode steps under DECODE_RULES; zamba2 smoke float32 on ``(2, 2)``,
    the same steps, and gemma3's decode; and the FEW_HEADS configs on
    ``(1, 4)``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import (
        P, NamedSharding, Sharder, place, spec_placements, tree_leaves)
    from repro_torch.train import checkpoint as ckpt
    out = {}
    mesh = make_host_mesh(model=2, device="cpu")
    shd = Sharder(mesh=mesh)
    # 1. sharded equivalence (the reference's SHARDED_EQUIV), bf16.
    losses, params, _ = train_losses(torch_cfg("qwen2-0.5b", torch.bfloat16),
                                     shd, ref["params_bf16"], ref["tokens"],
                                     OPT)
    out["bf16"] = (losses, full(tree_leaves(params)[0]).float().numpy())
    # float32, every leaf.
    losses, params, state = train_losses(
        torch_cfg("qwen2-0.5b", torch.float32), shd, ref["params_f32"],
        ref["tokens"], OPT_F32)
    out["f32"] = (losses, [full(x).numpy() for x in tree_leaves(params)])
    out["f32_first_leaf_placements"] = tuple(tree_leaves(params)[0].placements)
    # One step in two microbatches of a batch-sharded batch.
    mb_losses, mb_params, _ = train_losses(
        torch_cfg("qwen2-0.5b", torch.float32), shd, ref["params_f32"],
        ref["tokens"], OPT_F32, steps=1, microbatches=2)
    out["f32_microbatched"] = (mb_losses, tuple(
        tree_leaves(mb_params)[0].placements))
    out["placements_kept"] = all(
        tuple(x.placements) == s.placements for x, s in zip(
            tree_leaves(state.master),
            tree_leaves(shd.param_shardings(params, get_api(
                torch_cfg("qwen2-0.5b", torch.float32), shd).init(None)[1]))))
    # Prefill + decode steps under DECODE_RULES (build_serve_step's).
    logits, c_specs, cache = decode_logits(
        torch_cfg("qwen2-0.5b", torch.float32), mesh, ref["params_f32"],
        ref["tokens"])
    out["decode"] = logits
    out["cache_sharding"] = (str(c_specs["k"].sharding.spec),
                             str(tuple(cache["k"].placements)))
    # zamba2 smoke, float32, on (2, 2): 3 AdamW steps and prefill + decode
    # steps.  Its projection's 296 columns split 148 to a 'model' rank,
    # the offsets of its parts (128, 288) inside the shards, and the
    # shared attention's cache is split on its sequence.
    cfgz = torch_cfg("zamba2-2.7b", torch.float32)
    losses, params, _ = train_losses(cfgz, shd, ref["params_zamba2"],
                                     ref["tokens"], OPT_F32)
    logits, _, cache = decode_logits(cfgz, mesh, ref["params_zamba2"],
                                     ref["tokens"])
    out["zamba2"] = (losses, logits,
                     str(tuple(params["mamba"]["w_in"].placements)),
                     str(tuple(cache.k.placements)))
    # gemma3 smoke, float32, on (2, 2): prefill + decode steps whose
    # local layers' window (8) starts inside the first rank's block of
    # the sequence-split cache.
    out["gemma3"] = decode_logits(torch_cfg("gemma3-4b", torch.float32),
                                  mesh, ref["params_gemma3"],
                                  ref["tokens"])[0]
    # Heads the 'model' axis does not divide, on (1, 4): 3 float32 steps
    # and the decode logits of each FEW_HEADS config.
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    for name, kw in FEW_HEADS.items():
        cfg = dataclasses.replace(torch_cfg("qwen2-0.5b", torch.float32),
                                  **kw)
        host = ref["few_heads"][name]
        losses, _, _ = train_losses(cfg, Sharder(mesh=mesh14), host,
                                    ref["tokens"], OPT_F32)
        out[f"few_heads_{name}"] = (losses, decode_logits(
            cfg, mesh14, host, ref["tokens"])[0])
    # 2. elastic restore (the reference's ELASTIC_RESHARD): (4,) → (2, 2).
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    sh4 = NamedSharding(mesh4, P("data", None),
                        spec_placements(mesh4, P("data", None)))
    ckpt.save(workdir, 3, {"w": place(x, sh4)})
    tgt = NamedSharding(mesh, P("data", "model"),
                        spec_placements(mesh, P("data", "model")))
    back = ckpt.restore(workdir, 3, {"w": x}, shardings={"w": tgt})["w"]
    out["elastic"] = (torch.equal(full(back), x),
                      tuple(back.placements) == tgt.placements
                      and back.device_mesh == mesh,
                      ckpt.meta(workdir, 3)["mesh"])
    # 3. the multi-pod collectives (MULTIPOD_COLLECTIVES) on (1, 2, 2).
    mesh3 = init_device_mesh("cpu", (1, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
    s3 = Sharder(mesh=mesh3)
    spec = s3.spec((8, 16), ("batch", "mlp"))
    w = place(torch.ones(16, 16, dtype=torch.bfloat16),
              s3.sharding((16, 16), ("embed", "mlp")))
    xb = place(torch.ones(8, 16, dtype=torch.bfloat16),
               s3.sharding((8, 16), ("batch", None)))
    w = w.detach().requires_grad_(True)
    with s3.scope(), CommDebugMode() as cm:
        loss = torch.sum(torch.tanh(xb @ w) ** 2)
        loss = loss.redistribute(mesh3, s3.sharding((), ()).placements)
        (g,) = torch.autograd.grad(loss, [w])
        g = place(g, s3.sharding((16, 16), ("embed", "mlp")))
    out["multipod"] = (spec, comm_counts(cm), full(g).float().numpy())
    return out


def decode_logits(cfg, mesh, host_params, tokens):
    """Prefill PREFILL tokens, then DECODE_STEPS steps of
    ``build_serve_step`` (DECODE_RULES) on ``mesh``: (the logits of each
    step as numpy, the cache specs, the last cache)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import inputs, steps as steps_lib
    from repro_torch.models import get_api, params_from_numpy
    from repro_torch.parallel.sharding import (DECODE_RULES, Sharder, place,
                                              tree_map)
    serve, (p_specs, c_specs, _) = steps_lib.build_serve_step(
        cfg, ShapeConfig("d", seq_len=CACHE, global_batch=B, kind="decode"),
        Sharder(mesh=mesh), device="cpu")
    p_sh = tree_map(lambda s: s.sharding, p_specs)
    dparams = tree_map(place, params_from_numpy(host_params), p_sh)
    dshd = Sharder(mesh=mesh, rules=DECODE_RULES)
    api = get_api(cfg, dshd, "cpu")
    tok = torch.from_numpy(tokens)
    cache = api.init_cache(B, CACHE)
    cache, lp = api.prefill(dparams, inputs.place_batch(
        {"tokens": tok[:, :PREFILL]}, dshd)["tokens"], cache)
    logits = [full(lp)]
    for t in range(PREFILL, PREFILL + DECODE_STEPS):
        lg, cache = serve(dparams, cache, inputs.place_batch(
            {"tokens": tok[:, t:t + 1]}, dshd))
        logits.append(full(lg))
    return [x.numpy() for x in logits], c_specs, cache


# ---------------------------------- group 2: one loss of each family
def family_rank(rank, n, refs):
    """One float32 loss of each family's smoke config on ``(2, 2)``."""
    from repro_torch.launch import inputs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_api, params_from_numpy
    mesh = make_host_mesh(model=2, device="cpu")
    from repro_torch.parallel.sharding import Sharder
    shd = Sharder(mesh=mesh)
    out = {}
    for arch, (host, batch) in refs.items():
        cfg = torch_cfg(arch, torch.float32)
        api = get_api(cfg, shd, "cpu")
        _, axes = api.init(None)
        params = shd.shard_params(params_from_numpy(host), axes)
        b = inputs.place_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()}, shd)
        with torch.no_grad():
            loss, _ = api.loss(params, b)
        out[arch] = float(full(loss))
    return out


def np_tokens(vocab: int, seed: int, batch: int = B, seq: int = S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
