"""The port's LM entry points on the CPU, against the JAX package's where
both define the same thing: ``serve --mode lm`` and ``train --arch
qwen2-0.5b`` (with its checkpoint resume), the parsers' defaults for
every shared flag, the parameter / cache / input specs of every arch
(names, shapes, dtypes, logical axes), ``build_step``'s dispatch, AdamW
on a mixed bf16/f32 MoE tree, and SyntheticLM batches bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _shape_tree(tree):
    """(shape, dtype name) per leaf; a Python int index is a () int32."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _shape_tree(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, int):
        return ((), "int32")
    return (tuple(tree.shape), _dtype(tree))


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_serve_lm_on_cpu(arch, capsys):
    argv = ["--mode", "lm", "--device", "cpu", "--arch", arch,
            "--requests", "2", "--slots", "2", "--max-new", "4"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 8 tokens" in out
    run = tserve.serve_lm(tserve.build_parser().parse_args(argv))
    assert [len(st["out"]) for st in run["done"]] == [4, 4]
    assert all(0 <= t < run["cfg"].vocab_padded
               for st in run["done"] for t in st["out"])


def test_serve_lm_is_the_default_mode_and_needs_the_gpu(monkeypatch):
    args = tserve.build_parser().parse_args([])
    assert (args.mode, args.arch, args.device) == ("lm", "qwen2-0.5b",
                                                   "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.serve_lm(args)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.main(["--arch", "mamba2-370m", "--steps", "1",
                     "--ckpt-dir", "unused"])


def test_parsers_carry_the_reference_defaults():
    """Every flag both packages' serve / train CLIs define has the same
    default (the port adds --device, --params, --init-seed)."""
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    j = vars(jserve.build_parser().parse_args([]))
    t = vars(tserve.build_parser().parse_args([]))
    shared = sorted(set(j) & set(t))
    assert {"mode", "arch", "slots", "requests", "prompt_len", "max_new",
            "cache_len", "train_steps", "seed"} <= set(shared)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    assert set(j) - set(t) == set()             # --devices too
    assert t["devices"] == j["devices"] == 1
    # the reference's train parser is built inside main(): read it there
    import argparse
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        ns = orig(self, args, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jtrain.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    t = vars(ttrain.build_parser().parse_args([]))
    shared = sorted(set(seen) & set(t))
    assert set(seen) <= set(t)
    assert {k: t[k] for k in shared} == {k: seen[k] for k in shared}
    assert (t["arch"], t["batch"], t["seq"]) == ("qwen2-0.5b", 8, 64)


def test_lm_commands_parse_against_the_port_clis():
    from repro_torch import commands

    def flags(cmd, module):
        words = cmd.split()
        return words[words.index(module) + 1:]

    args = tserve.build_parser().parse_args(
        flags(commands.SERVE_LM_CMD, "repro_torch.launch.serve"))
    tserve.validate_args(args)
    assert (args.mode, args.arch, args.requests, args.slots) == \
        ("lm", "qwen2-0.5b", 8, 4)
    args = ttrain.build_parser().parse_args(
        flags(commands.TRAIN_LM_CMD, "repro_torch.launch.train"))
    assert (args.arch, args.full_config, args.steps, args.batch,
            args.seq) == ("qwen2-0.5b", True, 4, 8, 128)


# ------------------------------------------------------------------ train
def test_train_lm_on_cpu_and_resume(tmp_path, capsys):
    argv = ["--arch", "qwen2-0.5b", "--steps", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "qwen2-0.5b (smoke config" in out and "loss" in out
    from repro_torch.train import checkpoint
    assert checkpoint.latest_step(tmp_path) == 3
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "restored from step 3" in out
    assert checkpoint.latest_step(tmp_path) == 6
    args = ttrain.build_parser().parse_args(["--arch", "deltakws"])
    assert args.ckpt_dir is None and args.batch == 8
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "no-such-arch"])


def test_train_step_reduces_loss_qwen_smoke():
    """A few AdamW steps on one repeated batch lower the loss (the
    reference's test_arch_smoke), bf16 smoke config."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train import optimizer as opt
    cfg = get_smoke_config("qwen2-0.5b")
    shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
    fn, _ = build_train_step(cfg, shape, Sharder(), opt_cfg=opt.AdamWConfig(
        lr=1e-2, warmup_steps=0, weight_decay=0.0, total_steps=1000))
    params, _ = get_api(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    state = opt.init(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    losses = []
    for _ in range(12):
        params, state, m = fn(params, state, {"tokens": toks,
                                              "labels": toks})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_adamw_on_a_mixed_dtype_moe_tree():
    """The MoE router and norm scales are f32, the rest bf16: one step
    keeps every leaf's dtype, the master copy and moments are f32 and
    mirror the nested tree, and ``opt_axes`` mirrors the axes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import Sharder, tree_leaves
    from repro_torch.train import optimizer as opt
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    fn, (p_specs, o_specs, _) = build_train_step(
        cfg, ShapeConfig("t", 16, 2, "train"), Sharder())
    params, axes = get_api(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert params["moe"]["router"].dtype == torch.float32
    assert params["moe"]["w_up"].dtype == torch.bfloat16
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    new, state, m = fn(params, opt.init(params),
                       {"tokens": toks, "labels": toks})
    assert _shape_tree(new) == _shape_tree(params) == _shape_tree(p_specs)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.master))
    assert _shape_tree(state.m) == _shape_tree(o_specs.m)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["moe_aux"]) > 0.5
    assert opt.opt_axes(axes).master is axes


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_cache_and_input_specs_equal_the_reference(arch):
    """The parameter tree (names, shapes, dtypes, logical axes), the cache
    and the step inputs of every arch, as ``meta`` tensors, equal the
    reference's shape structs; the analytic count is within the
    reference's own 2 % of the tree's size."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.configs.base import LM_SHAPES as JSHAPES
    from repro.launch import inputs as jinputs
    from repro.models import get_api as jget
    from repro.parallel.sharding import Sharder as JSharder
    from repro_torch.configs import LM_SHAPES, get_smoke_config
    from repro_torch.launch import costmodel, inputs, steps
    from repro_torch.models import get_api
    from repro_torch.parallel.sharding import Sharder, tree_leaves
    jcfg, tcfg = jsmoke(arch), get_smoke_config(arch)
    japi, tapi = jget(jcfg), get_api(tcfg, device="cpu")
    box = {}

    def initp(k):
        p, box["axes"] = japi.init(k)
        return p

    jshapes = jax.eval_shape(initp, jax.random.PRNGKey(0))
    tspecs, taxes = steps.param_specs(tcfg, Sharder())
    assert all(t.device.type == "meta" for t in tree_leaves(tspecs))
    assert _shape_tree(tspecs) == _shape_tree(jshapes)
    assert taxes == box["axes"]
    n = sum(int(np.prod(t.shape)) for t in tree_leaves(tspecs))
    assert abs(n - costmodel.param_count(tcfg)) / n < 0.02
    assert _shape_tree(tapi.cache_specs(2, 32)) == \
        _shape_tree(japi.cache_specs(2, 32))
    assert _shape_tree(tapi.init_cache(2, 32)) == \
        _shape_tree(japi.init_cache(2, 32))
    small = {k: dataclasses.replace(s, seq_len=2048, global_batch=2)
             for k, s in LM_SHAPES.items()}
    for name, shape in small.items():
        jshape = dataclasses.replace(JSHAPES[name], seq_len=2048,
                                     global_batch=2)
        for tf, jf in ((inputs.train_batch_specs,
                        jinputs.train_batch_specs),
                       (inputs.prefill_specs, jinputs.prefill_specs),
                       (inputs.decode_specs, jinputs.decode_specs)):
            assert _shape_tree(tf(tcfg, shape, Sharder())) == \
                _shape_tree(jf(jcfg, jshape, JSharder()))
        fn, specs = steps.build_step(tcfg, shape, Sharder())
        assert callable(fn) and len(specs) == 3
        if shape.kind != "train":
            assert _shape_tree(specs[1]) == \
                _shape_tree(tapi.cache_specs(2, 2048))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 16, 4, 3),
                                                  (256, 33, 2, 0),
                                                  (151936, 64, 8, 0)])
def test_synthetic_lm_batches_bit_equal(vocab, seq, batch, seed):
    from repro.data.lm_data import SyntheticLM as J
    from repro_torch.data.lm_data import SyntheticLM as T
    j, t = J(vocab, seq, batch, seed), T(vocab, seq, batch, seed)
    np.testing.assert_array_equal(t.succ, j.succ)
    for step in (0, 1, 11, 1000):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
