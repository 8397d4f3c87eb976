"""The port's ten LM stacks against the JAX package's, at smoke width, on
the same weights (the reference's init, carried across by
``params_from_numpy``) and the same tokens.

Tolerances, relative to the reference's max|·|:
  * float32 (``dataclasses.replace(cfg, dtype=float32)`` on both sides):
    loss, prefill logits and one decode step's logits within 1e-4;
    gradients within 1e-4;
  * bfloat16 (the configs' own dtype): every bf16 einsum rounds in both
    packages but the libraries accumulate and fuse elementwise ops in
    different orders, so the loss is held to 1e-2 relative and the
    logits to 0.25 of max|·| (a wrong layer or head is off by O(1)).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jsmoke
from repro.models import get_api as jget
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models import get_api as tget
from repro_torch.models import params_from_numpy

F32_TOL = 1e-4
BF16_LOSS_TOL = 1e-2
BF16_LOGIT_TOL = 0.25
B, S, PREFILL, CACHE = 2, 16, 8, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}



@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA compiles the reference with most optimizations off (its compile
    time is most of this file's); the setting is restored, and JAX's
    caches cleared, when the module ends, so no later test reuses an
    executable compiled under it."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()

def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _cfgs(arch, dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jsmoke(arch), dtype=jd, **kw),
            dataclasses.replace(tsmoke(arch), dtype=td, **kw))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    emb = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
           .astype(np.float32) if cfg.frontend != "none" else None)
    return toks, emb


def _batches(toks, emb):
    jb = {"tokens": jnp.asarray(toks[:, :S]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :S]),
          "labels": torch.from_numpy(toks[:, 1:])}
    if emb is not None:
        jb["embeds"] = jnp.asarray(emb)
        tb["embeds"] = torch.from_numpy(emb)
    return jb, tb


def _reference_outputs(api, p, jb):
    """The reference's loss, prefill logits and one decode step's logits,
    traced as one function (one XLA compile per arch and dtype)."""
    loss, _ = api.loss(p, jb)
    cache, lp = api.prefill(p, jb["tokens"][:, :PREFILL],
                            api.init_cache(B, CACHE), jb.get("embeds"))
    ld, _ = api.decode_step(p, cache, jb["tokens"][:, PREFILL:PREFILL + 1])
    return loss, lp, ld


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's float32 weights (drawn once; the bf16
    model's are the same draws cast, as the reference's init casts them)
    and its loss / prefill / decode outputs in both dtypes."""
    memo = {}

    def get(arch):
        if arch in memo:
            return memo[arch]
        j32, _ = _cfgs(arch)
        p32 = jget(j32).init(jax.random.PRNGKey(0))[0]
        toks, emb = _inputs(j32)
        jb, _ = _batches(toks, emb)
        out = {"params": {}, "toks": toks, "emb": emb}
        for dtype in DTYPES:
            jcfg, _ = _cfgs(arch, dtype)
            api = jget(jcfg)
            shapes = jax.eval_shape(lambda k: api.init(k)[0],
                                    jax.random.PRNGKey(0))
            p = jax.tree.map(lambda a, s: a.astype(s.dtype), p32, shapes)
            loss, lp, ld = jax.jit(functools.partial(_reference_outputs,
                                                     api))(p, jb)
            out[dtype] = (float(loss), np.asarray(lp, np.float32),
                          np.asarray(ld, np.float32))
            out["params"][dtype] = jax.tree.map(np.asarray, p)
        memo[arch] = out
        return out

    return get


def _port_outputs(tcfg, params, toks, emb):
    api = tget(tcfg, device="cpu")
    _, tb = _batches(toks, emb)
    loss, _ = api.loss(params, tb)
    cache = api.init_cache(B, CACHE)
    cache, lp = api.prefill(params, tb["tokens"][:, :PREFILL], cache,
                            tb.get("embeds"))
    ld, _ = api.decode_step(params, cache,
                            tb["tokens"][:, PREFILL:PREFILL + 1])
    return float(loss), lp, ld


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_prefill_decode_against_the_reference(reference, arch, dtype):
    ref = reference(arch)
    _, tcfg = _cfgs(arch, dtype)
    params = params_from_numpy(ref["params"][dtype])
    want_dtypes = jax.tree.map(lambda a: a.dtype.name, ref["params"][dtype])
    got_dtypes = jax.tree.map(lambda t: str(t.dtype).split(".")[-1], params)
    assert got_dtypes == want_dtypes
    loss, lp, ld = _port_outputs(tcfg, params, ref["toks"], ref["emb"])
    jloss, jlp, jld = ref[dtype]
    assert lp.shape == (B, 1, tcfg.vocab_padded) == ld.shape
    if dtype == "float32":
        assert abs(loss - jloss) <= F32_TOL * abs(jloss)
        assert _rel(lp, jlp) <= F32_TOL and _rel(ld, jld) <= F32_TOL
    else:
        assert lp.dtype == torch.bfloat16 and np.isfinite(loss)
        assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss)
        assert _rel(lp, jlp) <= BF16_LOGIT_TOL
        assert _rel(ld, jld) <= BF16_LOGIT_TOL


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.grad`` of the reference's loss, once per arch: what a remat
    policy saves changes no gradient, so both of the port's policies are
    held to the reference's under its default (``full``) policy."""
    memo = {}

    def get(ref, arch):
        key = arch
        if key not in memo:
            jcfg, _ = _cfgs(arch)
            jb, _ = _batches(ref["toks"], ref["emb"])
            jp = jax.tree.map(jnp.asarray, ref["params"]["float32"])
            memo[key] = jax.jit(jax.value_and_grad(
                jget(jcfg).loss, has_aux=True))(jp, jb)
        return memo[key]

    return get


@pytest.mark.parametrize("policy", ["full", "save_mlp"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_gradients_against_jax_grad(reference, jax_grads, arch, policy):
    """Autograd through the per-layer remat (both policies: ``save_mlp``
    keeps the MLP up/gate products) against ``jax.grad``, float32."""
    ref = reference(arch)
    _, tcfg = _cfgs(arch, remat_policy=policy)
    _, tb = _batches(ref["toks"], ref["emb"])
    (jl, _), jg = jax_grads(ref, arch)
    params = params_from_numpy(ref["params"]["float32"])
    leaves = jax.tree.map(lambda t: t.requires_grad_(True), params)
    loss, _ = tget(tcfg, device="cpu").loss(leaves, tb)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= F32_TOL * abs(float(jl))
    flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.grad, leaves))
    flat_j = jax.tree.leaves(jg)
    assert len(flat_t) == len(flat_j)
    for got, want in zip(flat_t, flat_j):
        assert _rel(got, want) <= F32_TOL


def test_save_mlp_keeps_the_mlp_products_and_equals_full_remat():
    """The two policies give the same gradients bit for bit, and the
    backward pass under ``save_mlp`` recomputes two matmuls fewer per
    layer (the MLP up and gate products it kept)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, tcfg = _cfgs("qwen2-0.5b")
    params, _ = tget(tcfg, device="cpu").init(torch.Generator().manual_seed(3))
    toks, _ = _inputs(tcfg, seed=4)
    _, tb = _batches(toks, None)
    grads, backward_mms = {}, {}
    for policy in ("full", "save_mlp"):
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        leaves = jax.tree.map(lambda t: t.detach().clone().requires_grad_(),
                              params)
        loss, _ = tget(cfg, device="cpu").loss(leaves, tb)
        with CountMatmuls() as counter:
            loss.backward()
        backward_mms[policy] = counter.n
        grads[policy] = jax.tree.map(lambda t: t.grad, leaves)
    for a, b in zip(jax.tree.leaves(grads["full"]),
                    jax.tree.leaves(grads["save_mlp"])):
        assert torch.equal(a, b)
    assert backward_mms["full"] - backward_mms["save_mlp"] == \
        2 * tcfg.num_layers, backward_mms


def test_three_adamw_steps_microbatched_and_against_jax(reference):
    """``build_train_step``: three AdamW steps with microbatches 1 and 2
    (float32 accumulation) agree, and with the reference's own three
    steps (float32 weights).  eps = 1e-3: with the default 1e-8 Adam
    turns a gradient that is rounding noise into a full ±lr step, and the
    two summation orders disagree on its sign."""
    from repro.launch.steps import build_train_step as jbuild
    from repro.configs.base import ShapeConfig as JShape
    from repro.parallel.sharding import Sharder as JSharder
    from repro.train import optimizer as jopt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train import optimizer as topt
    ref = reference("qwen2-0.5b")
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    shape = ShapeConfig("t", seq_len=S, global_batch=B * 2, kind="train")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (3, B * 2, S + 1)).astype(
        np.int32)
    runs = {}
    for mb in (1, 2):
        fn, (p_specs, o_specs, b_specs) = build_train_step(
            tcfg, shape, Sharder(), topt.AdamWConfig(**kw), microbatches=mb)
        assert b_specs["tokens"].shape == (B * 2, S)
        assert b_specs["tokens"].device.type == "meta"
        params = params_from_numpy(ref["params"]["float32"])
        state = topt.init(params)
        losses = []
        for t in range(3):
            params, state, m = fn(params, state, {
                "tokens": torch.from_numpy(toks[t, :, :S]),
                "labels": torch.from_numpy(toks[t, :, 1:])})
            losses.append(float(m["loss"]))
            if t == 0:
                first = params
        runs[mb] = (losses, params, first)
    jfn, _ = jbuild(jcfg, JShape("t", S, B * 2, "train"), JSharder(),
                    opt_cfg=jopt.AdamWConfig(**kw))
    jp = jax.tree.map(jnp.asarray, ref["params"]["float32"])
    js = jopt.init(jp)
    jlosses = []
    for t in range(3):
        jp, js, m = jfn(jp, js, {"tokens": jnp.asarray(toks[t, :, :S]),
                                 "labels": jnp.asarray(toks[t, :, 1:])})
        jlosses.append(float(m["loss"]))
        if t == 0:                 # the next call donates jp's buffers
            jfirst = jax.tree.map(np.asarray, jp)
    np.testing.assert_allclose(runs[1][0], jlosses, rtol=F32_TOL)
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=F32_TOL)
    for a, b in zip(jax.tree.leaves(runs[1][1]), jax.tree.leaves(runs[2][1])):
        assert _rel(b, a.numpy()) <= F32_TOL
    # after one step: every leaf (later steps compound the rounding of the
    # near-zero q/k/v-bias gradients through Adam's normalisation)
    for a, c in zip(jax.tree.leaves(runs[1][2]), jax.tree.leaves(jfirst)):
        assert _rel(a, c) <= F32_TOL


def test_delta_decode_at_threshold_zero_equals_the_dense_decode():
    """mamba2 smoke, float32: the Δ-gated decode at threshold 0 against
    the dense decode (use_delta=False) over 8 tokens, to the reference's
    own 1e-5 (the accumulator M_t = Σ Δx·W rounds unlike x·W)."""
    _, cfg = _cfgs("mamba2-370m", use_delta=True, delta_threshold=0.0)
    dense = dataclasses.replace(cfg, use_delta=False)
    params, _ = tget(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_inputs(cfg, seed=6)[0])
    apis = [tget(c, device="cpu") for c in (cfg, dense)]
    caches = [a.init_cache(B, CACHE) for a in apis]
    for t in range(8):
        outs = []
        for i, a in enumerate(apis):
            lg, caches[i] = a.decode_step(params, caches[i], toks[:, t:t + 1])
            outs.append(lg)
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert caches[0].m_acc.abs().max() > 0 and caches[1].m_acc.abs().max() == 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_prefill_then_decode_consistency(arch):
    """prefill(t0..tn) then decode(t_{n+1}) ≈ prefill(t0..t_{n+1}), at the
    reference's rtol = atol = 0.15 in bf16, on its four archs (its
    test_arch_smoke; the MoE stacks' gap is held to the reference's
    below)."""
    cfg = tsmoke(arch)
    api = tget(cfg, device="cpu")
    params, _ = api.init(torch.Generator().manual_seed(0))
    toks, emb = _inputs(cfg, seed=7)
    toks = torch.from_numpy(toks)
    emb = torch.from_numpy(emb) if emb is not None else None
    cache, _ = api.prefill(params, toks[:, :S], api.init_cache(B, 64), emb)
    step, _ = api.decode_step(params, cache, toks[:, S:S + 1])
    _, full = api.prefill(params, toks, api.init_cache(B, 64), emb)
    np.testing.assert_allclose(step.float().numpy().squeeze(),
                               full.float().numpy().squeeze(),
                               rtol=0.15, atol=0.15)


def _gap(api, params, toks, as_tokens):
    """Prefill-then-decode logits minus the longer prefill's."""
    cache, _ = api.prefill(params, as_tokens(toks[:, :PREFILL]),
                           api.init_cache(B, CACHE))
    step, _ = api.decode_step(params, cache,
                              as_tokens(toks[:, PREFILL:PREFILL + 1]))
    _, full = api.prefill(params, as_tokens(toks[:, :PREFILL + 1]),
                          api.init_cache(B, CACHE))
    return step - full


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_moe_default_capacity_gap_is_the_references(reference, arch):
    """At the reference's capacity factor 1.25 a 9-token prefill keeps
    other (token, expert) pairs than an 8-token one, so prefill-then-
    decode departs from the longer prefill — in both packages alike."""
    ref = reference(arch)
    jcfg, tcfg = _cfgs(arch)
    japi, tapi = jget(jcfg), tget(tcfg, device="cpu")
    jgap = np.asarray(jax.jit(lambda p, t: _gap(japi, p, t, lambda a: a))(
        jax.tree.map(jnp.asarray, ref["params"]["float32"]),
        jnp.asarray(ref["toks"])))
    tgap = _gap(tapi, params_from_numpy(ref["params"]["float32"]),
                ref["toks"], torch.from_numpy).numpy()
    assert np.abs(jgap).max() > 0.15
    assert _rel(tgap, jgap) <= F32_TOL
