"""The LM mesh on 4 gloo ranks against the JAX package run unsharded.

One spawned 4-rank group (``launch.mesh.run_ranks``: gloo, a ``file://``
store in ``tmp_path``, one thread a rank) runs every case of this module
on the port; the parent computes the JAX references first with
``Sharder(mesh=None)`` (GSPMD placement does not change the math, so no
virtual devices are needed) and hands the ranks the reference's weights.

zamba2 smoke float32 runs the same steps on ``(2, 2)``: its Mamba2
projection's columns split over 'model' at offsets inside the shards,
and its shared attention's cache is split on the sequence.

The reference's three ``tests/test_distributed.py`` cases run at 4 ranks
instead of its 8 virtual devices: the sharded equivalence on ``(2, 2)``
(its ``(4, 2)``), the elastic restore ``(4,)`` → ``(2, 2)`` (its ``(8,)``
→ ``(4, 2)``) and the multi-pod collectives on ``(1, 2, 2)`` (its
``(2, 2, 2)``; the spec ``P(("pod", "data"), "model")`` resolves the
same).  Tolerances: bf16 at the reference's bounds (loss within 0.05,
≥ 97 % of the first leaf within 0.05); float32 losses at each step
within 1e-4 relative; decode logits within 1e-4 of max|·|.  The same
bounds hold qwen2-0.5b smoke with fewer heads or KV heads than a 4-wide
'model' axis, on (1, 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_mesh as H

F32_TOL = 1e-4


def _jax_cfg(arch, dtype):
    import dataclasses
    from repro.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def _jax_train(cfg, params, tokens, opt_kw):
    from repro.configs.base import ShapeConfig
    from repro.launch.steps import build_train_step
    from repro.parallel.sharding import Sharder
    from repro.train import optimizer as opt
    fn, _ = build_train_step(cfg, ShapeConfig("t", H.S, H.B, "train"),
                             Sharder(), opt_cfg=opt.AdamWConfig(**opt_kw))
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    batch = {"tokens": jnp.asarray(tokens[:, :H.S]),
             "labels": jnp.asarray(tokens[:, 1:])}
    losses = []
    for _ in range(3):
        p, state, m = fn(p, state, batch)
        losses.append(float(m["loss"]))
    return losses, [np.asarray(x, np.float32) for x in jax.tree.leaves(p)]


def _jax_decode(cfg, params, tokens):
    from repro.models import get_api
    from repro.parallel.sharding import Sharder
    api = get_api(cfg, Sharder())
    p = jax.tree.map(jnp.asarray, params)
    tok = jnp.asarray(tokens)
    cache, lp = jax.jit(api.prefill)(p, tok[:, :H.PREFILL],
                                     api.init_cache(H.B, H.CACHE))
    out = [np.asarray(lp, np.float32)]
    step = jax.jit(api.decode_step)
    for t in range(H.PREFILL, H.PREFILL + H.DECODE_STEPS):
        lg, cache = step(p, cache, tok[:, t:t + 1])
        out.append(np.asarray(lg, np.float32))
    return out


def _jax_multipod_grad():
    def loss(w, x):
        return jnp.sum(jnp.tanh(x @ w) ** 2)
    g = jax.jit(jax.grad(loss))(jnp.ones((16, 16), jnp.bfloat16),
                                jnp.ones((8, 16), jnp.bfloat16))
    return np.asarray(g, np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX references, each rank's results)."""
    from repro.models import get_api
    from repro.parallel.sharding import Sharder
    from repro_torch.launch.mesh import run_ranks
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        cfg16 = _jax_cfg("qwen2-0.5b", jnp.bfloat16)
        cfg32 = _jax_cfg("qwen2-0.5b", jnp.float32)
        key = jax.random.PRNGKey(0)
        p16 = jax.tree.map(np.asarray, get_api(cfg16, Sharder()).init(key)[0])
        p32 = jax.tree.map(np.asarray, get_api(cfg32, Sharder()).init(key)[0])
        tokens = H.np_tokens(cfg16.vocab_size, 0)
        cfgz = _jax_cfg("zamba2-2.7b", jnp.float32)
        pz = jax.tree.map(np.asarray, get_api(cfgz, Sharder()).init(key)[0])
        cfgg = _jax_cfg("gemma3-4b", jnp.float32)
        pg = jax.tree.map(np.asarray, get_api(cfgg, Sharder()).init(key)[0])
        ref = {"bf16": _jax_train(cfg16, p16, tokens, H.OPT),
               "f32": _jax_train(cfg32, p32, tokens, H.OPT_F32),
               "decode": _jax_decode(cfg32, p32, tokens),
               "zamba2": (_jax_train(cfgz, pz, tokens, H.OPT_F32)[0],
                          _jax_decode(cfgz, pz, tokens)),
               "gemma3": _jax_decode(cfgg, pg, tokens),
               "multipod": _jax_multipod_grad()}
        few = {}
        for name, kw in H.FEW_HEADS.items():
            cfg = dataclasses.replace(cfg32, **kw)
            few[name] = jax.tree.map(np.asarray,
                                     get_api(cfg, Sharder()).init(key)[0])
            ref[f"few_heads_{name}"] = (
                _jax_train(cfg, few[name], tokens, H.OPT_F32)[0],
                _jax_decode(cfg, few[name], tokens))
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
        jax.clear_caches()
    tmp = tmp_path_factory.mktemp("lm_mesh_ranks")
    ranks = run_ranks(H.qwen2_rank, 4, {"params_bf16": p16,
                                        "params_f32": p32,
                                        "params_zamba2": pz,
                                        "params_gemma3": pg,
                                        "tokens": tokens,
                                        "few_heads": few},
                      str(tmp / "ckpt"), device="cpu", workdir=tmp)
    return ref, ranks


def test_sharded_equivalence_bf16(runs):
    """The reference's SHARDED_EQUIV: 3 AdamW steps of qwen2-0.5b smoke
    sharded on (2, 2) against unsharded, at its bounds."""
    ref, ranks = runs
    jl, jleaves = ref["bf16"]
    for r in ranks:
        losses, leaf = r["bf16"]
        assert abs(losses[-1] - jl[-1]) < 0.05, (losses, jl)
        assert np.mean(np.abs(leaf - jleaves[0]) < 0.05) > 0.97
    assert ranks[0]["bf16"][0] == ranks[3]["bf16"][0]


def test_float32_steps_against_jax(runs):
    """float32: the loss at every step within 1e-4 relative; the largest
    parameter gap printed; the optimizer's master keeps the params'
    placements."""
    ref, ranks = runs
    jl, jleaves = ref["f32"]
    losses, leaves = ranks[0]["f32"]
    np.testing.assert_allclose(losses, jl, rtol=F32_TOL)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(leaves, jleaves))
    print(f"largest float32 parameter gap after 3 steps: {gap:.3e}")
    assert all(r["placements_kept"] for r in ranks)


def test_microbatched_step_on_a_batch_sharded_batch(runs):
    """One step in two microbatches (rows [0, B/2) and [B/2, B), the
    reference's grouping, re-placed on the batch axis): its loss is the
    whole batch's first loss, and the params keep their placements."""
    ref, ranks = runs
    losses, placements = ranks[0]["f32_microbatched"]
    np.testing.assert_allclose(losses, ref["f32"][0][:1], rtol=F32_TOL)
    assert placements == tuple(ranks[0]["f32_first_leaf_placements"])


def test_decode_under_decode_rules(runs):
    """Prefill + 4 decode steps with build_serve_step's DECODE_RULES,
    float32 logits within 1e-4 of max|·|; the cache sharded on the
    batch ('data') and its sequence ('model'), so each decode step
    attends the cache where it lies and combines the ranks' softmax
    partials."""
    ref, ranks = runs
    for got, want in zip(ranks[0]["decode"], ref["decode"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    spec, placements = ranks[0]["cache_sharding"]
    assert spec == "PartitionSpec(None, 'data', 'model', None, None)"
    assert placements == "(Shard(dim=1), Shard(dim=2))"


def test_zamba2_split_projection_and_split_cache(runs):
    """zamba2 smoke float32 on (2, 2): the Mamba2 projection's columns
    split over 'model' at offsets inside the shards (each part its own
    product, no gather of the projection), the shared attention's cache
    split on its sequence; 3 AdamW steps within 1e-4 relative and the
    prefill and 4 decode steps' logits within 1e-4 of max|·| of JAX's,
    unsharded."""
    ref, ranks = runs
    want_losses, want_logits = ref["zamba2"]
    for r in ranks:
        losses, logits, w_in, cache_k = r["zamba2"]
        np.testing.assert_allclose(losses, want_losses, rtol=F32_TOL)
        for got, want in zip(logits, want_logits):
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
        assert w_in == "(Shard(dim=1), Shard(dim=2))"       # data, model
        assert cache_k == "(Shard(dim=1), Shard(dim=2))"    # batch, seq


def test_window_decode_on_the_sequence_split_cache(runs):
    """gemma3 smoke float32 on (2, 2): its local layers' window of 8
    starts inside the first 'model' rank's block of the sequence-split
    cache, so each rank scores only the positions the window and the
    causal mask let a query see; the prefill and 4 decode steps' logits
    within 1e-4 of max|·| of JAX's, unsharded."""
    ref, ranks = runs
    for got, want in zip(ranks[0]["gemma3"], ref["gemma3"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(H.FEW_HEADS))
def test_heads_fewer_than_the_model_axis(runs, name):
    """qwen2-0.5b smoke on (1, 4) with 2 heads over 1 KV head (no head
    split) and with its 4 heads over 2 KV heads (a head split the KV heads
    do not divide): float32 losses of 3 steps within 1e-4 relative and
    decode logits within 1e-4 of max|·| of JAX's, unsharded."""
    ref, ranks = runs
    want_losses, want_logits = ref[f"few_heads_{name}"]
    for r in ranks:
        losses, logits = r[f"few_heads_{name}"]
        np.testing.assert_allclose(losses, want_losses, rtol=F32_TOL)
        for got, want in zip(logits, want_logits):
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def test_elastic_restore_onto_another_mesh(runs):
    """The reference's ELASTIC_RESHARD: saved from (4,), restored onto
    (2, 2) P("data", "model"), equal and placed; meta.json names the
    saving mesh."""
    _, ranks = runs
    for r in ranks:
        equal, placed, mesh = r["elastic"]
        assert equal and placed
        assert mesh == {"shape": [4], "axes": ["data"]}


def test_multipod_spec_and_gradient_collectives(runs):
    """The reference's MULTIPOD_COLLECTIVES on (1, 2, 2): the spec, and
    the gradient of sum(tanh(x @ w)²) issues an all-reduce or a
    reduce-scatter and equals JAX's."""
    from repro_torch.parallel.sharding import P
    ref, ranks = runs
    spec, counts, g = ranks[0]["multipod"]
    assert spec == P(("pod", "data"), "model")
    assert counts.get("all_reduce", 0) + counts.get(
        "reduce_scatter_tensor", 0) > 0, counts
    np.testing.assert_array_equal(g, ref["multipod"])
