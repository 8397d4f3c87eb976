"""The port's LM layers against the JAX package's, float32, on the same
numpy inputs: norms, rope, attention in each mode, flash attention
forward and gradient, the MLP activations, the chunked cross-entropy,
MoE (routing decisions exactly, including a capacity drop), the SSD
scan, the Mamba decode (Δ-gated and dense) and ``delta_matmul``.

Tolerance: 1e-5 of the reference's max|·| for the forward values (the
libraries sum in different orders), 1e-4 for gradients; routing
decisions (expert indices, capacity slots, kept flags) are equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro_torch.models.layers as TL
from repro.configs import get_smoke_config as jsmoke
from repro.parallel.sharding import Sharder as JSharder
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.parallel.sharding import Sharder as TSharder

JSHD, TSHD = JSharder(mesh=None), TSharder(mesh=None)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4



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

def _close(got, want, tol=FWD_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _cfgs(arch, **kw):
    j = dataclasses.replace(jsmoke(arch), dtype=jnp.float32, **kw)
    t = dataclasses.replace(tsmoke(arch), dtype=torch.float32, **kw)
    return j, t


def _shapes(init, cfg):
    """The parameter shapes ``init`` builds (no draws)."""
    return jax.eval_shape(lambda k: init(k, cfg)[0], jax.random.PRNGKey(0))


def _rand_tree(rng, tree):
    """Random f32 values with the shapes of a JAX parameter tree."""
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if a.ndim else np.float32(rng.standard_normal()), tree)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("kind,bias", [("rmsnorm", False),
                                       ("layernorm", True)])
def test_norms(kind, bias):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(24).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(24).astype(np.float32)
    jp, tp = _both(p)
    _close(TL.apply_norm(tp, torch.from_numpy(x), kind),
           JL.apply_norm(jp, jnp.asarray(x), kind))


def test_rope_half_split_f32_angles():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.array([0, 1, 2, 100, 999, 4095, 32767])
    for theta in (1e4, 1e6):
        _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


# -------------------------------------------------------------- attention
def _attn_setup(rng, cfg_kw, arch="qwen2-0.5b"):
    jcfg, tcfg = _cfgs(arch, **cfg_kw)
    shapes = _shapes(JL.init_attention, jcfg)
    p = _rand_tree(rng, shapes)
    p["wo"] = p["wo"] * 0.5
    return jcfg, tcfg, *_both(p)


ATTN_MODES = {
    "causal": dict(kw={}, call={}),
    "window": dict(kw={}, call={"window": 3}),
    "gqa_bias_qknorm": dict(kw={"qkv_bias": True, "qk_norm": True},
                            call={}),
    "bidirectional": dict(kw={}, call={"causal": False}),
}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_modes(mode):
    rng = np.random.default_rng(2)
    spec = ATTN_MODES[mode]
    jcfg, tcfg, jp, tp = _attn_setup(rng, spec["kw"])
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    jo, _ = JL.apply_attention(jp, jcfg, jnp.asarray(x), JSHD,
                               positions=jnp.asarray(pos), **spec["call"])
    to, _ = TL.apply_attention(tp, tcfg, torch.from_numpy(x), TSHD,
                               positions=torch.from_numpy(pos),
                               **spec["call"])
    _close(to, jo)


def test_cross_attention():
    rng = np.random.default_rng(3)
    jcfg, tcfg, jp, tp = _attn_setup(rng, {"qkv_bias": True})
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    K, Dh = jcfg.n_kv_heads, jcfg.d_head
    k = rng.standard_normal((2, 11, K, Dh)).astype(np.float32)
    v = rng.standard_normal((2, 11, K, Dh)).astype(np.float32)
    jo, jc = JL.apply_attention(jp, jcfg, jnp.asarray(x), JSHD,
                                positions=jnp.arange(5),
                                cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    to, tc = TL.apply_attention(tp, tcfg, torch.from_numpy(x), TSHD,
                                positions=torch.arange(5),
                                cross_kv=(torch.from_numpy(k),
                                          torch.from_numpy(v)))
    assert jc is None and tc is None
    _close(to, jo)


@pytest.mark.parametrize("index,window", [(0, None), (5, None), (6, 3),
                                          (15, None), (40, None)])
def test_decode_against_a_cache_at_an_index(index, window):
    """One token against a cache at ``cache_index`` (written in place in
    the port; the write clamps so that it fits, as
    ``dynamic_update_slice_in_dim`` does: index 40 of a 16-slot cache
    writes slot 15), and a prefill that writes the cache but attends
    locally."""
    rng = np.random.default_rng(4)
    jcfg, tcfg, jp, tp = _attn_setup(rng, {"qk_norm": True,
                                           "qkv_bias": True})
    K, Dh = jcfg.n_kv_heads, jcfg.d_head
    ck = rng.standard_normal((2, 16, K, Dh)).astype(np.float32)
    cv = rng.standard_normal((2, 16, K, Dh)).astype(np.float32)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([index])
    jattend = jax.jit(lambda p, x, pos, ck, cv, i: JL.apply_attention(
        p, jcfg, x, JSHD, positions=pos, window=window, kv_cache=(ck, cv),
        cache_index=i))
    jo, (jk, jv) = jattend(jp, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(ck), jnp.asarray(cv), jnp.int32(index))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, (tk2, tv2) = TL.apply_attention(
        tp, tcfg, torch.from_numpy(x), TSHD, positions=torch.from_numpy(pos),
        window=window, kv_cache=(tk, tv), cache_index=index)
    _close(to, jo)
    _close(tk2, jk)
    _close(tv2, jv)
    assert tk2 is tk                       # written in place
    # prefill (S > 1) at index 0: writes the cache, attends locally
    xs = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    jo, (jk, _) = jattend(jp, jnp.asarray(xs), jnp.arange(6),
                          jnp.asarray(ck), jnp.asarray(cv), jnp.int32(0))
    to, (tk2, _) = TL.apply_attention(
        tp, tcfg, torch.from_numpy(xs), TSHD, positions=torch.arange(6),
        window=window, kv_cache=(torch.from_numpy(ck.copy()),
                                 torch.from_numpy(cv.copy())),
        cache_index=0)
    _close(to, jo)
    _close(tk2, jk)


# ---------------------------------------------------------------- flash
def _qkv(rng, B, S, T, K, G, Dh):
    return (rng.standard_normal((B, S, K, G, Dh)).astype(np.float32),
            rng.standard_normal((B, T, K, Dh)).astype(np.float32),
            rng.standard_normal((B, T, K, Dh)).astype(np.float32))


@pytest.mark.parametrize("S,win,static", [(128, None, False),
                                          (96, 700, False),
                                          (4096, None, True)])
def test_flash_attention_forward_and_gradient(S, win, static):
    """T = 4096 (the flash threshold): q-tiles over kv-chunks, the window
    mask across chunk edges, and the static causal diagonal (S = T)."""
    B, K, G, Dh, T = 1, 2, 2, 8, 4096
    if static:
        K, G = 1, 1
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, B, S, T, K, G, Dh)
    qpos = (np.arange(S) if static else T - S + np.arange(S)).astype(np.int32)
    w = JL.BIG_WINDOW if win is None else win

    def jf(q, k, v):
        out = JL.flash_attention(q, k, v, jnp.asarray(qpos),
                                 jnp.asarray(w, jnp.int32), True, static)
        return jnp.sum(jnp.tanh(out)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = TL.flash_attention(tq, tk, tv, torch.from_numpy(qpos).long(), w,
                              True, static)
    _close(tout, jout)
    torch.sum(torch.tanh(tout)).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, GRAD_TOL)


def test_attend_takes_flash_at_the_threshold():
    """``_attend`` at T ≥ FLASH_MIN_KV (a bidirectional encoder layer)
    and the direct path below it."""
    rng = np.random.default_rng(6)
    for T in (TL.FLASH_MIN_KV - 1024, TL.FLASH_MIN_KV):
        q, k, v = _qkv(rng, 1, 64, T, 1, 2, 8)
        jo = JL._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                        causal=False)
        to = TL._attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), None, causal=False)
        _close(to, jo)


# ------------------------------------------------------------------ mlp
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_activations(act):
    rng = np.random.default_rng(7)
    jcfg, tcfg = _cfgs("qwen2-0.5b", mlp_act=act)
    shapes = _shapes(JL.init_mlp, jcfg)
    jp, tp = _both(_rand_tree(rng, shapes))
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    _close(TL.apply_mlp(tp, tcfg, torch.from_numpy(x), TSHD),
           JL.apply_mlp(jp, jcfg, jnp.asarray(x), JSHD))


@pytest.mark.parametrize("S,n_chunks,vocab", [(24, 8, 200), (10, 8, 256),
                                              (7, 3, 256)])
def test_chunked_softmax_xent_and_its_gradient(S, n_chunks, vocab):
    """Chunked CE (padded-vocab mask, a chunk count that does not divide
    S) and its gradient through the per-chunk recomputation."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 256)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, S)).astype(np.int32)

    def jf(x, head):
        return JL.chunked_softmax_xent(x, head, jnp.asarray(labels), JSHD,
                                       n_chunks=n_chunks, vocab_size=vocab)

    jl, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    tl = TL.chunked_softmax_xent(tx, th, torch.from_numpy(labels), TSHD,
                                 n_chunks=n_chunks, vocab_size=vocab)
    _close(tl, jl)
    tl.backward()
    _close(tx.grad, jg[0], GRAD_TOL)
    _close(th.grad, jg[1], GRAD_TOL)


# ------------------------------------------------------------------ moe
@pytest.mark.parametrize("arch,B,S,cf", [
    ("qwen2-moe-a2.7b", 2, 16, 1.25), ("granite-moe-3b-a800m", 2, 24, 1.25),
    ("qwen2-moe-a2.7b", 2, 32, 0.1)], ids=["shared", "top2", "drops"])
def test_apply_moe_and_its_routing(arch, B, S, cf):
    """Output and aux loss within tolerance; the routing decisions —
    expert indices, capacity slots, kept flags — equal (``drops``: a
    capacity factor of 0.1 keeps 4 slots per expert, so tokens drop)."""
    import repro.models.moe as JM
    import repro_torch.models.moe as TM
    rng = np.random.default_rng(9)
    jcfg, tcfg = _cfgs(arch)
    shapes = _shapes(JM.init_moe, jcfg)
    jp, tp = _both(_rand_tree(rng, shapes))
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jo, ja = jax.jit(lambda p, x: JM.apply_moe(p, jcfg, x, JSHD,
                                                capacity_factor=cf))(
        jp, jnp.asarray(x))
    to, ta = TM.apply_moe(tp, tcfg, torch.from_numpy(x), TSHD,
                          capacity_factor=cf)
    _close(to, jo)
    _close(ta, ja)
    # the reference's routing, recomputed from its own expressions
    E, K = jcfg.n_experts, jcfg.top_k

    @jax.jit
    def routing(x, router):
        logits = jnp.einsum("bsd,de->bse", x, router)
        _, gi = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
        oh = jax.nn.one_hot(gi, E)
        flat = oh.reshape(B, S * K, E)
        return gi, jnp.sum((jnp.cumsum(flat, 1) - flat).reshape(B, S, K, E)
                           * oh, -1)

    gi, pos = routing(jnp.asarray(x), jp["router"])
    C = max(4, min(int(np.ceil(K * S * cf / E)), S))
    _, _, t_idx, _, t_pos, t_keep, t_C = TM.route(tp, tcfg,
                                                  torch.from_numpy(x), cf)
    assert t_C == C
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(gi))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(pos < C))
    if cf < 1:
        assert not t_keep.all()


# ---------------------------------------------------------------- mamba
@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 256), (40, 16)])
def test_ssd_chunked(S, chunk):
    from repro.models.mamba2 import ssd_chunked as jssd
    from repro_torch.models.mamba2 import ssd_chunked as tssd
    B, H, P, G, N = 2, 4, 8, 2, 16
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    jy, jh = jax.jit(functools.partial(jssd, chunk=chunk))(
        *map(jnp.asarray, (x, dt, a, Bm, Cm)))
    ty, th = tssd(*map(torch.from_numpy, (x, dt, a, Bm, Cm)), chunk=chunk)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("use_delta,th", [(True, 0.0), (True, 0.3),
                                          (False, 0.0)])
def test_mamba_decode_steps(use_delta, th):
    """Six recurrent steps of one block: the Δ-gated decode (threshold 0
    and 0.3, where channels hold) and the dense one; output, every cache
    slice and the transmit fraction."""
    import repro.models.mamba2 as JM
    import repro_torch.models.mamba2 as TM
    jcfg, tcfg = _cfgs("mamba2-370m", use_delta=use_delta,
                       delta_threshold=th)
    rng = np.random.default_rng(11)
    shapes = _shapes(JM.init_mamba_block, jcfg)
    p = _rand_tree(rng, shapes)
    p["a_log"] = p["a_log"] * 0.3
    jp, tp = _both(p)
    d_in, H, P, G, N, conv_dim, proj_dim = JM._dims(jcfg)
    B = 2
    z = np.zeros
    c0 = (z((B, jcfg.conv_kernel - 1, conv_dim), np.float32),
          z((B, H, P, N), np.float32), z((B, jcfg.d_model), np.float32),
          z((B, proj_dim), np.float32))
    jc = tuple(map(jnp.asarray, c0))
    tc = tuple(map(torch.from_numpy, c0))
    xs = (rng.standard_normal((6, B, jcfg.d_model)) * 0.5).astype(np.float32)
    jstep = jax.jit(lambda p, x, c: JM.apply_mamba_decode(p, jcfg, x, c,
                                                          JSHD))
    for t in range(6):
        jo, jc, jn = jstep(jp, jnp.asarray(xs[t]), jc)
        to, tc, tn = TM.apply_mamba_decode(tp, tcfg, torch.from_numpy(xs[t]),
                                           tc, TSHD)
        _close(to, jo)
        for a, b in zip(tc, jc):
            _close(a, b)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)


def test_delta_matmul():
    from repro.core.delta_dense import (delta_matmul as jdm,
                                        init_delta_stream as jinit)
    from repro_torch.core.delta_dense import (delta_matmul as tdm,
                                              init_delta_stream as tinit)
    rng = np.random.default_rng(12)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    js, ts = jinit((3,), 16, 24), tinit((3,), 16, 24)
    base = rng.standard_normal((3, 16)).astype(np.float32)
    for t in range(5):
        x = (base + 0.05 * rng.standard_normal((3, 16))).astype(np.float32)
        js, jy, jn = jdm(js, jnp.asarray(x), jnp.asarray(w), 0.04)
        ts, ty, tn = tdm(ts, torch.from_numpy(x), torch.from_numpy(w), 0.04)
        _close(ty, jy)
        np.testing.assert_array_equal(ts.x_hat.numpy(),
                                      np.asarray(js.x_hat))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
