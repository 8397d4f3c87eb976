"""Port conformance, gradients: the port's autograd against ``jax.grad``.

1. The differentiable exact math (``kernels.xla_math``): the forwards of
   ``xla_sigmoid``, ``xla_tanh`` and ``fma`` are the exact expansions bit
   for bit, and their backwards are JAX's derivative rules as ``jax.grad``
   evaluates them under jit — bit for bit too (tolerance 0), over random
   inputs, the clamp regions, |x| < 0.0004 and saturation.
2. The training losses: the gradients of ``kws.loss_fn`` and
   ``kws.frame_loss_fn`` (``frame_ce`` and ``maxpool``, smear 0 and 2),
   float and QAT, at Δ_TH 0 and 0.1, on the same numpy weights and
   features (I = 10, H = 16, K = 12, B = 4, F = 16).  The per-frame
   transmit counts must be equal first; then every gradient lies within
   GRAD_RTOL × max|g| of JAX's, leaf by leaf (measured: ≤ 3e-7 — the
   backward sums weight gradients over frames and batch in another order
   than XLA's scan, and the FC and mean-pool sums differ by ulps).
3. The kernels have no backward: every kernel path refuses an input that
   needs a gradient, and QAT refuses every backend but "xla".
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.core import quantize as jquantize
from repro.models import kws as jkws
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.core import delta_gru as tdg
from repro_torch.core import fixed_point as tfp
from repro_torch.core import quantize as tquantize
from repro_torch.kernels import xla_math as xm
from repro_torch.kernels.delta_matvec import delta_matvec
from repro_torch.models import kws as tkws
from test_torch_xla_math import xla_fma  # noqa: F401  (a fixture)

I, H, K, B, F = 10, 16, 12, 4, 16
GRAD_RTOL = 2e-6
LOSSES = {"utterance": None, "frame_ce": ("frame_ce", 0),
          "frame_ce_smear2": ("frame_ce", 2), "maxpool": ("maxpool", 0),
          "maxpool_smear2": ("maxpool", 2)}


def _bits_differ(port: torch.Tensor, ref) -> int:
    p, r = port.detach().numpy(), np.asarray(ref)
    return int(np.count_nonzero(p.view(np.uint32) != r.view(np.uint32)))


# ------------------------------------------------- the differentiable math
def _math_inputs():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0.0, 4.0, 20_000), rng.uniform(-30.0, 30.0, 5_000),
        rng.uniform(-4e-4, 4e-4, 1_000),                 # tanh(x) = x
        [7.998811, -7.998811, 8.0, 8.5, -9.0,            # tanh's clamp
         19.999998, 20.0, -20.0, 25.0, 0.00039999998, 0.0004, 0.0, -0.0,
         -87.9, 88.9, 1e-40]]).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g


@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_unary_forward_and_backward_bit_exact(xla_fma, name):
    """Forward bit for bit the exact expansion (and XLA's); the gradient
    for a random cotangent bit for bit ``jax.vjp`` of the jitted
    function."""
    port, exact, ref = {
        "sigmoid": (xm.xla_sigmoid, xm._sigmoid, jax.nn.sigmoid),
        "tanh": (xm.xla_tanh, xm._tanh, jnp.tanh)}[name]
    x, g = _math_inputs()
    xt = torch.tensor(x, requires_grad=True)
    y = port(xt)
    assert y.requires_grad
    y.backward(torch.tensor(g))
    want_y, vjp = jax.vjp(jax.jit(ref), jnp.asarray(x))
    assert _bits_differ(y, exact(torch.tensor(x))) == 0
    assert _bits_differ(y, want_y) == 0
    assert _bits_differ(xt.grad, vjp(jnp.asarray(g))[0]) == 0


def test_tanh_gradient_regression(xla_fma):
    """The case that exposed the fault: before, xla_tanh's gradient flowed
    only through its clamp and division (0.592, 0.972, … here); now it is
    1 − tanh² as ``jax.grad`` computes it."""
    torch.manual_seed(0)
    x = torch.randn(6, requires_grad=True)
    xm.xla_tanh(x).sum().backward()
    want = jax.jit(jax.vmap(jax.grad(jnp.tanh)))(jnp.asarray(x.detach()))
    assert _bits_differ(x.grad, want) == 0
    np.testing.assert_allclose(x.grad.numpy(),
                               1 - np.tanh(x.detach().numpy()) ** 2,
                               rtol=1e-5)


@pytest.mark.parametrize("scalar_b", [False, True])
def test_fma_forward_and_backward(xla_fma, scalar_b):
    """fma: the fused forward bit for bit, gradients (g·b, g·a, g); a
    Python-float operand gets none, and without a gradient the result is
    the plain exact evaluation."""
    rng = np.random.default_rng(1)
    a, b, c, g = (rng.standard_normal(4096).astype(np.float32)
                  for _ in range(4))
    if scalar_b:
        b = np.float32(0.37)
    ta, tc = (torch.tensor(v, requires_grad=True) for v in (a, c))
    tb = float(b) if scalar_b else torch.tensor(b, requires_grad=True)
    y = xm.fma(ta, tb, tc)
    y.backward(torch.tensor(g))
    f = jax.jit(lambda a, b, c: a * b + c)
    want, vjp = jax.vjp(f, a, np.broadcast_to(b, a.shape).copy(), c)
    ga, gb, gc = vjp(jnp.asarray(g))
    assert _bits_differ(y, want) == 0
    assert _bits_differ(ta.grad, ga) == 0 and _bits_differ(tc.grad, gc) == 0
    if not scalar_b:
        assert _bits_differ(tb.grad, gb) == 0
    plain = xm.fma(torch.tensor(a), float(b) if scalar_b else torch.tensor(b),
                   torch.tensor(c))
    assert not plain.requires_grad and _bits_differ(plain, want) == 0


# ----------------------------------------------------- the losses' gradients
@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(0)
    jp, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=I)
    w = {k: np.asarray(v) for k, v in jp.items()}
    w["b"] = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    feats = np.round(np.cumsum(0.2 * rng.standard_normal((B, F, I)), 1)
                     * 2048) / 2048                     # the 12-bit grid
    labels = rng.integers(0, K, B).astype(np.int32)
    frame_labels = np.zeros((B, F), np.int32)
    for b in range(B):                                  # one event per row
        s = rng.integers(0, F - 6)
        frame_labels[b, s:s + 5] = rng.integers(2, K)
    return w, feats.astype(np.float32), labels, frame_labels


def _loss(pkg, which, qat):
    """(loss(params, th) → (value, aux), the batch) of one package."""
    w, feats, labels, frame_labels = _data()
    kws, cfg, arr = ((jkws, J_SMOKE, jnp.asarray) if pkg == "jax"
                     else (tkws, T_SMOKE, torch.tensor))
    mode = LOSSES[which]
    if mode is None:
        batch = {"feats": arr(feats), "labels": arr(labels)}
        return lambda p, th: kws.loss_fn(p, cfg, batch, th, qat=qat)
    batch = {"feats": arr(feats), "frame_labels": arr(frame_labels)}
    return lambda p, th: kws.frame_loss_fn(
        p, cfg, batch, th, qat=qat, loss_mode=mode[0], smear_frames=mode[1])


@functools.lru_cache(maxsize=None)
def _jax_fn(which, qat):
    """Jitted once per (loss, qat) with Δ_TH traced: the value, the
    gradient and the forward's transmit counts."""
    feats = _data()[1]
    loss = _loss("jax", which, qat)

    def fn(p, th):
        (value, _), grads = jax.value_and_grad(loss, has_aux=True)(p, th)
        _, stats = jkws.forward(p, J_SMOKE, feats, th, qat=qat)
        return value, grads, stats.nz_dx, stats.nz_dh
    return jax.jit(fn)


@pytest.mark.parametrize("th", [0.0, 0.1])
@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
@pytest.mark.parametrize("which", list(LOSSES))
def test_loss_gradients_match_jax_grad(which, qat, th):
    w, feats = _data()[:2]
    j_value, j_grads, j_nzx, j_nzh = _jax_fn(which, qat)(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.float32(th))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    with torch.no_grad():
        _, stats = tkws.forward(p, T_SMOKE, torch.tensor(feats), th, qat=qat)
    np.testing.assert_array_equal(stats.nz_dx.numpy(), np.asarray(j_nzx))
    np.testing.assert_array_equal(stats.nz_dh.numpy(), np.asarray(j_nzh))
    if th > 0:
        assert stats.nz_dh.sum() < F * B * H        # the threshold skips
    value, aux = _loss("torch", which, qat)(p, th)
    grads = torch.autograd.grad(value, list(p.values()))
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-6)
    rel = {}
    for k, g in zip(p, grads):
        want = np.asarray(j_grads[k])
        assert np.any(want != 0), k                  # every leaf trains
        rel[k] = float(np.abs(g.numpy() - want).max() / np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=k)
    print(f"max |Δg| / max |g|: {max(rel.values()):.2e}")   # pytest -s


def test_qat_weights_on_the_int8_grid():
    """The STE weights are Q0.7 codes times the reference's power-of-two
    scale, with an identity gradient; at a power of two max|w| the scale
    is that power (XLA's log2 gives the integer exactly).  The host-side
    ``quantize_weights_8b`` equals the reference's too."""
    w = _data()[0]
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    p["w_h"] = torch.tensor(w["w_h"] * 0.5 / np.abs(w["w_h"]).max(),
                            requires_grad=True)   # max|w_h| = 0.5 exactly
    gru = tkws._gru_params(p, quantize_8b=True)
    j = jkws._gru_params({k: jnp.asarray(v.detach().numpy())
                          for k, v in p.items()}, True)
    assert _bits_differ(gru.w_x, j.w_x) == 0
    assert _bits_differ(gru.w_h, j.w_h) == 0
    assert float(tkws._weight_scale(p["w_h"])) == 0.5
    codes = gru.w_h.detach().numpy() / 0.5 * 128
    np.testing.assert_array_equal(codes, np.round(codes))
    gru.w_x.sum().backward()
    np.testing.assert_array_equal(p["w_x"].grad.numpy(), 1.0)
    for v in (w["w_x"], w["w_h"] * 0.5 / np.abs(w["w_h"]).max()):
        got, scale = tquantize.quantize_weights_8b(torch.tensor(v))
        want, jscale = jquantize.quantize_weights_8b(jnp.asarray(v))
        assert scale == jscale
        assert _bits_differ(got, want) == 0


# ----------------------------------------------- kernels refuse a gradient
def test_kernels_refuse_inputs_that_need_a_gradient():
    w, feats = _data()[:2]
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    gru = tdg.DeltaGRUParams(p["w_x"], p["w_h"], p["b"])
    xs = torch.tensor(feats).movedim(1, 0).contiguous()
    for kw in ({}, {"smem_budget_bytes": 0}, {"event_driven": True}):
        with pytest.raises(ValueError, match="no backward"):
            tdg.delta_gru_scan(gru, xs, 0.1, backend="pallas", **kw)
    state = tdg.init_delta_state(B, I, H, gru)
    with pytest.raises(ValueError, match="no backward"):
        tdg.masked_delta_gru_scan(gru, xs, 0.1, state,
                                  torch.ones((F, B), dtype=torch.bool))
    with pytest.raises(ValueError, match="no backward"):
        delta_matvec(xs[0], p["w_x"], torch.zeros(B, 3 * H),
                     torch.ones(1, dtype=torch.int32), block_i=I,
                     block_o=3 * H)
    bundle = tfp.promote_kws({k: v.detach() for k, v in p.items()}, 0.1)
    with pytest.raises(ValueError, match="no backward"):
        tfp.int_forward(bundle, torch.tensor(feats, requires_grad=True))
    with pytest.raises(ValueError, match="QAT"):
        tkws.forward(p, T_SMOKE, torch.tensor(feats), 0.1, qat=True,
                     backend="pallas")
    with pytest.raises(ValueError, match="QAT"):
        tdg.delta_gru_scan(gru, xs, 0.1, backend="xla", event_driven=True,
                           h_qformat=tkws.QAT_H_FORMAT)
    # Under no_grad the kernel path serves the same weights.
    with torch.no_grad():
        hs, _, _ = tdg.delta_gru_scan(gru, xs, 0.1, backend="pallas")
    assert not hs.requires_grad
    hs_x, _, _ = tdg.delta_gru_scan(gru, xs, 0.1, backend="xla")
    assert hs_x.requires_grad
    assert torch.equal(hs, hs_x.detach())
