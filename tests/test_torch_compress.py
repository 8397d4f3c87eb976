"""Port conformance, top-k gradient compression with error feedback:
``repro_torch.train.compress`` against ``repro.train.compress`` on seeded
numpy trees, three rounds with the residual carried, and the reference's
own two cases (``tests/test_train_infra.py``).

Tolerance: none — the sent gradients and the residuals bit for bit, the
density and the wire ratio equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as jc
from repro_torch.train import compress as tc


def _tree(rng, scale):
    # Keys out of sorted order: the density sums its leaves in the
    # reference's (a JAX pytree's, sorted) order.
    return {"w": (scale * rng.standard_normal((32, 32))).astype(np.float32),
            "b": rng.standard_normal(1000).astype(np.float32),
            "ln": {"s": rng.standard_normal((7, 3)).astype(np.float32),
                   "a": np.round(rng.standard_normal(64)).astype(np.float32)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("frac", [0.01, 0.05])
def test_compress_matches_jax_over_three_rounds(frac):
    rng = np.random.default_rng(0)
    shapes = _tree(rng, 1.0)
    js = jc.init_state(_map(jnp.asarray, shapes))
    ts = tc.init_state(_map(torch.from_numpy, shapes))
    for r in range(3):
        g = _tree(rng, float(r + 1))           # the "a" leaf has ties
        jsent, js, jm = jc.compress(_map(jnp.asarray, g), js, frac)
        tsent, ts, tm = tc.compress(_map(torch.from_numpy, g), ts, frac)
        for want, got in ((jsent, tsent), (js.residual, ts.residual)):
            for a, b in zip(_leaves(want), _leaves(got)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert tm["density"].dtype == torch.float32
        assert tm["density"].item() == float(np.float32(jm["density"]))
        assert tm["wire_ratio"] == jm["wire_ratio"]
        kept = sum(int((x != 0).sum()) for x in _leaves(tsent))
        assert kept >= sum(max(1, int(x.size * frac)) for x in _leaves(g))


def test_compression_error_feedback_unbiased():
    """The reference's case: over many steps sum(sent) ≈ sum(grads), the
    residual stays bounded."""
    state = tc.init_state({"w": torch.zeros((32, 32))})
    rng = np.random.default_rng(0)
    total_g = np.zeros((32, 32))
    total_sent = np.zeros((32, 32))
    for _ in range(30):
        g = {"w": torch.from_numpy(
            rng.standard_normal((32, 32)).astype(np.float32))}
        sent, state, m = tc.compress(g, state, frac=0.05)
        total_g += g["w"].numpy()
        total_sent += sent["w"].numpy()
    resid = state.residual["w"].numpy()
    np.testing.assert_allclose(total_sent + resid, total_g, rtol=1e-4,
                               atol=1e-4)
    assert float(m["density"]) <= 0.08


def test_compression_density_matches_frac():
    """The reference's case: about 1 % of 1000 sent (ties allowed)."""
    state = tc.init_state({"w": torch.zeros(1000)})
    g = {"w": torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (1000,))))}
    sent, state, m = tc.compress(g, state, frac=0.01)
    assert int((sent["w"] != 0).sum()) <= 15
