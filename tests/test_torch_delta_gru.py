"""Port conformance, ΔGRU: repro_torch's ΔGRU against the JAX package's.

Same numpy weights and inputs through ``repro.core.delta_gru_scan``
(``backend="xla"``, the reference the repo's own tests pin its Pallas
kernel to) and the port's ``delta_gru_scan(backend="pallas")`` on CPU
tensors (the kernel's plain version).  Tolerance: hs and state within
1e-5 absolute — the products Δ·W are summed in another order by each
library's matmul, and σ/tanh may differ by an ulp — and the per-frame
transmit counts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_gru as jdg
from repro_torch.core import delta_gru as tdg

I, H, T, B = 10, 16, 12, 3
ATOL = 1e-5


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((I, 3 * H)) / np.sqrt(I)).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (0.1 * rng.standard_normal(3 * H)).astype(np.float32))


def _xs(seed=1):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(0.15 * rng.standard_normal((T, B, I)), axis=0)
    return walk.astype(np.float32)


def _jax(w, xs, th):
    p = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    hs, st, stats = jdg.delta_gru_scan(p, jnp.asarray(xs), th,
                                       backend="xla")
    return (np.asarray(hs), [np.asarray(a) for a in st],
            np.asarray(stats.nz_dx), np.asarray(stats.nz_dh))


@pytest.mark.parametrize("th", [0.0, 0.1])
def test_matches_jax_with_carried_state(th):
    """The port, run as two chunks [0:5] and [5:12] with the state
    carried, equals the JAX scan over all 12 frames."""
    w, xs = _weights(), _xs()
    j_hs, j_st, j_nzx, j_nzh = _jax(w, xs, th)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    xt = torch.tensor(xs)
    hs_a, st, stats_a = tdg.delta_gru_scan(p, xt[:5], th, backend="pallas")
    hs_b, st, stats_b = tdg.delta_gru_scan(p, xt[5:], th, st,
                                           backend="pallas")
    np.testing.assert_allclose(torch.cat([hs_a, hs_b]).numpy(), j_hs,
                               rtol=0, atol=ATOL)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        torch.cat([stats_a.nz_dx, stats_b.nz_dx]).numpy(), j_nzx)
    np.testing.assert_array_equal(
        torch.cat([stats_a.nz_dh, stats_b.nz_dh]).numpy(), j_nzh)
    if th > 0:
        assert j_nzx.sum() < T * B * I       # the threshold skips deltas


def test_plain_kernel_version_equals_per_step_cell():
    """backend="pallas" on the CPU (the kernel's plain version) and
    backend="xla" (the per-step cell) do the same ops: bit-identical."""
    w, xs = _weights(2), _xs(3)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    a = tdg.delta_gru_scan(p, torch.tensor(xs), 0.1, backend="pallas")
    b = tdg.delta_gru_scan(p, torch.tensor(xs), 0.1, backend="xla")
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for x, y in zip((*a[1], *a[2]), (*b[1], *b[2])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_threshold_zero_equals_dense_gru():
    w, xs = _weights(4), _xs(5)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    hs, _, stats = tdg.delta_gru_scan(p, torch.tensor(xs), 0.0,
                                      backend="pallas")
    dense = tdg.dense_gru_scan(p, torch.tensor(xs))
    torch.testing.assert_close(hs, dense, rtol=3e-5, atol=3e-5)
    j_dense = jdg.dense_gru_scan(
        jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w)), jnp.asarray(xs))
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense),
                               rtol=0, atol=ATOL)
    # Δ_TH = 0 transmits every changed component (x is a random walk).
    assert int(stats.nz_dx.sum()) == T * B * I


def test_pallas_raises_above_kernel_shared_memory():
    """Weights beyond one block's shared memory (227 KB) raise, naming
    the limit: the reference's block-sparse fallback is not ported."""
    h = 140                                  # (10+140)·420·4 B > 227 KB
    p = tdg.DeltaGRUParams(torch.zeros(I, 3 * h), torch.zeros(h, 3 * h),
                           torch.zeros(3 * h))
    with pytest.raises(ValueError, match="227 KB"):
        tdg.delta_gru_scan(p, torch.zeros(1, 1, I), 0.1, backend="pallas")
    hs, _, _ = tdg.delta_gru_scan(p, torch.zeros(1, 1, I), 0.1,
                                  backend="xla")
    assert hs.shape == (1, 1, h)


def test_unknown_backend_rejected():
    w = _weights()
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    with pytest.raises(ValueError, match="unknown"):
        tdg.delta_gru_scan(p, torch.zeros(1, 1, I), backend="pallas-int")
