"""Port conformance, fused ΔGRU step: repro_torch's ``delta_gru_cell``
(on CPU tensors, its plain version ``delta_gru_cell_ref``) against the JAX
package's oracle ``repro.kernels.ref.delta_gru_cell_ref`` and its per-step
``core.delta_gru.DeltaGRUCell``, on the same numpy inputs.

The sweep is ``tests/test_kernels.py``'s: three shapes at Δ_TH 0 and
0.25.  x̂ and ĥ are selects of the inputs, so they are equal exactly.
h and M are held to 2e-5 absolute and relative: the products Δ·W are
summed in another order by each library's matmul (σ/tanh are XLA's own
in the port).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_gru as jdg
from repro.kernels import ref as jref
from repro_torch.kernels import delta_gru_cell as tdc
from repro_torch.kernels import ops as tops

TOL = 2e-5
CASES = [(B, I, H, th) for B, I, H in ((1, 10, 64), (4, 16, 32), (2, 40, 128))
         for th in (0.0, 0.25)]


def _inputs(B, I, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    return (f(B, I), f(B, H, scale=0.5), f(B, I, scale=0.1),
            f(B, H, scale=0.1), f(B, 3 * H, scale=0.1), f(B, 3 * H, scale=0.1),
            f(I, 3 * H, scale=0.2), f(H, 3 * H, scale=0.2))


@pytest.mark.parametrize("B,I,H,th", CASES)
def test_matches_jax_oracle_and_core_cell(B, I, H, th):
    args = _inputs(B, I, H, seed=B * 1000 + I + H)
    got = tops.delta_gru_cell(*(torch.from_numpy(a) for a in args), th)
    want = jref.delta_gru_cell_ref(*(jnp.asarray(a) for a in args), th)
    names = ("h", "x_hat", "h_hat", "m_x", "m_h")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if name in ("x_hat", "h_hat"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL, err_msg=name)
    # The core cell: the same step with the bias carried in M_x (the
    # kernel adds none, so M_x enters with the bias folded in).
    x, h, xh, hh, mx, mh, wx, wh = args
    b = np.linspace(-0.2, 0.2, 3 * H, dtype=np.float32)
    p = jdg.DeltaGRUParams(jnp.asarray(wx), jnp.asarray(wh), jnp.asarray(b))
    st = jdg.DeltaState(*(jnp.asarray(a) for a in (h, xh, hh, mx + b, mh)))
    new_st, h_core, _ = jdg.DeltaGRUCell(H, th)(p, st, jnp.asarray(x))
    got_b = tdc.delta_gru_cell(*(torch.from_numpy(a) for a in (
        x, h, xh, hh, mx + b, mh, wx, wh)), th)
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(h_core),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_b[1].numpy(), np.asarray(new_st.x_hat))
    np.testing.assert_allclose(got_b[3].numpy(), np.asarray(new_st.m_x),
                               rtol=TOL, atol=TOL)


def test_cpu_wrapper_is_its_plain_version_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _inputs(3, 10, 16, seed=1)]
    tdc.delta_gru_cell.launches = 0
    a = tdc.delta_gru_cell(*args, 0.1)
    b = tdc.delta_gru_cell_ref(*args, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tdc.delta_gru_cell.launches == 0


def test_check_cell_fits_names_the_limits():
    """The kernel reads the transmitted deltas' weight rows straight from
    global memory: its shared memory holds only the compacted lists (32
    entries of 8 bytes per warp of components), their counts and the M
    rows, under the 48 KB a block has without opting in at every width
    it admits; it refuses only what one block's threads cannot hold."""
    assert tdc.cell_kernel_smem_bytes(10, 64) == 8 * 32 * 3 + 16 + 8 * 192
    assert tdc.cell_kernel_smem_bytes(40, 128) == 8 * 32 * 6 + 32 + 8 * 384
    assert tdc.cell_kernel_smem_bytes(1024, 341) < 48 * 1024
    tdc.check_cell_fits(40, 128)
    tdc.check_cell_fits(1024, 341)           # 1023 columns, 1024 threads
    with pytest.raises(ValueError, match="3H <= 1024"):
        tdc.check_cell_fits(10, 342)
    with pytest.raises(ValueError, match="3H <= 1024"):
        tdc.check_cell_fits(1100, 8)
    with pytest.raises(ValueError, match=r"I <= 3H rounded up to a warp \(32\)"):
        tdc.check_cell_fits(33, 10)


# The edge cases chip_smoke.py holds the kernel to on the card: every row
# sent (Δ_TH -1, zero deltas too), no row sent (Δ_TH above every |Δ|), x
# encoders in two warps (I = 40) with 3H not a multiple of 32 (H = 20),
# I > H, and the full width at a batch that is not a warp multiple.
EDGES = [(3, 40, 20, -1.0), (3, 40, 20, 1e9), (2, 40, 20, 0.1),
         (33, 10, 64, -1.0), (1, 10, 64, 1e9), (4, 96, 32, 0.1)]


@pytest.mark.parametrize("B,I,H,th", EDGES)
def test_edge_shapes_and_thresholds_match_jax_oracle(B, I, H, th):
    args = _inputs(B, I, H, seed=7 * B + I + H)
    got = tops.delta_gru_cell(*(torch.from_numpy(a) for a in args), th)
    want = jref.delta_gru_cell_ref(*(jnp.asarray(a) for a in args), th)
    for name, g, w in zip(("h", "x_hat", "h_hat", "m_x", "m_h"), got, want):
        if name in ("x_hat", "h_hat"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL, err_msg=name)
    x, h, xh, hh, mx, mh = args[:6]
    if th < 0:                               # every component transmitted
        np.testing.assert_array_equal(got[1].numpy(), x)
        np.testing.assert_array_equal(got[2].numpy(), h)
    if th > 1e6:                             # none: M and the hats stay
        np.testing.assert_array_equal(got[1].numpy(), xh)
        np.testing.assert_array_equal(got[3].numpy(), mx)
        np.testing.assert_array_equal(got[4].numpy(), mh)
