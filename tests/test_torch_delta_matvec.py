"""Port conformance, block-sparse delta matvec: repro_torch's
``delta_matvec`` (on CPU tensors, its plain version) and
``make_block_mask`` against the JAX package's oracle
``repro.kernels.ref.delta_matvec_ref``, its ``make_block_mask`` and, on one
small case, its Pallas kernel in interpret mode.

Inputs come from numpy seeds and go to both packages as the same arrays.
Tolerance: 1e-5 relative and absolute on outputs of magnitude up to ~60,
for float32 and for bfloat16 inputs (both sides widen bfloat16 to float32
exactly): the two libraries' matmuls sum the products in another order.
The masked cases are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.delta_matvec import make_block_mask as j_make_block_mask
from repro_torch.kernels import delta_matvec as tdm
from repro_torch.kernels import ops as tops

TOL = 1e-5
SWEEP = [(1, 128, 128, 128, 128), (4, 512, 384, 128, 128),
         (2, 256, 640, 64, 128), (8, 1024, 256, 256, 64)]


def _case(B, I, O, block_i, seed):
    """Deltas with about half the input blocks all zero, weights, m."""
    rng = np.random.default_rng(seed)
    nblk = I // block_i
    keep = rng.random(nblk) < 0.5
    keep[0] = True
    dx = rng.standard_normal((B, nblk, block_i)) * keep[None, :, None]
    return (dx.reshape(B, I).astype(np.float32),
            rng.standard_normal((I, O)).astype(np.float32),
            rng.standard_normal((B, O)).astype(np.float32))


@pytest.mark.parametrize("B,I,O,block_i,block_o", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_matches_jax_oracle(B, I, O, block_i, block_o, dtype):
    dx, w, m = _case(B, I, O, block_i, seed=I + O)
    t_dx, t_w = torch.from_numpy(dx), torch.from_numpy(w)
    if dtype == "bfloat16":
        t_dx, t_w = t_dx.bfloat16(), t_w.bfloat16()
    j_dx = jnp.asarray(t_dx.float().numpy()).astype(dtype)
    j_w = jnp.asarray(t_w.float().numpy()).astype(dtype)
    t_mask = tdm.make_block_mask(t_dx, block_i)
    j_mask = j_make_block_mask(j_dx, block_i)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert t_mask.dtype == torch.int32 and 0 < int(t_mask.sum()) <= I
    got = tdm.delta_matvec(t_dx, t_w, torch.from_numpy(m), t_mask,
                           block_i=block_i, block_o=block_o)
    want = jref.delta_matvec_ref(j_dx, j_w, jnp.asarray(m), j_mask, block_i)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_masked_blocks_contribute_nothing():
    """A masked-off block adds nothing even where its deltas are
    non-zero: ones through block 0 only gives exactly 128."""
    B, I, O = 2, 256, 128
    mask = torch.tensor([1, 0], dtype=torch.int32)
    out = tdm.delta_matvec(torch.ones(B, I), torch.ones(I, O),
                           torch.zeros(B, O), mask)
    assert torch.equal(out, torch.full((B, O), 128.0))
    m = torch.randn(B, O, generator=torch.Generator().manual_seed(0))
    none = tdm.delta_matvec(torch.ones(B, I), torch.ones(I, O), m,
                            torch.zeros(2, dtype=torch.int32))
    assert torch.equal(none, m)                       # all-zero mask


def test_small_case_matches_jax_pallas_interpret():
    """The JAX Pallas kernel itself (interpret mode on the CPU)."""
    dx, w, m = _case(3, 128, 128, 32, seed=5)
    mask = j_make_block_mask(jnp.asarray(dx), 32)
    want = jops.delta_matvec(jnp.asarray(dx), jnp.asarray(w),
                             jnp.asarray(m), mask, block_i=32, block_o=64,
                             interpret=True)
    got, t_mask = tops.delta_matvec_auto(
        torch.from_numpy(dx), torch.from_numpy(w), torch.from_numpy(m),
        block_i=32, block_o=64)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_block_mask_propagates_nan_like_jnp_max():
    dx = np.zeros((2, 8), np.float32)
    dx[0, 1] = np.nan
    dx[1, 5] = -3.0
    got = tdm.make_block_mask(torch.from_numpy(dx), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_make_block_mask(jnp.asarray(dx), 4)))
    assert got.tolist() == [0, 1]


@pytest.mark.parametrize("I,O,block_i,block_o", [(100, 128, 64, 128),
                                                 (128, 100, 64, 64)])
def test_untileable_shapes_raise(I, O, block_i, block_o):
    z = torch.zeros
    with pytest.raises(ValueError, match="multiples"):
        tdm.delta_matvec(z(2, I), z(I, O), z(2, O),
                         z(max(I // block_i, 1), dtype=torch.int32),
                         block_i=block_i, block_o=block_o)


# ----------------------------------------------- the kernel's launch plan --
SMEM_PER_BLOCK = 232_448          # an H100 thread block's shared memory
TAILS = [(B, I, 640, bi, 128) for B in (1, 17, 255)
         for I, bi in ((10, 10), (320, 64))]


@pytest.mark.parametrize("B,I,O,block_i,block_o",
                         TAILS + SWEEP + [(256, 256, 768, 128, 128),
                                          (256, 10, 768, 10, 128),
                                          (33, 96, 100, 32, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_covers_every_output(B, I, O, block_i, block_o, dtype):
    """The grid's CTA tiles cover all B × O outputs and no tile lies wholly
    outside them; shared memory fits a thread block; the copy path is the
    one the kernel takes for these shapes."""
    plan = tdm.matvec_launch_plan(B, I, O, block_i, block_o, dtype)
    gx, gy = plan["grid"]
    assert (gx - 1) * tdm.TILE_O < O <= gx * tdm.TILE_O
    assert (gy - 1) * tdm.TILE_B < B <= gy * tdm.TILE_B
    assert plan["threads"] % 32 == 0 and plan["smem_bytes"] <= SMEM_PER_BLOCK
    if dtype == torch.bfloat16 or O % 4:
        assert plan["copy"] == "plain"
    elif I % 4 == 0 and block_i % tdm.TILE_K == 0:
        assert plan["copy"] == "tma"
    else:
        assert plan["copy"] == "cp.async"
    unaligned = tdm.matvec_launch_plan(B, I, O, block_i, block_o, dtype,
                                       aligned=False)
    assert unaligned["copy"] == "plain"


def test_launch_plan_at_the_fallback_shape_fills_the_card():
    """B=256, I=256, O=768: 12 × 22 = 264 CTAs of 2 warps, 528 warps for
    the H100's 528 SM sub-partitions, slices copied by TMA."""
    plan = tdm.matvec_launch_plan(256, 256, 768, 128, 128)
    assert plan["grid"] == (12, 22) and plan["threads"] == 64
    assert plan["grid"][0] * plan["grid"][1] * plan["threads"] // 32 == 528
    assert plan["copy"] == "tma"


@pytest.mark.parametrize("I,O,block_i,block_o", [(100, 128, 64, 128),
                                                 (128, 100, 64, 64),
                                                 (128, 128, 0, 128)])
def test_launch_plan_refuses_what_the_reference_refuses(I, O, block_i,
                                                        block_o):
    with pytest.raises(ValueError, match="multiples"):
        tdm.matvec_launch_plan(4, I, O, block_i, block_o)


@pytest.mark.parametrize("B,I,O,block_i,block_o", TAILS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("last_only", [False, True])
def test_tails_match_jax_oracle(B, I, O, block_i, block_o, dtype,
                                last_only):
    """The shapes the kernel's tiles leave ragged (rows that do not fill a
    tile, slices of 10 rows, five blocks of 64), also with only the last
    block active: the plain version against the JAX oracle."""
    dx, w, m = _case(B, I, O, block_i, seed=B + I)
    t_dx, t_w = torch.from_numpy(dx), torch.from_numpy(w)
    if dtype == "bfloat16":
        t_dx, t_w = t_dx.bfloat16(), t_w.bfloat16()
    j_dx = jnp.asarray(t_dx.float().numpy()).astype(dtype)
    j_w = jnp.asarray(t_w.float().numpy()).astype(dtype)
    t_mask = tdm.make_block_mask(t_dx, block_i)
    if last_only:
        t_mask = torch.zeros_like(t_mask)
        t_mask[-1] = 1
    got = tdm.delta_matvec(t_dx, t_w, torch.from_numpy(m), t_mask,
                           block_i=block_i, block_o=block_o)
    want = jref.delta_matvec_ref(j_dx, j_w, jnp.asarray(m),
                                 jnp.asarray(t_mask.numpy()), block_i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
