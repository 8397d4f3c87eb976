"""Port conformance, the last small KWS pieces: ``core/sparsity.py``,
``frontend/fex.py::frames_per_second``, the single-stream
``kernels/iir_fex.py::iir_fex`` (``ops.iir_fex``), the oracles of
``kernels/ref.py`` and the package-level names of ``core`` and
``frontend``, against the JAX package on the same numpy inputs.

Exact: the accumulator's totals and properties, the histogram's counts,
the sparsity fraction, the frame rate, and ``iir_fex`` (the float FEx's
plain version is exact against the reference's scan).  Within stated
tolerances: the oracles, which each package writes as plain products and
sums (XLA fuses some of them), 1e-6 relative for the FEx envelopes and
1e-5 for the ΔGRU cell.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.frontend as jfront
from repro.core import delta_gru as jdg
from repro.core import sparsity as jsp
from repro.frontend import fex as jfx
from repro.kernels import iir_fex as jiir
from repro.kernels import ref as jref
import repro_torch.core as tcore
import repro_torch.frontend as tfront
from repro_torch.core import delta_gru as tdg
from repro_torch.core import sparsity as tsp
from repro_torch.frontend import fex as tfx
from repro_torch.kernels import iir_fex as tiir
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _xs(seed=0, T=24, B=3, I=10):
    rng = np.random.default_rng(seed)
    return np.cumsum(0.3 * rng.standard_normal((T, B, I)), 0).astype(
        np.float32)


@pytest.fixture(scope="module")
def stats_pair():
    """The same ΔGRU run in both packages (the counts are exact)."""
    rng = np.random.default_rng(1)
    w = ((rng.standard_normal((10, 48)) / np.sqrt(10)).astype(np.float32),
         (rng.standard_normal((16, 48)) / 4).astype(np.float32),
         np.zeros(48, np.float32))
    out = []
    for seed in (2, 3):
        xs = _xs(seed)
        _, _, js = jdg.delta_gru_scan(
            jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w)),
            jnp.asarray(xs), 0.1, backend="xla")
        _, _, ts = tdg.delta_gru_scan(
            tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w)),
            torch.from_numpy(xs), 0.1, backend="pallas")
        out.append((js, ts))
    return out


def test_sparsity_accumulator_matches_jax(stats_pair):
    ja, ta = jsp.SparsityAccumulator(), tsp.SparsityAccumulator()
    assert ta == tsp.SparsityAccumulator(0.0, 0.0, 0.0, 0.0, 0)
    assert ta.sparsity == ja.sparsity and ta.macs_per_frame == \
        ja.macs_per_frame
    for js, ts in stats_pair:
        ja.update(js)
        ta.update(ts)
        for f in ("macs_exec", "macs_dense", "nz_dx", "nz_dh", "frames"):
            assert getattr(ta, f) == getattr(ja, f), f
        assert ta.sparsity == ja.sparsity
        assert ta.macs_per_frame == ja.macs_per_frame
    assert 0.0 < ta.sparsity < 1.0 and ta.frames == 2 * 24 * 3


@pytest.mark.parametrize("n_bins,max_abs", [(64, 2.0), (8, 0.5), (5, 1.0)])
def test_delta_histogram_matches_jax(n_bins, max_abs):
    xs = _xs(4)
    xs[5, 0, 0] = xs[4, 0, 0] + max_abs           # exactly the last edge
    xs[7, 1, 1] = xs[6, 1, 1] + 10.0              # beyond it: not counted
    xs[9, 2, 2] = np.nan                          # NaN: not counted
    jh, je = jsp.delta_histogram(jnp.asarray(xs), n_bins, max_abs)
    th, te = tsp.delta_histogram(torch.from_numpy(xs), n_bins, max_abs)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.dtype == torch.float32 and te.shape == (n_bins + 1,)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    assert 0 < float(th.sum()) < xs[1:].size


@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.1, 0.3, 1e9])
def test_sparsity_at_threshold_matches_jax(threshold):
    xs = _xs(5)
    want = float(jsp.sparsity_at_threshold(jnp.asarray(xs), threshold))
    got = tsp.sparsity_at_threshold(torch.from_numpy(xs), threshold)
    assert float(got) == pytest.approx(want, rel=1e-7, abs=0)
    assert (float(got) == 1.0) == (threshold == 1e9)


def test_frames_per_second_matches_jax():
    assert tfx.frames_per_second(tfx.FExConfig()) == \
        jfx.frames_per_second(jfx.FExConfig()) == 62.5
    cfg = tfx.FExConfig(frame_shift=100)
    assert tfx.frames_per_second(cfg) == 80.0


@pytest.fixture(scope="module")
def bank():
    return np.array(jiir.pack_coefficients(
        jfx.build_sos_bank(jfx.FExConfig())))


def test_single_stream_iir_fex_matches_jax_scan(bank):
    """(T,) audio → (F, C) raw envelopes from zero state, bit for bit the
    reference's scan (what its ``iir_fex`` computes), through
    ``ops.iir_fex`` too; a ragged tail is ignored."""
    x = (np.random.default_rng(6).standard_normal(3 * 128 + 50) * 0.2
         ).astype(np.float32)
    jf, _ = jfx.fex_scan(jnp.asarray(x[None]), jnp.asarray(bank),
                         compress=False, backend="xla")
    got = tiir.iir_fex(torch.from_numpy(x), torch.from_numpy(bank))
    assert tops.iir_fex is tiir.iir_fex
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf[0]))


def test_iir_fex_ref_oracle_matches_jax(bank):
    x = (np.random.default_rng(7).standard_normal(2 * 128 + 9) * 0.2
         ).astype(np.float32)
    want = np.asarray(jref.iir_fex_ref(jnp.asarray(x), jnp.asarray(bank)))
    got = tref.iir_fex_ref(torch.from_numpy(x), torch.from_numpy(bank))
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    # The oracle agrees with the kernel's plain version to rounding.
    np.testing.assert_allclose(
        got.numpy(), tiir.iir_fex(torch.from_numpy(x),
                                  torch.from_numpy(bank)).numpy(),
        rtol=1e-6, atol=1e-9)


def test_matvec_and_cell_oracles_match_jax():
    rng = np.random.default_rng(8)
    B, I, H = 3, 16, 8
    dx = (rng.standard_normal((B, I)) * (rng.random((B, I)) < 0.4)
          ).astype(np.float32)
    w = rng.standard_normal((I, 24)).astype(np.float32)
    m = rng.standard_normal((B, 24)).astype(np.float32)
    mask = np.array([1, 0], np.int32)
    np.testing.assert_allclose(
        tref.delta_matvec_ref(*(torch.from_numpy(a) for a in
                                (dx, w, m, mask)), 8).numpy(),
        np.asarray(jref.delta_matvec_ref(*(jnp.asarray(a) for a in
                                           (dx, w, m, mask)), 8)),
        rtol=0, atol=1e-6)
    args = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, I), (B, H), (B, I), (B, H), (B, 3 * H), (B, 3 * H),
        (I, 3 * H), (H, 3 * H))]
    want = jref.delta_gru_cell_ref(*(jnp.asarray(a) for a in args), 0.3)
    got = tref.delta_gru_cell_ref(*(torch.from_numpy(a) for a in args), 0.3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-5)
    assert set(tref.__all__) == {"delta_matvec_ref", "iir_fex_ref",
                                 "delta_gru_cell_ref"}


# The reference's package-level names the port leaves to the LM stacks
# (ROADMAP.md queue 1 item 12).
def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), type(jax))}


def test_package_level_names_match_the_reference():
    assert _public(tcore) == _public(jcore)
    assert _public(tfront) == _public(jfront)
    assert tcore.SparsityAccumulator is tsp.SparsityAccumulator
    assert tfront.fex_scan is tfx.fex_scan
