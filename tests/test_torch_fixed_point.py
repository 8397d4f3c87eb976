"""Port conformance, integer datapath: repro_torch's ``core.fixed_point``
and its two integer kernels' plain versions against the JAX package's
golden fixed-point model, on the same numpy inputs.

The JAX side runs its golden ``backend="xla"`` scans (its own tests pin
the Pallas kernels to them bit for bit); the port runs its kernel
wrappers on CPU tensors, i.e. the plain versions.

What must be exact: everything — the primitives, promotion codes and
formats, bundles on disk, the integer FEx (registers and features), and
the ΔGRU's Δ codes, x̂/ĥ, the 24-bit accumulators, the transmit counts,
h codes and votes.  The gates' float32 σ and tanh, and the FEx's log2,
are XLA's own expansions in the port (``kernels/xla_math.py``), so a
rounded Q0.15 code cannot flip.  On the full-width model at Δ_TH 0.1
(8 utterances × 31 frames × 64 units = 15,872 h codes) the tests print
the counts, and each must be 0.  XLA fuses multiply-adds only on a host
with FMA; the σ/tanh tests need it (``xla_fma`` skips, saying so,
elsewhere).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deltakws import CONFIG as J_CONFIG
from repro.core import fixed_point as jfp
from repro.data import gscd as jgscd
from repro.frontend.fex import FeatureExtractor as JFex
from repro.models import kws as jkws
from repro.train import promote as jpromote
from repro_torch.core import delta_gru as tdg
from repro_torch.core import fixed_point as tfp
from repro_torch.frontend.fex import FeatureExtractor as TFex
from repro_torch.kernels import delta_gru_seq as tdgs
from repro_torch.models import kws as tkws
from repro_torch.train import promote as tpromote
from test_torch_xla_math import xla_fma  # noqa: F401  (a fixture)

TH = 0.1



def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, jax_arr):
    np.testing.assert_array_equal(port.numpy() if isinstance(
        port, torch.Tensor) else port, np.asarray(jax_arr))


@pytest.fixture(scope="module")
def model():
    """The paper's full-width model (JAX init_kws, seed 0), promoted by
    both packages at Δ_TH 0.1 with the FEx bank folded in."""
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_CONFIG, input_dim=10)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    jb = jfp.promote_kws(params, TH, fex=JFex())
    tb = tfp.promote_kws(tkws.params_from_numpy(np_params), TH, fex=TFex())
    return jb, tb


@pytest.fixture(scope="module")
def feats(model):
    """Integer feature codes (8, 31, 10) of 8 synthetic utterances from
    the JAX golden FEx (the port's is held to it bit for bit below)."""
    jb, _ = model
    audio, _ = jgscd.synth_batch(np.random.default_rng(0), 8)
    codes = jfp.to_code(jnp.asarray(audio[:, :3968], jnp.float32),
                        jb.ffmt.feat_frac, 16, jnp.int16)
    f, _ = jfp.int_fex_scan(codes, jb.coef, jfp.init_int_fex_state(8, 10),
                            jb.ffmt, backend="xla")
    return np.asarray(f)


# ------------------------------------------------------------ primitives --
def test_primitives_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(-(1 << 24), 1 << 24, (4, 12)).astype(np.int32)
    for s in (1, 4, 11):
        _eq(tfp.rshift_round(_t(x), s), jfp.rshift_round(jnp.asarray(x), s))
    for shift in (-4, 0, 1, 3):
        _eq(tfp.align(_t(x), shift), jfp.align(jnp.asarray(x), shift))
    for sx, sh in ((1, -4), (-2, 3), (2, 1), (-3, -5), (-1, -1)):
        _eq(tfp.align_pair(_t(x), sx, sh),
            jfp.align_pair(jnp.asarray(x), sx, sh))
    for bits in (8, 16, 24):
        _eq(tfp.sat(_t(x), bits), jfp.sat(jnp.asarray(x), bits))
    v = rng.uniform(-20, 20, (5, 7)).astype(np.float32)
    v[0, :3] = [0.5 / 2048, 1.5 / 2048, -2.5 / 2048]          # ties
    for frac, bits in ((11, 16), (18, 24), (15, 16)):
        _eq(tfp.to_code(_t(v), frac, bits, torch.int32),
            jfp.to_code(jnp.asarray(v), frac, bits))
        _eq(tfp.to_code(v, frac, bits, torch.int16),
            jfp.to_code(v, frac, bits, np.int16))
        _eq(tfp.from_code(tfp.to_code(_t(v), frac, bits), frac),
            jfp.from_code(jfp.to_code(jnp.asarray(v), frac, bits), frac))
    for th in (0.0, 0.1, 0.2, 0.37, 1.0):
        assert (tfp.GruFormats(e_x=1).th_codes(th)
                == jfp.GruFormats(e_x=1).th_codes(th))


def test_promote_codes_and_formats_equal_jax(model):
    jb, tb = model
    assert dataclasses.asdict(tb.gfmt) == dataclasses.asdict(jb.gfmt)
    assert dataclasses.asdict(tb.ffmt) == dataclasses.asdict(jb.ffmt)
    assert tb.threshold == jb.threshold == TH
    for got, want in ((tb.gru.w_x, jb.gru.w_x), (tb.gru.w_h, jb.gru.w_h),
                      (tb.gru.b, jb.gru.b), (tb.w_fc, jb.w_fc),
                      (tb.b_fc, jb.b_fc), (tb.coef, jb.coef)):
        assert got.numpy().dtype == np.asarray(want).dtype
        _eq(got, want)
    # The formats of this model (the kernels accept both shift signs).
    assert (tb.gfmt.shift_x, tb.gfmt.shift_h) == (1, -4)
    assert (tb.ffmt.b_frac, tb.ffmt.a_frac) == (11, 6)


def test_bundles_cross_both_ways(model, tmp_path):
    jb, tb = model
    jpath = jpromote.save_bundle(tmp_path / "jax", jb)
    tpath = tpromote.save_bundle(tmp_path / "port", tb)
    assert jpath.suffix == tpath.suffix == ".npz"
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:                 # same dtypes, same bytes
            assert jz[k].dtype == tz[k].dtype and jz[k].shape == tz[k].shape
            assert jz[k].tobytes() == tz[k].tobytes(), k
    from_jax = tpromote.load_bundle(jpath)
    from_port = jpromote.load_bundle(tpath)
    assert from_jax.gfmt == tb.gfmt and from_jax.ffmt == tb.ffmt
    assert from_port.gfmt == jb.gfmt and from_port.ffmt == jb.ffmt
    for a, b in ((from_jax.gru.w_x, from_port.gru.w_x),
                 (from_jax.gru.b, from_port.gru.b),
                 (from_jax.w_fc, from_port.w_fc),
                 (from_jax.coef, from_port.coef)):
        _eq(a, b)


# -------------------------------------------------------------- int FEx --
def test_int_fex_two_carried_chunks_bit_exact(model):
    """B=3, chunks of 1024 and 640 samples with the int16 state carried:
    feature codes and registers equal JAX's golden scan."""
    jb, tb = model
    audio, _ = jgscd.synth_batch(np.random.default_rng(3), 3)
    codes = np.asarray(jfp.to_code(jnp.asarray(audio[:, 2000:3664]),
                                   11, 16, jnp.int16))
    js = jfp.init_int_fex_state(3, 10)
    ts = tfp.init_int_fex_state(3, 10)
    for lo, hi in ((0, 1024), (1024, 1664)):
        jf, js = jfp.int_fex_scan(jnp.asarray(codes[:, lo:hi]), jb.coef, js,
                                  jb.ffmt, backend="xla")
        tf, ts = tfp.int_fex_scan(_t(codes[:, lo:hi]), tb.coef, ts, tb.ffmt,
                                  backend="pallas")
        assert tf.dtype == ts.dtype == torch.int16
        _eq(tf, jf)
        _eq(ts, js)
    assert int(np.abs(np.asarray(js)).max()) > 100   # the filters moved


def test_fex_scan_pallas_int_backend_matches_jax():
    """fex_scan(backend="pallas-int") (float in, grid-exact float out,
    float state carry, chunk-split) equals the JAX golden composition
    that the JAX package's backend runs: quantize_fex → to_code →
    int_fex_scan → from_code."""
    from repro_torch.frontend import fex as tfex
    jf, tf = JFex(), TFex()
    assert ([dataclasses.astuple(f) for f in tf.coef_formats]
            == [dataclasses.astuple(f) for f in jf.coef_formats])
    b_fmt, a_fmt = jf.coef_formats
    cfg = jf.cfg
    jcoef, ffmt = jfp.quantize_fex(np.asarray(jf.coef), cfg.env_alpha,
                                   b_fmt.frac_bits, a_fmt.frac_bits,
                                   log_eps=cfg.log_eps)
    audio, _ = jgscd.synth_batch(np.random.default_rng(4), 2)
    audio = (np.round(audio[:, 1500:2268] * 2048) / 2048).astype(np.float32)
    js, ts = jfp.init_int_fex_state(2, 10), None
    for lo, hi in ((0, 256), (256, 768)):
        jo, js = jfp.int_fex_scan(
            jfp.to_code(jnp.asarray(audio[:, lo:hi]), 11, 16, jnp.int16),
            jcoef, js, ffmt, backend="xla")
        # The second chunk derives the formats from the packed rows.
        to, ts = tfex.fex_scan(_t(audio[:, lo:hi]), tf.coef, ts,
                               env_alpha=cfg.env_alpha, log_eps=cfg.log_eps,
                               backend="pallas-int",
                               coef_formats=tf.coef_formats if lo == 0
                               else None)
        _eq(to, jfp.from_code(jo, 11))
        buf = jfp.fex_state_from_codes(js, ffmt)
        _eq(ts.filt, buf[:, :4])
        _eq(ts.env, buf[:, 4])
    with pytest.raises(ValueError, match="compresses"):
        tfex.fex_scan(_t(audio[:, :128]), tf.coef, None, compress=False,
                      backend="pallas-int")


# ------------------------------------------------------------- int ΔGRU --
def _j_state(b, B):
    return jfp.init_int_delta_state(B, 10, 64, b.gru)


def test_int_gru_per_frame_restarted_from_jax_state(model, feats, xla_fma):
    """One frame at a time, each restarted from JAX's carried state: h,
    x̂, ĥ, the fused accumulator and both transmit masks equal exactly
    (the h-code flips are counted and printed, and must be 0)."""
    jb, tb = model
    xs = np.moveaxis(feats, 1, 0)                            # (F, B, C)
    th_x, th_h = jb.gfmt.th_codes(TH)
    st = _j_state(jb, xs.shape[1])
    h, xh, hh = st.h, st.x_hat, st.h_hat
    m = jnp.concatenate([st.m_x, st.m_h], axis=-1)
    flips = worst = total = 0
    for t in range(xs.shape[0]):
        jout = jfp.gru_frame_step(jb.gfmt, jnp.asarray(xs[t]), h, xh, hh, m,
                                  jb.gru.w_x, jb.gru.w_h, th_x, th_h)
        tout = tfp.gru_frame_step(tb.gfmt, _t(xs[t]), _t(h), _t(xh), _t(hh),
                                  _t(m), tb.gru.w_x, tb.gru.w_h, th_x, th_h)
        for k in (1, 2, 3, 4, 5):                 # x̂, ĥ, m, mask_x, mask_h
            _eq(tout[k], jout[k])
        d = np.abs(tout[0].numpy() - np.asarray(jout[0]))
        flips += int(np.count_nonzero(d))
        worst = max(worst, int(d.max()))
        total += d.size
        h, xh, hh, m = (jnp.asarray(a).astype(d_) for a, d_ in zip(
            jout[:4], (jnp.int16, jnp.int16, jnp.int16, jnp.int32)))
    print(f"per frame: {flips} of {total} h codes differ, max {worst} LSB")
    assert flips == 0 and worst == 0, (flips, total, worst)


def test_int_gru_whole_scan_and_votes(model, feats, xla_fma):
    """The whole 31-frame scan through the kernel wrapper (plain version
    on the CPU) against JAX's golden scan: h codes, per-frame votes and
    transmit counts all equal (counted and printed, each must be 0), and
    int_forward's logit codes too."""
    jb, tb = model
    xs = np.moveaxis(feats, 1, 0)
    jhs, jst, jnx, jnh = jfp.int_gru_scan(jb.gru, jb.gfmt, jnp.asarray(xs),
                                          TH, backend="xla")
    ths, tst, tnx, tnh = tfp.int_gru_scan(tb.gru, tb.gfmt, _t(xs), TH,
                                          backend="pallas")
    assert ths.dtype == torch.int16 and tst.m_x.dtype == torch.int32
    jhs, ths = np.asarray(jhs), ths.numpy()
    flips = np.count_nonzero(jhs != ths)
    jv = np.argmax(np.asarray(jfp.int_fc(jnp.asarray(jhs), jb.w_fc,
                                         jb.b_fc)), -1)
    tv = tfp.int_fc(_t(ths), tb.w_fc, tb.b_fc).argmax(-1).numpy()
    n_nz = (np.count_nonzero(tnx.numpy() != np.asarray(jnx))
            + np.count_nonzero(tnh.numpy() != np.asarray(jnh)))
    print(f"whole scan: {flips} of {jhs.size} h codes, "
          f"{np.count_nonzero(jv != tv)} of {jv.size} votes, {n_nz} of "
          f"{2 * jv.size} transmit counts differ")
    assert flips == 0 and n_nz == 0 and np.array_equal(jv, tv)
    for got, want in zip(tst, jst):
        _eq(got, want)
    jl, jfx, _ = jfp.int_forward(jb, jnp.asarray(feats), backend="xla")
    tl, tfx, _ = tfp.int_forward(tb, _t(feats), backend="xla")
    assert tl.dtype == torch.int32 and tl.shape == (8, 12)
    _eq(tl, jl)
    for got, want in zip(tfx, jfx):
        _eq(got, want)


def test_int_gru_state_carry_is_invisible(model, feats):
    """Two carried calls of the wrapper equal one call, bit for bit."""
    _, tb = model
    xs = _t(np.moveaxis(feats, 1, 0))
    one = tfp.int_gru_scan(tb.gru, tb.gfmt, xs, TH, backend="pallas")
    a = tfp.int_gru_scan(tb.gru, tb.gfmt, xs[:13], TH, backend="pallas")
    b = tfp.int_gru_scan(tb.gru, tb.gfmt, xs[13:], TH, a[1],
                         backend="pallas")
    torch.testing.assert_close(torch.cat([a[0], b[0]]), one[0], rtol=0,
                               atol=0)
    for x, y in zip(b[1], one[1]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_accumulator_pinned_at_the_rail(model):
    """Accumulators started within 2^10 of the 24-bit rail with full-scale
    inputs saturate (never wrap) and drive σ/tanh to their extremes; the
    integer state and the h codes equal JAX's exactly there."""
    jb, tb = model
    rng = np.random.default_rng(5)
    B, T = 4, 6
    rail = (1 << 23) - 1
    mx = (np.sign(rng.standard_normal((B, 192))) * (rail - rng.integers(
        0, 1 << 10, (B, 192)))).astype(np.int32)
    mh = (np.sign(rng.standard_normal((B, 192))) * (rail - rng.integers(
        0, 1 << 10, (B, 192)))).astype(np.int32)
    xs = rng.choice([-2048, 2047], (T, B, 10)).astype(np.int16)
    z16 = lambda d: np.zeros((B, d), np.int16)
    jst = jfp.init_int_delta_state(B, 10, 64, jb.gru)._replace(
        m_x=jnp.asarray(mx), m_h=jnp.asarray(mh))
    tst = tdg.DeltaState(_t(z16(64)), _t(z16(10)), _t(z16(64)), _t(mx),
                         _t(mh))
    jhs, jf, *_ = jfp.int_gru_scan(jb.gru, jb.gfmt, jnp.asarray(xs), 0.0,
                                   jst, backend="xla")
    ths, tf, *_ = tfp.int_gru_scan(tb.gru, tb.gfmt, _t(xs), 0.0, tst,
                                   backend="pallas")
    _eq(ths, jhs)
    for got, want in zip(tf, jf):
        _eq(got, want)
    m = torch.cat([tf.m_x, tf.m_h], -1).abs()
    assert int(m.max()) == 1 << 23                # saturated, not wrapped
    assert int((m >= rail).sum()) > 0


def test_fmt_none_is_the_float_scan():
    """delta_gru_seq_int(fmt=None) is the float ΔGRU, bit for bit."""
    rng = np.random.default_rng(6)
    T, B, I, H = 5, 3, 10, 16
    p = tdg.init_delta_gru(torch.Generator().manual_seed(1), I, H)
    xs = _t(rng.uniform(-1, 1, (T, B, I)).astype(np.float32))
    st = tdg.init_delta_state(B, I, H, p)
    hs, final, nzx, nzh = tdgs.delta_gru_seq_int(
        xs, *st, p.w_x, p.w_h, torch.tensor([[0.1, 0.1]]), fmt=None)
    ref_hs, ref_state, ref_stats = tdg.delta_gru_scan(p, xs, 0.1, st,
                                                      backend="xla")
    torch.testing.assert_close(hs, ref_hs, rtol=0, atol=0)
    for x, y in zip(final, ref_state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(nzx, ref_stats.nz_dx, rtol=0, atol=0)
    with pytest.raises(ValueError, match="one Δ_TH"):
        tdgs.delta_gru_seq_int(xs, *st, p.w_x, p.w_h, (0.1, 0.2), fmt=None)


def test_packed_checks_and_refusals(model, feats):
    jb, tb = model
    xs = _t(np.moveaxis(feats, 1, 0)[:2])
    st = tfp.init_int_delta_state(8, 10, 64, tb.gru)
    with pytest.raises(ValueError, match="requires an integer"):
        tdgs.delta_gru_seq_int(xs.float(), *(s.float() for s in st),
                               tb.gru.w_x.float(), tb.gru.w_h.float(),
                               (0.1, 0.1), fmt=None, packed=True)
    # packed is numerics-invariant: same result with it on or off.
    on = tfp.int_gru_scan(tb.gru, tb.gfmt, xs, TH, backend="pallas",
                          packed=True)
    off = tfp.int_gru_scan(tb.gru, tb.gfmt, xs, TH, backend="pallas",
                           packed=False)
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    big = tfp.IntGruWeights(torch.zeros((10, 3 * 600), dtype=torch.int8),
                            torch.zeros((600, 3 * 600), dtype=torch.int8),
                            torch.zeros(3 * 600, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="shared memory"):
        tfp.int_gru_scan(big, tb.gfmt, xs, TH, backend="pallas")
    # event_driven (active-slot compaction) is ported: the same codes.
    ev = tfp.int_gru_scan(tb.gru, tb.gfmt, xs, TH, backend="pallas",
                          event_driven=True)
    for a, b in zip((ev[0], *ev[1], ev[2], ev[3]),
                    (off[0], *off[1], off[2], off[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_packed_int8_dot_exact_at_extremes():
    """The byte-plane dot is exact at |d| = 2^16, w = -128/127 and
    K = PACKED_DOT_MAX_K, and equals JAX's."""
    K = tfp.PACKED_DOT_MAX_K
    d = np.tile(np.array([[1 << 16, -(1 << 16), (1 << 16) - 1, -1]],
                         np.int32).T, (1, K))
    w = np.where(np.arange(K * 3).reshape(K, 3) % 2, 127, -128
                 ).astype(np.int8)
    want = d.astype(np.int64) @ w.astype(np.int64)
    got = tfp.packed_int8_dot(_t(d), _t(w).float())
    _eq(got, want.astype(np.int32))
    _eq(got, jfp.packed_int8_dot(jnp.asarray(d),
                                 jnp.asarray(w, jnp.float32)))
    pair = tfp.packed_int8_dot_pair(_t(d), _t(d), _t(w).float(),
                                    _t(w).float())
    _eq(pair, np.concatenate([want, want], -1).astype(np.int32))
    _eq(tfp._int_dot(_t(d), _t(w)), want.astype(np.int32))


# ------------------------------- the integer FEx kernel's launch plan --
@pytest.mark.parametrize("B,C", [(1, 10), (3, 10), (32, 10), (33, 10),
                                 (256, 10), (5, 7)])
def test_fex_int_launch_plan_covers_every_pair(B, C):
    """One CTA per 32 (stream, channel) pairs: the grid covers every pair
    and no CTA is empty; the rings fit a thread block's 227 KB."""
    from repro_torch.kernels import iir_fex
    plan = iir_fex.fex_int_launch_plan(B, C)
    lanes = iir_fex.FEX_INT_LANES
    assert (plan["ctas"] - 1) * lanes < B * C <= plan["ctas"] * lanes
    assert plan["threads"] == 5 * 32 and plan["smem_bytes"] <= 232_448
    # (P0, Q0) and (P1, Q1) int32 pairs, y0 and y1 int32: 24 bytes per
    # sample and pair, for every ring slot of every tile sample.
    assert plan["smem_bytes"] == (24 * iir_fex.FEX_INT_STAGES
                                  * iir_fex.FEX_INT_TILE * lanes)
    if (B, C) == (32, 10):
        assert plan["ctas"] == 10          # spread over 10 SMs, not 3


def test_fex_int_launch_plan_refuses_empty_batches():
    from repro_torch.kernels import iir_fex
    with pytest.raises(ValueError, match="B >= 1"):
        iir_fex.fex_int_launch_plan(0, 10)


# ------------------------------- the integer ΔGRU kernel's launch plan --
def _first_int_smem_bytes(I, H):
    """The shared memory the first int ΔGRU kernel needed (weights, then
    32-bit words for the state, the compacted deltas, the M rows and 64
    warp counts): the shapes it admitted are the ones the redesigned
    kernel must still run."""
    N = 3 * H
    return -(-(I + H) * N // 4) * 4 + 4 * (3 * I + 4 * H + 2 * N + 64)


def _widest_h(I):
    """The widest H the first kernel's layout admitted at input width I."""
    return max(H for H in range(1, 342)
               if _first_int_smem_bytes(I, H) <= tdgs.MAX_SMEM_BYTES
               and I <= -(-3 * H // 32) * 32)


@pytest.mark.parametrize("I,H", [(10, 64), (10, 16), (7, 5), (40, 100),
                                 (40, 128), (1, 1), (96, 32), (10, None)])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 3), (32, 32), (33, 100)])
def test_gru_int_launch_plan_covers_every_stream_and_column(I, H, B, T):
    """One CTA per stream; a warp multiple of threads that gives every
    column group of four its four lanes and every x component its encoder,
    within 1024; x codes staged for up to 32 frames; shared memory as the
    kernel lays it out, within 227 KB."""
    H = H or _widest_h(I)
    plan = tdgs.gru_int_launch_plan(B, I, H, T)
    threads = plan["threads"]
    assert plan["ctas"] == B
    assert threads % 32 == 0 and threads <= tdgs.MAX_THREADS
    assert threads >= -(-3 * H // 4) * 4 and threads >= max(I, H)
    assert 1 <= plan["x_frames"] <= min(T, tdgs.INT_X_FRAMES)
    assert plan["smem_bytes"] == tdgs.int_seq_kernel_smem_bytes(
        I, H, plan["x_frames"]) <= tdgs.MAX_SMEM_BYTES
    if (I, H, T) == (10, 64, 32):
        assert plan["x_frames"] == 32 and plan["smem_bytes"] < 20_000


def test_gru_int_launch_plan_refuses_nothing_admitted():
    """Every shape the first kernel ran (its shared memory and 3H <= 1024
    threads, I within the threads) still gets a plan, at every width, each
    input width from 1 to the most the threads allow; and
    check_int_kernel_fits admits it."""
    admitted = 0
    for H in range(1, 342):
        threads = -(-3 * H // 32) * 32
        for I in sorted({1, 10, 32, 33, 3 * H, threads}):
            if I > threads or _first_int_smem_bytes(I, H) > \
                    tdgs.MAX_SMEM_BYTES:
                continue
            tdgs.check_int_kernel_fits(I, H)
            plan = tdgs.gru_int_launch_plan(4, I, H, 32)
            assert plan["smem_bytes"] <= tdgs.MAX_SMEM_BYTES
            admitted += 1
    assert admitted > 1000
    assert _widest_h(10) >= 260            # the widest at I = 10


def test_gru_int_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="227 KB"):
        tdgs.gru_int_launch_plan(1, 10, 341, 32)
    with pytest.raises(ValueError, match="rounded up to a warp"):
        tdgs.gru_int_launch_plan(1, 100, 10, 32)


def test_int_fex_one_bit_shifts_bit_exact(model):
    """b_frac = a_frac = 1 with b0 = 2^18 - 1 (section 0) and 2^16 - 1
    (section 1) and a2 = 2^16 - 1: at every -2048 sample each section's
    rshift_round(-b0·v) + rshift_round(-a2·y) + 2^15 passes 2^31, the
    case for which the CUDA kernel takes its wide instance.  The format
    is accepted, and the plain version equals JAX's golden scan."""
    from repro_torch.kernels import iir_fex
    jb, tb = model
    t_fmt = dataclasses.replace(tb.ffmt, b_frac=1, a_frac=1)
    j_fmt = dataclasses.replace(jb.ffmt, b_frac=1, a_frac=1)
    iir_fex._check_int_formats(t_fmt)
    col = [(1 << 18) - 1, -3, (1 << 16) - 1, (1 << 16) - 1, 2, (1 << 16) - 1]
    coef = np.repeat(np.array(col, np.int32)[:, None], 10, axis=1)
    xs = 1 << (t_fmt.sig_frac - t_fmt.feat_frac)
    q0 = (col[0] * 2048 * xs + 1) >> 1         # x = -2048 → y0 = -32768
    r0 = (col[2] * 32768 + 1) >> 1
    assert q0 + r0 + (1 << 15) >= 1 << 31
    rng = np.random.default_rng(7)
    codes = np.where(rng.random((3, 300)) < 0.5, 2047, -2048).astype(np.int16)
    state = np.zeros((3, 5, 10), np.int16)
    jf, js = jfp.int_fex_scan(jnp.asarray(codes), jnp.asarray(coef),
                              jnp.asarray(state), j_fmt, frame_shift=128,
                              backend="xla")
    tf, ts = tfp.int_fex_scan(_t(codes), _t(coef), _t(state), t_fmt,
                              frame_shift=128, backend="pallas")
    _eq(tf, jf)
    _eq(ts, js)
    assert int(((ts[:, :4] == 32767) | (ts[:, :4] == -32768)).sum()) > 0


@pytest.mark.parametrize("B,T,frame_shift,kind", [
    (1, 300, 128, "speech"), (3, 203, 64, "speech"), (33, 140, 128, "speech"),
    (4, 130, 37, "speech"), (2, 300, 128, "rails")])
def test_int_fex_ragged_shapes_bit_exact(model, B, T, frame_shift, kind):
    """The kernel's ragged launches — stream groups that do not fill a CTA,
    T not a multiple of frame_shift or of 8, a frame_shift that splits its
    64-sample tiles, and ±full-scale audio from registers at the 16-bit
    rails — through the plain version, against JAX's golden scan."""
    jb, tb = model
    rng = np.random.default_rng(B * T)
    if kind == "rails":
        codes = np.where(rng.random((B, T)) < 0.5, 2047, -2048)
        state = np.where(rng.random((B, 5, 10)) < 0.5, 32767, -32768)
    else:
        audio, _ = jgscd.synth_batch(np.random.default_rng(B), B)
        codes = np.asarray(jfp.to_code(jnp.asarray(audio[:, 2500:2500 + T]),
                                       11, 16, jnp.int16))
        state = rng.integers(-3000, 3000, (B, 5, 10))
    codes, state = codes.astype(np.int16), state.astype(np.int16)
    jf, js = jfp.int_fex_scan(jnp.asarray(codes), jb.coef,
                              jnp.asarray(state), jb.ffmt,
                              frame_shift=frame_shift, backend="xla")
    tf, ts = tfp.int_fex_scan(_t(codes), tb.coef, _t(state), tb.ffmt,
                              frame_shift=frame_shift, backend="pallas")
    assert tf.shape == (B, T // frame_shift, 10)
    _eq(tf, jf)
    _eq(ts, js)
