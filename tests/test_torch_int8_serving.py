"""Port conformance, int8 serving: repro_torch's ``numerics="int8"``
session and serve CLI against the JAX package's, with the same weights
and audio.

The JAX session runs its golden scans (``backend="xla"``,
``fex_backend="xla"``); the port's session runs on the CPU, i.e. through
its integer kernels' plain versions.  Everything must be equal: the
integer FEx registers and the ΔGRU's codes are exact integer arithmetic,
and the float σ/tanh/log2 are XLA's own expansions in the port
(``kernels/xla_math.py``), so votes, transmit counts and logit codes
match too (tests/test_torch_fixed_point.py holds them frame by frame).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.deltakws import CONFIG as J_CONFIG
from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.core import delta_gru as jdg
from repro.core import fixed_point as jfp
from repro.data import gscd as jgscd
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import streaming as jstream
from repro.models import kws as jkws
from repro.train import promote as jpromote
from repro_torch.configs.deltakws import CONFIG as T_CONFIG
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.models import kws as tkws

TH = 0.1


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


def _port(np_params, batch):
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_params), T_SMOKE, threshold=TH,
        batch=batch, device="cpu", numerics="int8")


def test_int8_session_unaligned_chunks_match_jax(weights):
    """Two streams of keyword audio in chunks of 300, 1, 400 and 399
    samples (the host remainder carry, a 1-sample chunk included)."""
    jparams, np_params = weights
    audio, _ = jgscd.synth_batch(np.random.default_rng(0), 2)
    audio = audio[:, 2000:3100]
    js = jstream.StreamingKwsSession(jparams, J_SMOKE, threshold=TH,
                                     batch=2, fex=JFex(), backend="xla",
                                     fex_backend="xla", numerics="int8")
    ts = _port(np_params, 2)
    outs_j, outs_t, lo = [], [], 0
    for n in (300, 1, 400, 399):
        outs_j.append(js.process_audio(audio[:, lo:lo + n]))
        outs_t.append(ts.process_audio(audio[:, lo:lo + n]))
        lo += n
    got = {f: torch.cat([getattr(o, f) for o in outs_t]).numpy()
           for f in ("logits", "votes", "nz")}
    want = {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs_j])
            for f in ("logits", "votes", "nz")}
    assert got["votes"].shape == want["votes"].shape == (8, 2)
    for f in ("votes", "nz", "logits"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for t, j in zip(ts.fex_state, js.fex_state):          # integer FEx
        assert t.dtype == torch.int16
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(ts.state.x_hat.numpy(),
                                  np.asarray(js.state.x_hat))
    assert ts.threshold == js.threshold == TH
    sj, st = js.summary(), ts.summary()
    assert st.frames == sj.frames == 16 and st.chunks == sj.chunks == 3
    assert st.fex_samples == sj.fex_samples
    assert st.sparsity == sj.sparsity
    assert ts.unhealthy_slots() == {}


def test_int8_reset_streams_isolates_one_slot(weights):
    _, np_params = weights
    ts = _port(np_params, 2)
    rng = np.random.default_rng(1)
    ts.process_audio((0.3 * rng.standard_normal((2, 384))).astype(
        np.float32))
    before0 = [t[0].clone() for t in (*ts.state, *ts.fex_state)]
    ts.reset_streams([1])
    fresh = _port(np_params, 2)
    fresh.process_audio(np.zeros((2, 0), np.float32))
    for got, want, keep in zip((*ts.state, *ts.fex_state),
                               (*fresh.state, *fresh.fex_state), before0):
        assert got.dtype == want.dtype and not got.is_floating_point()
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], keep, rtol=0, atol=0)
    assert not torch.equal(ts.state.h[0], fresh.state.h[0])


def test_health_sat_on_a_rail_pinned_accumulator(weights):
    """A slot whose accumulator sits at the 24-bit rail is flagged
    HEALTH_SAT (and only that slot), as the JAX package flags it."""
    _, np_params = weights
    ts = _port(np_params, 2)
    zeros = np.zeros((1, 2, 10), np.float32)        # Δx = 0: m_x stays put
    ts.process_chunk(zeros)
    assert ts.unhealthy_slots() == {}
    st = ts.state
    m_x = st.m_x.clone()
    m_x[1] = -(1 << 23)
    ts._state = st._replace(m_x=m_x)
    ts.process_chunk(zeros)
    assert ts.unhealthy_slots() == {1: tstream.HEALTH_SAT}
    want = jstream.slot_health(
        np.zeros(2, bool), None,
        jdg.DeltaState(*(np.asarray(t) for t in ts.state)), None, None)
    np.testing.assert_array_equal(ts._last_health.numpy(), np.asarray(want))


def test_serve_cli_int8_with_and_without_bundle(tmp_path, capsys):
    """``repro_torch.launch.serve --numerics int8 --device cpu``, with a
    bundle that the JAX package promoted and saved, and without one (the
    same float weights promoted in the session): the two serve the same
    codes and formats, and the bundle run decides every request."""
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_CONFIG, input_dim=10)
    np.savez(tmp_path / "w.npz", **{k: np.asarray(v)
                                    for k, v in params.items()})
    jb = jfp.promote_kws(params, 0.2, fex=JFex())
    bundle = jpromote.save_bundle(tmp_path / "b", jb)
    common = ["--mode", "kws-audio", "--device", "cpu", "--slots", "2",
              "--chunk-samples", "4096", "--train-steps", "0"]
    ap = tserve.build_parser()
    args = ap.parse_args(common + ["--requests", "2", "--bundle",
                                   str(bundle)])
    sess, done, labels, stats, _ = tserve.serve_kws_audio(args)
    assert args.numerics == "int8" and sess.numerics == "int8"
    assert sorted(r for r, _ in done) == [0, 1] and stats["steps"] == 2
    assert sess.summary().frames == 2 * 2 * 4096 // 128
    assert tserve.main(common + ["--requests", "0", "--numerics", "int8",
                                 "--threshold", "0.2", "--params",
                                 str(tmp_path / "w.npz")]) == 0
    assert "[int8, Δ_TH 0.2]" in capsys.readouterr().out
    promoted = tstream.StreamingKwsSession(
        tkws.load_npz_params(tmp_path / "w.npz"), T_CONFIG, threshold=0.2,
        device="cpu", numerics="int8")
    promoted._require_fex()
    for got, want in ((promoted._bundle.gru.w_h, sess._bundle.gru.w_h),
                      (promoted._bundle.w_fc, sess._bundle.w_fc),
                      (promoted._bundle.coef, sess._bundle.coef)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert promoted._bundle.gfmt == sess._bundle.gfmt
    assert promoted._bundle.ffmt == sess._bundle.ffmt
