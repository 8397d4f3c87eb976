"""Port conformance, detection serving: repro_torch's detect-mode session,
detect loop and ``serve --mode kws-detect`` against the JAX package's,
with the same weights and audio.

The weights are the JAX package's ``init_kws`` tree at SMOKE_CONFIG
(d_model 16, 12 classes), random: the fire threshold sits just above
the uniform posterior 1/12, where such a model fires, and every
comparison asserts that it did.  The JAX session runs its plain
references (``backend="xla"``, ``fex_backend="xla"``); the port's runs on
the CPU, i.e. through its kernels' plain versions.  Tolerances: int8 —
every logit code, vote, transmit count, event, gate, state and summary
number equal; float32 — the same, except the logits within 1e-5 (the FC
product is summed in another order) and the smoothed posteriors within
1e-5 of the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.data import continuous as jcont
from repro.frontend import vad as jvad
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import streaming as jstream
from repro.models import detector as jdet
from repro.models import kws as jkws
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.frontend import vad as tvad
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.models import detector as tdet
from repro_torch.models import kws as tkws

TH = 0.1
ATOL = 1e-5
DET = dict(smooth_alpha=0.3, fire_threshold=0.09, release_threshold=0.088,
           refractory_frames=3)
VAD = dict(energy_threshold=0.02, hangover_frames=6)
CHUNKS = (2500, 1, 3499)           # unaligned, a frame-less chunk among them


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def audio():
    streams = jcont.make_streams(100, 2, duration_s=1.0, snr_db=20.0,
                                 events_per_min=120.0)
    return np.stack([s.audio[:sum(CHUNKS)] for s in streams])


def _port(np_params, numerics, batch=2, det=DET, vad=VAD):
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_params), T_SMOKE, threshold=TH,
        batch=batch, device="cpu", numerics=numerics,
        detector=tdet.DetectorConfig(**det),
        vad=None if vad is None else tvad.VADConfig(**vad))


def _jax(jparams, numerics, batch=2):
    return jstream.StreamingKwsSession(
        jparams, J_SMOKE, threshold=TH, batch=batch, fex=JFex(),
        backend="xla", fex_backend="xla", numerics=numerics,
        detector=jdet.DetectorConfig(**DET), vad=jvad.VADConfig(**VAD))


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_detect_session_matches_jax(weights, audio, numerics):
    jparams, np_params = weights
    js, ts = _jax(jparams, numerics), _port(np_params, numerics)
    outs_j, outs_t, lo = [], [], 0
    for n in CHUNKS:
        outs_j.append(js.process_audio(audio[:, lo:lo + n]))
        outs_t.append(ts.process_audio(audio[:, lo:lo + n]))
        lo += n
    assert isinstance(outs_t[1], tstream.DetectResult)
    assert outs_t[1].events.shape == outs_t[1].gate.shape == (0, 2)
    fields = [f for f in tstream.DetectResult._fields if f != "awake"]
    got = {f: torch.cat([getattr(o, f) for o in outs_t]).numpy()
           for f in fields}
    want = {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs_j])
            for f in fields}
    assert got["events"].shape == (46, 2)
    for f in ("votes", "nz", "events", "gate"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (got["events"] >= 0).sum() >= 2, "the head never fired"
    assert 0 < got["gate"].mean() < 1
    exact = numerics == "int8"
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=0 if exact else ATOL)
    for t, j in zip(ts.vad_state, js._vad_state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for name in ("active", "refract"):
        np.testing.assert_array_equal(getattr(ts.det_state, name).numpy(),
                                      np.asarray(getattr(js._det_state,
                                                         name)))
    np.testing.assert_allclose(ts.det_state.smooth.numpy(),
                               np.asarray(js._det_state.smooth), rtol=0,
                               atol=0 if exact else ATOL)
    sj, st = js.summary(), ts.summary()
    assert (st.frames, st.chunks) == (sj.frames, sj.chunks) == (92, 2)
    assert st.vad_duty == sj.vad_duty and 0 < st.vad_duty < 1
    assert st.vad_energy_nj_per_decision == sj.vad_energy_nj_per_decision > 0
    assert st.sparsity == sj.sparsity
    assert st.energy_nj_per_decision == sj.energy_nj_per_decision
    assert ts.unhealthy_slots() == {}


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_detect_reset_stream_equals_fresh(weights, audio, numerics):
    """Slot 1 is reset after a chunk; on the next chunk it must give what
    a fresh session gives, state and events, and slot 0 runs on."""
    _, np_params = weights
    a, b = audio[:, :1280], audio[:, 1280:2560]
    ts = _port(np_params, numerics)
    ts.process_audio(a)
    keep = [t[0].clone() for t in (*ts.vad_state, *ts.det_state)]
    ts.reset_stream(1)
    for t, k in zip((*ts.vad_state, *ts.det_state), keep):
        assert torch.equal(t[0], k)
    fresh = _port(np_params, numerics)
    out, out_f = ts.process_audio(b), fresh.process_audio(b)
    for f in ("events", "gate", "votes", "logits"):
        assert torch.equal(getattr(out, f)[:, 1], getattr(out_f, f)[:, 1]), f
    for got, want in zip((*ts.state, *ts.fex_state, *ts.vad_state,
                          *ts.det_state),
                         (*fresh.state, *fresh.fex_state, *fresh.vad_state,
                          *fresh.det_state)):
        assert got.dtype == want.dtype
        assert torch.equal(got[1], want[1])
    hold = ts.vad_state.hold
    assert hold.dtype == (torch.int16 if numerics == "int8"
                          else torch.float32)
    ts.reset()
    assert not ts.det_state.smooth.any() and not ts.vad_state.hang.any()
    assert ts.summary().frames == 0


def test_detect_health_bits_on_poisoned_state(weights, audio):
    """A NaN VAD hold flags HEALTH_VAD, an EMA outside [0, 1] HEALTH_DET,
    on those slots only, as the JAX package's ``slot_health`` flags the
    same state; an int16 code hold never flags."""
    _, np_params = weights
    ts = _port(np_params, "float32", batch=3)
    ts.process_audio(audio[[0, 1, 0], :1280])
    assert ts.unhealthy_slots() == {}
    vs, ds = ts.vad_state, ts.det_state
    hold, smooth = vs.hold.clone(), ds.smooth.clone()
    hold[1, 3] = float("nan")
    smooth[2, 5] = 1.5
    vs, ds = vs._replace(hold=hold), ds._replace(smooth=smooth)
    got = tstream.slot_health(torch.zeros(3, dtype=torch.bool), None, None,
                              vs, ds)
    want = jstream.slot_health(
        np.zeros(3, bool), None, None,
        jvad.VADState(*(np.asarray(t) for t in vs)),
        jdet.DetectorState(*(np.asarray(t) for t in ds)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, tstream.HEALTH_VAD, tstream.HEALTH_DET]
    ds = ds._replace(smooth=torch.where(torch.arange(3)[:, None] == 0,
                                        float("nan"), ds.smooth))
    ts._vad_state, ts._det_state = vs, ds
    ts.process_audio(np.zeros((3, 128), np.float32))
    flags = ts.unhealthy_slots()
    assert flags[0] & tstream.HEALTH_DET and flags[2] & tstream.HEALTH_DET
    assert tstream.HEALTH_REASONS[tstream.HEALTH_VAD] == "vad_state"
    int_state = tvad.init_vad_state(2, 10, torch.int16)
    assert not tstream.slot_health(torch.zeros(2, dtype=torch.bool), None,
                                   None, int_state, None).any()


@pytest.mark.parametrize("case", ["vad-without-detector", "inverted-band",
                                  "inverted-per-keyword",
                                  "process-chunk"])
def test_detect_session_value_errors(weights, case):
    params = tkws.params_from_numpy(weights[1])
    det = tdet.DetectorConfig(fire_threshold=0.3, release_threshold=0.4)
    if case == "vad-without-detector":
        with pytest.raises(ValueError, match="part of detection mode"):
            tstream.StreamingKwsSession(params, T_SMOKE, device="cpu",
                                        vad=tvad.VADConfig())
    elif case == "inverted-band":
        with pytest.raises(ValueError, match="inverted hysteresis band"):
            tstream.StreamingKwsSession(params, T_SMOKE, device="cpu",
                                        detector=det)
    elif case == "inverted-per-keyword":
        rel = (0.3,) * 9 + (0.6,)
        with pytest.raises(ValueError, match="inverted hysteresis band"):
            tstream.StreamingKwsSession(
                params, T_SMOKE, device="cpu",
                detector=tdet.DetectorConfig(fire_threshold=(0.5,) * 10,
                                             release_threshold=rel))
    else:
        s = tstream.StreamingKwsSession(params, T_SMOKE, device="cpu",
                                        detector=tdet.DetectorConfig())
        with pytest.raises(ValueError, match="needs raw audio"):
            s.process_chunk(np.zeros((2, 10), np.float32))


def test_vad_off_session_duty_and_energy(weights, audio):
    """VAD_OFF: every gate open, duty 1.0 and no VAD energy, features
    as without a VAD (the ΔGRU's transmit counts equal a plain audio
    session's)."""
    _, np_params = weights
    ts = _port(np_params, "int8", vad=tvad.VAD_OFF._asdict())
    plain = tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_params), T_SMOKE, threshold=TH, batch=2,
        device="cpu", numerics="int8")
    out, ref = ts.process_audio(audio[:, :1280]), \
        plain.process_audio(audio[:, :1280])
    assert bool(out.gate.all())
    assert torch.equal(out.nz, ref.nz) and torch.equal(out.votes, ref.votes)
    summ = ts.summary()
    assert summ.vad_duty == 1.0 and summ.vad_energy_nj_per_decision == 0.0
    assert summ.energy_nj_per_decision == plain.summary().energy_nj_per_decision
    assert plain.summary().vad_duty == 1.0


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_serve_kws_detect_on_cpu(numerics, capsys):
    """The CLI's detect mode, 2 slots × 2 s streams, with a fire threshold
    the random model reaches."""
    argv = ["--mode", "kws-detect", "--device", "cpu", "--slots", "2",
            "--train-steps", "0",
            "--stream-seconds", "2", "--chunk-samples", "1024",
            "--numerics", numerics, "--fire-threshold", "0.09",
            "--release-threshold", "0.085"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"[{numerics}, depth 2]" in out and "FA/hr" in out
    assert "vad duty" in out and "decisions/s" in out


def test_detect_loop_and_cli_checks(weights):
    ap = tserve.build_parser()
    args = ap.parse_args(["--mode", "kws-detect", "--fire-threshold", "0.3",
                          "--release-threshold", "0.3"])
    with pytest.raises(ValueError, match="inverted hysteresis band"):
        tserve.validate_args(args)
    for flag, val in (("--stream-seconds", "0"), ("--events-per-min", "-1"),
                      ("--snr-db", "inf"), ("--tol-s", "-1")):
        with pytest.raises(ValueError, match=flag):
            tserve.validate_args(ap.parse_args(["--mode", "kws-detect",
                                                flag, val]))
    args = ap.parse_args(["--mode", "kws-detect"])
    assert (args.seed, args.init_seed, args.fire_threshold) == (100, 0, 0.4)
    sess = _port(weights[1], "float32", batch=1)
    z = [np.zeros(256, np.float32)]
    with pytest.raises(ValueError, match="depth"):
        tengine.run_continuous_detect(sess, z, chunk=128, n_samples=256,
                                      depth=0)
    for depth in (1, 2):              # the pipelined engine is ported
        sess.reset()
        fires, frames, stats = tengine.run_continuous_detect(
            sess, z, chunk=128, n_samples=256, warm=False, depth=depth)
        assert fires == [[]] and frames == 2 and stats["steps"] == 2
        assert sess.summary().slo["decisions"] == 2
        assert sess.summary().slo["depth"] == depth
