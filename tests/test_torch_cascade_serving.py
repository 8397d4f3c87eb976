"""Port conformance, cascade serving: repro_torch's two-stage wake cascade
session and ``serve --mode kws-cascade`` against the JAX package's, with
the same weights and audio.

Stage 1 is the JAX package's ``init_kws`` tree at SMOKE_CONFIG (d_model
16, 12 classes), stage 0 its ``init_kws`` at 16 units with a binary head
over 4 channels (seed 7, as the reference's CLI seeds it); both random.
A random binary head scores near 0.5, so the wake and sleep thresholds
are taken from the scores of this audio (0.32–0.5 here), such that slots
wake, sleep and wake again, and every test asserts that they did and
that the head fired on an awake frame.  The JAX session runs its plain
references (``backend="xla"``, ``fex_backend="xla"``); the port's runs
on the CPU, i.e. through its kernels' plain versions.  Tolerances: int8
— every logit code, vote, transmit count, awake bit, event, gate, state
and summary number equal; float32 — awake traces, events, gates, votes
and counts equal, logits and float state within 1e-5 (the products are
summed in another order), summary energies within 1e-9 relative.
"""
import dataclasses

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
# Float: the stage-0 scores equal JAX's only within 1e-5, so a score too
# close to a threshold could flip a wake decision.  These thresholds were
# read off the JAX run's scores, and the test asserts that none lies
# within 1e-4 of either.  int8 scores are exact: no margin is needed.
CASCADE = {"float32": (0.405, 0.392), "int8": (0.40, 0.39)}
MARGIN = 1e-4


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    cfg0 = dataclasses.replace(J_SMOKE, vocab_size=2, d_model=16)
    params0, _ = jkws.init_kws(jax.random.PRNGKey(7), cfg0, input_dim=4)
    as_np = lambda p: {k: np.asarray(v) for k, v in p.items()}
    return params, as_np(params), params0, as_np(params0)


@pytest.fixture(scope="module")
def audio():
    streams = jcont.make_streams(100, 2, duration_s=1.0, snr_db=20.0,
                                 events_per_min=120.0)
    return np.stack([s.audio[:sum(CHUNKS)] for s in streams])


def _cfg(numerics, mod):
    wake, sleep = CASCADE[numerics]
    return mod.CascadeConfig(wake_threshold=wake, sleep_threshold=sleep,
                             hangover_frames=3, s0_threshold=0.05,
                             s0_channels=4)


def _port(weights, numerics, batch=2):
    _, np_p, _, np_p0 = weights
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_p), T_SMOKE, threshold=TH, batch=batch,
        device="cpu", numerics=numerics,
        detector=tdet.DetectorConfig(**DET), vad=tvad.VADConfig(**VAD),
        cascade=_cfg(numerics, tstream),
        stage0_params=tkws.params_from_numpy(np_p0))


def _run(sess, audio):
    outs, lo = [], 0
    for n in CHUNKS:
        outs.append(sess.process_audio(audio[:, lo:lo + n]))
        lo += n
    return outs


@pytest.fixture(scope="module", params=["float32", "int8"])
def runs(request, weights, audio):
    """Both sessions over the chunks; the JAX side's stage-0 scores are
    recorded on the way (a debug callback in its wake machine)."""
    numerics = request.param
    jparams, _, jparams0, _ = weights
    scores = []
    orig = jstream.cascade_wake_scan

    def spy(cfg, awake, hang, score):
        jax.debug.callback(lambda s: scores.append(np.array(s)), score)
        return orig(cfg, awake, hang, score)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstream, "cascade_wake_scan", spy)
        js = jstream.StreamingKwsSession(
            jparams, J_SMOKE, threshold=TH, batch=2, fex=JFex(),
            backend="xla", fex_backend="xla", numerics=numerics,
            detector=jdet.DetectorConfig(**DET), vad=jvad.VADConfig(**VAD),
            cascade=_cfg(numerics, jstream), stage0_params=jparams0)
        outs_j = _run(js, audio)
        jax.effects_barrier()
    ts = _port(weights, numerics)
    return numerics, js, ts, outs_j, _run(ts, audio), np.concatenate(scores)


def test_cascade_session_matches_jax(runs):
    numerics, js, ts, outs_j, outs_t, scores = runs
    assert isinstance(outs_t[1], tstream.DetectResult)
    assert outs_t[1].awake.shape == outs_t[1].events.shape == (0, 2)
    fields = tstream.DetectResult._fields
    got = {f: torch.cat([getattr(o, f) for o in outs_t]).numpy()
           for f in fields}
    want = {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs_j])
            for f in fields}
    assert got["awake"].shape == (46, 2) and scores.shape == (46, 2)
    for f in ("awake", "votes", "nz", "events", "gate"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    exact = numerics == "int8"
    if not exact:
        wake, sleep = CASCADE[numerics]
        assert np.abs(scores - wake).min() > MARGIN
        assert np.abs(scores - sleep).min() > MARGIN
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=0 if exact else ATOL)
    # The run is not vacuous: duty strictly between 0 and 1, a slot that
    # wakes and later sleeps, and events only (and some) on awake frames.
    awake, events = got["awake"], got["events"]
    assert 0 < awake.mean() < 1
    assert any(np.any(np.diff(awake[:, b].astype(int)) < 0) and awake[0, b]
               for b in range(2))
    assert (events >= 0).sum() >= 1 and (events[~awake] == -1).all()
    # The carried cascade state: latch and countdown equal; stage 0's
    # delta state equal in int8, within 1e-5 in float.
    for t, j in ((ts.cas_state.awake, js._cas_state.awake),
                 (ts.cas_state.hang, js._cas_state.hang)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(ts.cas_state.s0, js._cas_state.s0):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=0 if exact else ATOL)
    for t, j in zip(ts.state, js._state):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=0 if exact else ATOL)
    np.testing.assert_array_equal(ts.det_state.active.numpy(),
                                  np.asarray(js._det_state.active))


def test_cascade_summary_matches_jax(runs):
    numerics, js, ts, _, _, _ = runs
    sj, st = js.summary(), ts.summary()
    assert (st.frames, st.chunks) == (sj.frames, sj.chunks) == (92, 2)
    assert st.frames_entered_stage1 == sj.frames_entered_stage1
    assert 0 < st.frames_entered_stage1 < st.frames
    assert st.stage1_duty == sj.stage1_duty
    assert st.vad_duty == sj.vad_duty
    for f in ("s0_energy_nj_per_decision", "energy_nj_per_decision",
              "latency_ms", "sparsity", "dense_energy_nj"):
        a, b = getattr(st, f), getattr(sj, f)
        if numerics == "int8":
            assert a == b, f
        else:
            assert a == pytest.approx(b, rel=1e-9, abs=0), f
    assert st.s0_energy_nj_per_decision > 0
    assert ts.unhealthy_slots() == {}


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_cascade_reset_stream_equals_fresh(weights, audio, numerics):
    """Slot 1 is reset after a chunk; on the next chunk it gives what a
    fresh session gives — awake trace, events, every state including the
    cascade's — while slot 0 runs on."""
    a, b = audio[:, :1280], audio[:, 1280:2560]
    ts = _port(weights, numerics)
    ts.process_audio(a)
    keep = [t[0].clone() for t in (ts.cas_state.awake, ts.cas_state.hang,
                                   *ts.cas_state.s0)]
    ts.reset_stream(1)
    for t, k in zip((ts.cas_state.awake, ts.cas_state.hang,
                     *ts.cas_state.s0), keep):
        assert torch.equal(t[0], k)
    fresh = _port(weights, numerics)
    out, out_f = ts.process_audio(b), fresh.process_audio(b)
    for f in ("awake", "events", "gate", "votes", "logits"):
        assert torch.equal(getattr(out, f)[:, 1], getattr(out_f, f)[:, 1]), f
    cas = lambda s: (s.cas_state.awake, s.cas_state.hang, *s.cas_state.s0)
    for got, want in zip((*ts.state, *ts.fex_state, *cas(ts)),
                         (*fresh.state, *fresh.fex_state, *cas(fresh))):
        assert got.dtype == want.dtype
        assert torch.equal(got[1], want[1])
    ts.reset()
    assert not ts.cas_state.awake.any() and not ts.cas_state.hang.any()
    assert ts.summary().frames == 0


@pytest.mark.parametrize("case", ["no-detector", "no-stage0", "inverted",
                                  "negative-hangover", "channels"])
def test_cascade_session_value_errors(weights, case):
    _, np_p, _, np_p0 = weights
    params = tkws.params_from_numpy(np_p)
    p0 = tkws.params_from_numpy(np_p0)
    det = tdet.DetectorConfig()
    kw = dict(detector=det, cascade=tstream.CascadeConfig(), stage0_params=p0)
    match = {"no-detector": "pass a DetectorConfig",
             "no-stage0": "pass stage0_params",
             "inverted": "inverted wake hysteresis",
             "negative-hangover": "hangover_frames must be >= 0",
             "channels": "consumes 4 channels"}[case]
    if case == "no-detector":
        kw["detector"] = None
    elif case == "no-stage0":
        kw["stage0_params"] = None
    elif case == "inverted":
        kw["cascade"] = tstream.CascadeConfig(wake_threshold=0.3,
                                              sleep_threshold=0.4)
    elif case == "negative-hangover":
        kw["cascade"] = tstream.CascadeConfig(hangover_frames=-1)
    else:
        kw["cascade"] = tstream.CascadeConfig(s0_channels=5)
    with pytest.raises(ValueError, match=match):
        tstream.StreamingKwsSession(params, T_SMOKE, device="cpu", **kw)


def test_detect_result_awake_is_none_outside_cascade(weights, audio):
    _, np_p, _, _ = weights
    ts = tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_p), T_SMOKE, threshold=TH, batch=2,
        device="cpu", detector=tdet.DetectorConfig(**DET))
    assert ts.process_audio(audio[:, :1280]).awake is None
    assert ts.process_audio(audio[:, :5]).awake is None
    assert ts.cas_state is None
    summ = ts.summary()
    assert summ.stage1_duty == 1.0 and summ.frames_entered_stage1 == 0


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_serve_kws_cascade_on_cpu(numerics, capsys):
    """The CLI's cascade mode, 2 slots × 2 s streams, the session driven by
    ``run_continuous_detect`` as kws-detect drives its own."""
    argv = ["--mode", "kws-cascade", "--device", "cpu", "--slots", "2",
            "--train-steps", "0",
            "--stream-seconds", "2", "--chunk-samples", "4096",
            "--numerics", numerics, "--fire-threshold", "0.09",
            "--release-threshold", "0.085", "--wake-threshold", "0.45",
            "--sleep-threshold", "0.4"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"[{numerics}, depth 2]" in out
    for text in ("stage-1 duty", "miss rate", "stage-0", "FA/hr",
                 "decisions/s"):
        assert text in out, text


def test_cascade_cli_checks():
    ap = tserve.build_parser()
    args = ap.parse_args(["--mode", "kws-cascade"])
    assert (args.wake_threshold, args.sleep_threshold, args.hangover_frames,
            args.s0_channels, args.s0_threshold) == (0.5, 0.25, 15, 4, 0.05)
    for flags, match in ((["--wake-threshold", "0.2"], "--sleep-threshold"),
                         (["--hangover-frames", "-1"], "--hangover-frames"),
                         (["--s0-channels", "0"], "--s0-channels"),
                         (["--s0-threshold", "nan"], "--s0-threshold"),
                         (["--fire-threshold", "0.3", "--release-threshold",
                           "0.3"], "inverted hysteresis band")):
        with pytest.raises(ValueError, match=match):
            tserve.validate_args(ap.parse_args(["--mode", "kws-cascade",
                                                *flags]))
    p0 = tserve.stage0_params(args)
    assert p0["w_x"].shape == (4, 48) and p0["w_fc"].shape == (16, 2)
