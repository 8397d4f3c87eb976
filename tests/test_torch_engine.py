"""Port conformance, the pipelined engine: repro_torch's ``PipelinedEngine``
and its loop drivers against the JAX package's, on the same numpy inputs.

Three families:

* fake-clock telemetry: both engines around the same stub session with
  the same scripted clock give equal reports (every key and number);
* conformance under faults: ``run_audio_requests`` and
  ``run_continuous_detect`` at depth 1, 2 and 3 under an
  ``adversarial_plan`` (NaN/Inf bursts, DC, clipping, zero-length,
  one-sample, dropped and duplicated chunks, churn storms), with the
  supervisor healing and, in the audio loop, an admission controller
  moving Δ_TH: every depth equal to every other, decision for decision
  and counter for counter, and to the JAX package's loop at depth 1;
* the CPU form of the CUDA pieces: the upload's and the fetch's
  plain paths.

The weights are the JAX package's ``init_kws`` tree at SMOKE_CONFIG
(d_model 16).  The JAX sessions run their plain references
(``backend="xla"``, ``fex_backend="xla"``); the port's run on the CPU,
through its kernels' plain versions.  Tolerances: port depths against
each other — every decision, fire, counter and summary field equal;
port against JAX — decisions, fires, frame counts, recoveries and
reasons equal, and the summary's sparsity equal (float32 transmit
counts are equal; only float logits differ, within 1e-5, and no
decision here sits that close to a tie).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.frontend import vad as jvad
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import engine as jengine
from repro.launch import faults as jfaults
from repro.launch import serve as jserve
from repro.launch import streaming as jstream
from repro.models import detector as jdet
from repro.models import kws as jkws
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.frontend import vad as tvad
from repro_torch.launch import engine as tengine
from repro_torch.launch import faults as tfaults
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.models import detector as tdet
from repro_torch.models import kws as tkws

TH = 0.1
UTT, CHUNK, REQUESTS, SLOTS = 768, 256, 6, 2
PLAN = dict(nan_rate=0.2, structure_rate=0.2, churn_rate=0.2,
            stall_rate=0.0)
# A plan seed under which every non-stall fault kind fires within the
# runs' first seven steps (NaN and Inf bursts, DC, clip, zero-length,
# one-sample, dropped and duplicated chunks, churn storms).
PLAN_SEED = 29
DET_SAMPLES = 7 * CHUNK              # the detect loops' seven steps
DET = dict(smooth_alpha=0.3, fire_threshold=0.09, release_threshold=0.088,
           refractory_frames=3)
VAD = dict(energy_threshold=0.02, hangover_frames=6)


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Fake clock + stub sessions: the telemetry math with no device

class FakeClock:
    """Monotonic clock advancing by a scripted amount per call."""

    def __init__(self, ticks):
        self.ticks = list(ticks)
        self.now = 0.0

    def __call__(self):
        if self.ticks:
            self.now += self.ticks.pop(0)
        return self.now


class _Out:
    def __init__(self, votes):
        self.votes = votes


class StubSession:
    """Shape-compatible stand-in: 4 frames per piece, no device; numpy
    votes for the JAX engine, torch votes for the port's."""

    def __init__(self, torch_out: bool, batch=2):
        self.batch = batch
        self._torch = torch_out

    def process_audio(self, piece):
        v = np.zeros((4, self.batch), np.int32)
        return _Out(torch.from_numpy(v) if self._torch else v)


class _Sched:
    def __init__(self, occ):
        self.occ = occ

    def occupancy(self):
        return self.occ


def _drive(mod, torch_out, depth, ticks, steps, reset_after=None):
    eng = mod.PipelinedEngine(StubSession(torch_out), depth=depth,
                              scheduler=_Sched([3]), clock=FakeClock(ticks))
    seen = []
    for i in range(steps):
        eng.begin()
        meta = []
        frames, drained = eng.submit([None] * (1 + i % 2), meta=meta)
        meta.append(i)
        eng.end()
        seen.append((frames, [(f.index, f.n_frames, f.piece_frames)
                              for f in drained], eng.in_flight))
        if reset_after == i:
            eng.reset_telemetry()
    tail = [(f.index, f.meta, [a.shape for a in f.arrays])
            for f in eng.flush()]
    return eng.report(), seen, tail


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fake_clock_report_matches_jax(depth):
    """Scripted clock, 1- and 2-piece steps, a reset_telemetry midway:
    equal reports, drain order, in-flight counts and metadata."""
    rng = np.random.default_rng(depth)
    ticks = list(rng.uniform(0.0, 0.01, 200))
    for reset_after in (None, 2):
        want = _drive(jengine, False, depth, ticks, 6, reset_after)
        got = _drive(tengine, True, depth, ticks, 6, reset_after)
        assert got == want
    rep = got[0]
    assert rep["depth"] == depth and rep["shard_imbalance"]["max"] == 0


def test_fake_clock_phase_attribution():
    """depth 1: the fetch happens inside submit; each phase lands in its
    own bucket (the reference's worked example)."""
    clk = FakeClock([0.0, 0.001, 0.002, 0.0, 0.003, 0.001])
    eng = tengine.PipelinedEngine(StubSession(True), depth=1, clock=clk)
    eng.begin()
    piece_frames, drained = eng.submit([None])
    eng.end()
    assert piece_frames == [4] and len(drained) == 1
    hb = eng.report()["host_blocked_ms_per_step"]
    assert (hb["assemble"], hb["dispatch"], hb["fetch"]) == \
        pytest.approx((1.0, 2.0, 3.0))
    assert eng.report()["step_ms"]["p50"] == pytest.approx(7.0)
    assert eng.report()["e2e_ms"]["p50"] == pytest.approx(6.0)
    with pytest.raises(ValueError, match="depth"):
        tengine.PipelinedEngine(StubSession(True), depth=0)


def test_cpu_paths_of_the_cuda_pieces():
    """On the CPU an upload copies (no pinned memory, no events) and the
    fetch hands back the tensors themselves."""
    cpu = torch.device("cpu")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tstream._upload(a, cpu, torch.float32)
    a[0, 0] = 99.0                                  # the upload is a copy
    assert t.dtype == torch.float32 and t[0, 0] == 0.0
    mask = tstream._upload(np.array([True, False]), cpu, torch.bool)
    assert mask.dtype == torch.bool and mask.tolist() == [True, False]
    host, event = tengine._start_fetch([t])
    assert event is None and host[0] is t
    assert tengine._start_fetch([]) == ((), None)


# ---------------------------------------------------------------------------
# Conformance under faults: depth 1 == 2 == 3 == the JAX loop

def _audio_q():
    rng = np.random.default_rng(11)
    return rng.uniform(-0.5, 0.5, (REQUESTS, UTT)).astype(np.float32)


def _audio_run(mod, sess, depth, monkeypatch):
    """One utterance-loop run; also returns every stream life's vote
    tally (each ``_Incarnation`` the loop created, in creation order), so
    a vote credited to the wrong life shows even where the argmax does
    not move."""
    lives = []

    class Recorded(mod._Incarnation):
        __slots__ = ()

        def __init__(self, *args):
            super().__init__(*args)
            lives.append(self)

    monkeypatch.setattr(mod, "_Incarnation", Recorded)
    faults = tfaults if mod is tengine else jfaults
    serve = tserve if mod is tengine else jserve
    stream = tstream if mod is tengine else jstream
    sched = stream.SlotScheduler(sess)
    ctl = serve.AdmissionController(sess, sched, serve.OverloadPolicy(
        thresholds=(TH, 0.4), max_queue=4, high_water=0.5, up_after=1,
        down_after=2))
    for req in range(REQUESTS):
        ctl.submit(req)
    injector = faults.FaultInjector(
        faults.adversarial_plan(PLAN_SEED, **PLAN), SLOTS)
    done, stats = mod.run_audio_requests(
        sess, sched, ctl, audio_q=_audio_q(), chunk=CHUNK,
        chunks_per_utt=UTT // CHUNK, real_frames=UTT // 128,
        injector=injector, depth=depth, warm=False)
    tallies = [(life.req, life.counts.tolist(), life.progress)
               for life in lives]
    return done, stats, ctl.stats(), sess.summary(), tallies


def _port_session(weights, numerics, **kw):
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(weights[1]), T_SMOKE, threshold=TH,
        batch=SLOTS, device="cpu", numerics=numerics, input_policy="trust",
        supervisor=tstream.SupervisorConfig(), **kw)


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_audio_loop_depths_equal_and_match_jax(weights, numerics,
                                              monkeypatch):
    """The utterance loop under faults, churn, re-admission and a moving
    Δ_TH: depth 2 and 3 equal depth 1 in every decision, loop counter,
    controller stat and summary field (timing aside), and depth 1 equals
    the JAX package's loop."""
    runs = {d: _audio_run(tengine, _port_session(weights, numerics), d,
                          monkeypatch) for d in (1, 2, 3)}
    done1, stats1, ctl1, summ1, lives1 = runs[1]
    for d in (2, 3):
        done, stats, ctl, summ, lives = runs[d]
        assert done == done1 and ctl == ctl1 and lives == lives1
        for key in ("steps", "frames_served", "pad_frames"):
            assert stats[key] == stats1[key]
        assert stats["slo"]["depth"] == d
        assert dataclasses.replace(summ, slo={}) == \
            dataclasses.replace(summ1, slo={})
    js = jstream.StreamingKwsSession(
        weights[0], J_SMOKE, threshold=TH, batch=SLOTS, fex=JFex(),
        backend="xla", fex_backend="xla", numerics=numerics,
        input_policy="trust", supervisor=jstream.SupervisorConfig())
    jdone, jstats, jctl, jsumm, jlives = _audio_run(jengine, js, 1,
                                                    monkeypatch)
    assert done1 == jdone and len(done1) == REQUESTS - ctl1["shed"]
    assert lives1 == jlives and len(lives1) > len(done1)   # churn lives
    assert ctl1 == jctl and ctl1["escalations"] >= 1
    for key in ("steps", "frames_served", "pad_frames"):
        assert stats1[key] == jstats[key]
    for f in ("frames", "chunks", "sparsity", "recoveries",
              "recovery_reasons", "sat_events", "overflowed"):
        assert getattr(summ1, f) == getattr(jsumm, f), f
    assert summ1.recoveries >= 1
    assert stats1["slo"].keys() == jstats["slo"].keys()


def _streams():
    from repro.data import continuous as jcont
    streams = jcont.make_streams(100, SLOTS, duration_s=0.5, snr_db=20.0,
                                 events_per_min=240.0)
    return [s.audio[:DET_SAMPLES] for s in streams]


def _detect_run(mod, sess, depth):
    faults = tfaults if mod is tengine else jfaults
    injector = faults.FaultInjector(faults.adversarial_plan(PLAN_SEED, **PLAN),
                                    SLOTS)
    fires, base, stats = mod.run_continuous_detect(
        sess, _streams(), chunk=CHUNK, n_samples=DET_SAMPLES,
        injector=injector, depth=depth, warm=False)
    return fires, base, stats, sess.summary()


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_detect_loop_depths_equal_and_match_jax(weights, numerics):
    """The always-on loop under faults (fault actions before dispatch):
    every fire and frame offset and the summary equal at depth 1, 2 and
    3, and equal to the JAX package's loop."""
    def port():
        return _port_session(weights, numerics,
                             detector=tdet.DetectorConfig(**DET),
                             vad=tvad.VADConfig(**VAD))
    runs = {d: _detect_run(tengine, port(), d) for d in (1, 2, 3)}
    fires1, base1, stats1, summ1 = runs[1]
    for d in (2, 3):
        fires, base, stats, summ = runs[d]
        assert fires == fires1 and base == base1
        assert stats["steps"] == stats1["steps"]
        assert dataclasses.replace(summ, slo={}) == \
            dataclasses.replace(summ1, slo={})
    js = jstream.StreamingKwsSession(
        weights[0], J_SMOKE, threshold=TH, batch=SLOTS, fex=JFex(),
        backend="xla", fex_backend="xla", numerics=numerics,
        input_policy="trust", supervisor=jstream.SupervisorConfig(),
        detector=jdet.DetectorConfig(**DET), vad=jvad.VADConfig(**VAD))
    jfires, jbase, jstats, jsumm = _detect_run(jengine, js, 1)
    assert fires1 == jfires and base1 == jbase
    assert any(fires1)                               # the head fired
    for f in ("frames", "chunks", "sparsity", "vad_duty", "recoveries",
              "recovery_reasons"):
        assert getattr(summ1, f) == getattr(jsumm, f), f
    assert summ1.recoveries >= 1


def test_cascade_loop_depths_equal(weights):
    """The cascade session through the same loop under faults: depth 2
    equals depth 1 in every fire, wake count and summary field."""
    cfg0 = dataclasses.replace(J_SMOKE, vocab_size=2, d_model=16)
    jp0, _ = jkws.init_kws(jax.random.PRNGKey(7), cfg0, input_dim=4)
    p0 = {k: np.asarray(v) for k, v in jp0.items()}

    def port():
        return _port_session(
            weights, "int8", detector=tdet.DetectorConfig(**DET),
            vad=tvad.VADConfig(**VAD),
            cascade=tstream.CascadeConfig(
                wake_threshold=0.40, sleep_threshold=0.39,
                hangover_frames=3, s0_threshold=0.05, s0_channels=4),
            stage0_params=tkws.params_from_numpy(p0))
    (f1, b1, _, s1), (f2, b2, _, s2) = (_detect_run(tengine, port(), d)
                                        for d in (1, 2))
    assert f2 == f1 and b2 == b1
    assert dataclasses.replace(s2, slo={}) == dataclasses.replace(s1, slo={})
    assert 0.0 < s1.stage1_duty < 1.0
