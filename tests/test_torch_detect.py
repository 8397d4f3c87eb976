"""Port conformance, detection building blocks: repro_torch's noise beds,
vocabularies, continuous streams, energy VAD, detection head and DET
scoring against the JAX package's, on the same numpy inputs.

Tolerance 0 throughout.  The data modules are numpy copies: the same
``np.random.Generator`` state gives the same arrays.  The VAD only
selects and counts, so its closed form (``vad_gate``) equals the
reference's frame scan and the port's own frame loop (``vad_gate_loop``)
bit for bit.  The detection head's plain version (``detect_head_ref``:
``xla_softmax`` then ``detector_scan``) repeats XLA:CPU's softmax (its
exp, a NaN-keeping max, the sum in XLA's order, flush-to-zero) and the
EMA's fused multiply-add, so posteriors, smoothed state and events equal
``jax.nn.softmax`` + ``detector_scan``; the ``xla_fma`` fixture skips,
saying so, on a host where XLA does not fuse.  The scoring functions are
host numpy and must give the same counts and rates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import continuous as jcont
from repro.data import gscd as jgscd
from repro.data import noise as jnoise
from repro.frontend import vad as jvad
from repro.models import detector as jdet
from repro_torch.core.quantize import quantize_audio_12b
from repro_torch.data import continuous as tcont
from repro_torch.data import gscd as tgscd
from repro_torch.data import noise as tnoise
from repro_torch.frontend import vad as tvad
from repro_torch.kernels import detect_head as tdh
from repro_torch.models import detector as tdet


@pytest.fixture(scope="module")
def xla_fma():
    """Skip where XLA on this host does not contract a*b + c."""
    a, b, c = (np.float32(1 + 2.0 ** -12),) * 2 + (np.float32(-1),)
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    if fused == (a * b) + c:
        pytest.skip("XLA does not fuse multiply-adds on this host (no FMA)")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _equal(port, ref, what=""):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape and p.dtype == r.dtype, (what, p.dtype, r.dtype)
    np.testing.assert_array_equal(_bits(p), _bits(r), err_msg=what)


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("kind", ["white", "pink", "babble"])
def test_noise_beds_match_jax(kind):
    got = tnoise.noise_bed(np.random.default_rng(5), 3001, kind)
    want = jnoise.noise_bed(np.random.default_rng(5), 3001, kind)
    _equal(got, want, kind)


def test_reverb_matches_jax():
    spec_t = tnoise.ReverbSpec(max_order=2, absorption=0.5)
    spec_j = jnoise.ReverbSpec(max_order=2, absorption=0.5)
    rir = tnoise.image_rir(spec_t)
    _equal(rir, jnoise.image_rir(spec_j))
    x = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    _equal(tnoise.apply_reverb(x, rir), jnoise.apply_reverb(x, rir))


@pytest.mark.parametrize("n_classes", [11, 12, 35])
def test_vocab_and_synth_batch_match_jax(n_classes):
    vt, vj = tgscd.make_vocab(n_classes), jgscd.make_vocab(n_classes)
    assert vt.names == vj.names
    assert vt.first_keyword == vj.first_keyword
    assert vt.keyword_ids == vj.keyword_ids
    assert ({k: dataclasses.astuple(v) for k, v in vt.specs.items()}
            == {k: dataclasses.astuple(v) for k, v in vj.specs.items()})
    at, lt = tgscd.synth_batch(np.random.default_rng(3), 8, vocab=vt)
    aj, lj = jgscd.synth_batch(np.random.default_rng(3), 8, vocab=vj)
    _equal(at, aj)
    _equal(lt, lj)


@pytest.mark.parametrize("case", ["default", "babble-35", "pink-reverb",
                                  "bank"])
def test_make_stream_matches_jax(case):
    kw_t, kw_j = {}, {}
    if case == "babble-35":
        kw_t = dict(noise="babble", vocab=tgscd.make_vocab(35))
        kw_j = dict(noise="babble", vocab=jgscd.make_vocab(35))
    elif case == "pink-reverb":
        kw_t = dict(noise="pink", reverb=tnoise.ReverbSpec(max_order=1))
        kw_j = dict(noise="pink", reverb=jnoise.ReverbSpec(max_order=1))
    elif case == "bank":
        rng = np.random.default_rng(2)
        bank = {c: [rng.standard_normal(900).astype(np.float32)
                    for _ in range(2)] for c in (3, 7)}
        kw_t = kw_j = dict(utterances=bank)
    st = tcont.make_stream(np.random.default_rng(9), duration_s=6.0,
                           events_per_min=40.0, snr_db=5.0, **kw_t)
    sj = jcont.make_stream(np.random.default_rng(9), duration_s=6.0,
                           events_per_min=40.0, snr_db=5.0, **kw_j)
    _equal(st.audio, sj.audio)
    assert [dataclasses.astuple(e) for e in st.events] == \
        [dataclasses.astuple(e) for e in sj.events]
    assert st.events, "the stream holds no keyword"
    assert st.truth_frames() == sj.truth_frames()
    assert (st.keyword_rms, st.noise_rms) == (sj.keyword_rms, sj.noise_rms)
    _equal(tcont.frame_labels(st), jcont.frame_labels(sj))


def test_make_streams_and_frame_batch_match_jax():
    for a, b in zip(tcont.make_streams(100, 2, duration_s=3.0),
                    jcont.make_streams(100, 2, duration_s=3.0)):
        _equal(a.audio, b.audio)
        assert a.truth_frames() == b.truth_frames()
    got = tcont.synth_frame_batch(np.random.default_rng(2), 2)
    want = jcont.synth_frame_batch(np.random.default_rng(2), 2)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("bad", [
    dict(duration_s=0.0), dict(snr_db=float("inf")),
    dict(events_per_min=-1.0), dict(min_gap_s=-0.1), dict(noise="brown"),
    dict(keyword_classes=()), dict(keyword_classes=(0,))])
def test_make_stream_value_errors_match_jax(bad):
    with pytest.raises(ValueError) as et:
        tcont.make_stream(np.random.default_rng(0), **bad)
    with pytest.raises(ValueError) as ej:
        jcont.make_stream(np.random.default_rng(0), **bad)
    assert str(et.value) == str(ej.value)


# ------------------------------------------------------------------- VAD --

def _audio(rng, B, S):
    """12-bit audio: loud bursts (speech) in quiet noise."""
    x = 0.004 * rng.standard_normal((B, S))
    burst = np.repeat(rng.random((B, -(-S // 128))) < 0.25, 128, axis=1)
    x += burst[:, :S] * 0.2 * rng.standard_normal((B, S))
    return quantize_audio_12b(torch.from_numpy(x.astype(np.float32)))


def test_frame_energy_matches_jax():
    audio = _audio(np.random.default_rng(0), 5, 128 * 40 + 77)
    got = tvad.frame_energy(audio, 128)
    want = jvad.frame_energy(jnp.asarray(audio.numpy()), 128)
    assert got.shape == (40, 5)
    _equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_vad_gate_closed_form_matches_loop_and_jax(dtype):
    """Carried chunks of 1, 12, 4 and 23 frames; hangover 4, so the
    countdown expires inside chunks and exactly at a boundary (slot 0:
    speech at frame 12, the gate's last open frame 16 ends a chunk); a
    carried hang from before the run."""
    rng = np.random.default_rng(1)
    F, B, C = 40, 6, 10
    feats = rng.standard_normal((F, B, C)).astype(np.float32)
    if dtype == "int16":
        feats = np.round(feats * 1000).astype(np.int16)
    energy = np.where(rng.random((F, B)) < 0.15, 0.05, 0.001)
    energy[:, 0] = 0.001
    energy[12, 0] = 0.05
    energy = energy.astype(np.float32)
    cfg_t, cfg_j = tvad.VADConfig(0.02, 4), jvad.VADConfig(0.02, 4)
    hold = rng.standard_normal((B, C)).astype(feats.dtype)
    hang = np.array([0, 2, 7, 0, 1, 4], np.int32)
    st_t = st_l = tvad.VADState(torch.from_numpy(hold),
                                torch.from_numpy(hang))
    st_j = jvad.VADState(jnp.asarray(hold), jnp.asarray(hang))
    jgate = jax.jit(jvad.vad_gate, static_argnums=3)
    lo = 0
    for n in (1, 12, 4, 23):
        x, e = feats[lo:lo + n], energy[lo:lo + n]
        out_t = tvad.vad_gate(torch.from_numpy(x), torch.from_numpy(e),
                              st_t, cfg_t)
        out_l = tvad.vad_gate_loop(torch.from_numpy(x), torch.from_numpy(e),
                                   st_l, cfg_t)
        out_j = jgate(jnp.asarray(x), jnp.asarray(e), st_j, cfg_j)
        for t, lp, j, name in zip((*out_t[:2], *out_t[2]),
                                  (*out_l[:2], *out_l[2]),
                                  (*out_j[:2], *out_j[2]),
                                  ("feats", "gate", "hold", "hang")):
            _equal(t, j, f"{name} at frame {lo}")
            _equal(t, lp.numpy(), f"{name} (loop) at frame {lo}")
        st_t, st_l, st_j = out_t[2], out_l[2], out_j[2]
        lo += n
    gate = np.concatenate([np.asarray(jvad.vad_gate(
        jnp.asarray(feats), jnp.asarray(energy),
        jvad.init_vad_state(B, C, feats.dtype), cfg_j)[1])])
    assert gate[:, 0].tolist() == [False] * 12 + [True] * 5 + [False] * 23
    assert 0 < gate.mean() < 1


def test_vad_off_is_an_identity():
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((9, 3, 4)).astype(
        np.float32))
    energy = torch.from_numpy(rng.uniform(0, 0.1, (9, 3)).astype(np.float32))
    out, gate, st = tvad.vad_gate(feats, energy, tvad.init_vad_state(3, 4),
                                  tvad.VAD_OFF)
    assert torch.equal(out, feats) and bool(gate.all())
    assert torch.equal(st.hold, feats[-1]) and not st.hang.any()
    st = tvad.init_vad_state(3, 4, torch.int16)
    assert st.hold.dtype == torch.int16 and st.hang.dtype == torch.int32
    assert not tvad.vad_state_flags(st).any()


# -------------------------------------------------------- detection head --

def _head_case(rng, F, B, K, scale):
    return (rng.standard_normal((F, B, K)) * scale).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.25, 0.3])
@pytest.mark.parametrize("per_keyword", [False, True])
def test_detect_head_plain_matches_jax(xla_fma, alpha, per_keyword):
    """Two carried chunks of 40 × 48 slots × 12 classes, thresholds just
    above 1/12 so the head fires; smoothed state, latch and events bit
    for bit."""
    rng = np.random.default_rng(int(alpha * 100) + per_keyword)
    F, B, K = 40, 48, 12
    if per_keyword:
        fire = tuple(float(v) for v in rng.uniform(0.086, 0.1, K - 2))
        rel = tuple(0.97 * f for f in fire)
    else:
        fire, rel = 0.09, 0.087
    cfg_t = tdet.DetectorConfig(alpha, fire, rel, refractory_frames=5)
    cfg_j = jdet.DetectorConfig(alpha, fire, rel, refractory_frames=5)
    logits = _head_case(rng, 2 * F, B, K, 0.6)

    @jax.jit
    def head(st, lg):
        return jdet.detector_scan(cfg_j, st, jax.nn.softmax(lg, axis=-1))

    st_t = tdet.init_detector_state(B, K)
    st_j = jdet.init_detector_state(B, K)
    fires = 0
    for lo in (0, F):
        st_j, ev_j = head(st_j, jnp.asarray(logits[lo:lo + F]))
        st_t, ev_t = tdh.detect_head(torch.from_numpy(logits[lo:lo + F]),
                                     st_t, cfg_t)
        _equal(ev_t, ev_j, f"events at frame {lo}")
        for t, j, name in zip(st_t, st_j, tdet.DetectorState._fields):
            _equal(t, j, name)
        fires += int((ev_t >= 0).sum())
    assert fires > 10


@pytest.mark.parametrize("K", [1, 2, 12, 32, 33, 35, 64])
def test_xla_softmax_matches_jax(xla_fma, K):
    """Random rows, and rows with a NaN, ±1e30 and ±inf logits; above 32
    classes XLA sums in windows of 32."""
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((3000, K))
         * rng.uniform(0.1, 30.0, (3000, 1))).astype(np.float32)
    x[0, K // 2] = np.nan
    x[1, 0], x[1, -1] = 1e30, -1e30
    x[2, :] = 1e30
    x[3, 0] = np.inf
    x[4, :] = -np.inf
    got = tdh.xla_softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v: jax.nn.softmax(v, axis=-1))(x))
    both_nan = np.isnan(got) & np.isnan(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert int(((_bits(got) != _bits(want)) & ~both_nan).sum()) == 0


def test_detect_head_first_keyword_one_and_specials(xla_fma):
    """An 11-class head (first_keyword 1) with a NaN logit row (the slot
    poisons and never fires), ±1e30 logits and a low threshold that fires
    in most slots."""
    rng = np.random.default_rng(7)
    F, B, K = 30, 9, 11
    logits = _head_case(rng, F, B, K, 2.0)
    logits[3, 2, 4] = np.nan
    logits[5:9, 4, 1] = 1e30
    logits[5:9, 4, 0] = -1e30
    cfg_t = tdet.DetectorConfig(0.3, 0.05, 0.04, 3, first_keyword=1)
    cfg_j = jdet.DetectorConfig(0.3, 0.05, 0.04, 3, first_keyword=1)
    st_t, ev_t = tdh.detect_head(torch.from_numpy(logits),
                                 tdet.init_detector_state(B, K), cfg_t)
    st_j, ev_j = jax.jit(lambda lg: jdet.detector_scan(
        cfg_j, jdet.init_detector_state(B, K),
        jax.nn.softmax(lg, axis=-1)))(jnp.asarray(logits))
    _equal(ev_t, ev_j)
    assert np.isnan(st_t.smooth[2].numpy()).all()
    np.testing.assert_array_equal(st_t.smooth.numpy(),
                                  np.asarray(st_j.smooth))
    _equal(st_t.active, st_j.active)
    _equal(st_t.refract, st_j.refract)
    assert (ev_t.numpy() >= 0).any(axis=0).sum() >= B - 1
    assert (ev_t[3:, 2] < 0).all()          # poisoned from frame 3 on


def test_detector_config_checks():
    assert tdet.band_inverted(tdet.DetectorConfig(fire_threshold=0.3,
                                                  release_threshold=0.4))
    assert not tdet.band_inverted(tdet.DetectorConfig(
        fire_threshold=(0.5, 0.6), release_threshold=(0.4, 0.6)))
    with pytest.raises(ValueError, match="broadcast"):
        tdet.band_inverted(tdet.DetectorConfig(
            fire_threshold=(0.5, 0.6), release_threshold=(0.4, 0.4, 0.4)))
    with pytest.raises(ValueError, match="one per keyword"):
        tdet.keyword_thresholds(tdet.DetectorConfig(
            fire_threshold=(0.5, 0.6)), 12)
    fire, rel = tdet.keyword_thresholds(tdet.DetectorConfig(), 12)
    assert fire.shape == rel.shape == (10,) and fire.dtype == np.float32


@pytest.mark.parametrize("B", [1, 3, 33, 128, 129, 256, 1000])
@pytest.mark.parametrize("K", [1, 12, 35, 64])
def test_detect_launch_plan_covers_every_slot(B, K):
    grid, block, smem = tdh.detect_launch_plan(B, K)
    lanes = B * tdh.lanes_per_slot(K)
    assert grid * block >= lanes > (grid - 1) * block
    assert block % 32 == 0 and 32 <= block <= tdh.BLOCK
    assert tdh.lanes_per_slot(K) * (2 if K > 32 else 1) >= K
    assert smem == 2 * 4 * K <= 48 * 1024


def test_detect_launch_plan_refuses_too_many_classes():
    with pytest.raises(ValueError, match="classes"):
        tdh.detect_launch_plan(4, tdh.MAX_CLASSES + 1)


# --------------------------------------------------------------- scoring --

@pytest.fixture(scope="module")
def trace():
    """A 12-class posterior trace of one stream and its truth events."""
    stream = jcont.make_stream(np.random.default_rng(4), duration_s=4.0,
                               events_per_min=60.0)
    truth = stream.truth_frames()
    rng = np.random.default_rng(5)
    n = len(stream.audio) // 128
    posts = np.full((n, 12), 1.0 / 12, np.float32)
    for s, e, c in truth:
        posts[s:e + 1, c] += rng.uniform(0.05, 0.6)
    posts += rng.uniform(0, 0.08, posts.shape).astype(np.float32)
    posts /= posts.sum(-1, keepdims=True)
    return posts, truth


def test_scoring_matches_jax(trace):
    posts, truth = trace
    cfg_t = tdet.DetectorConfig(fire_threshold=0.2, release_threshold=0.15)
    _, ev = tdet.detector_scan(cfg_t, tdet.init_detector_state(1, 12),
                               torch.from_numpy(posts[:, None]))
    fires = tdet.fires_from_events(ev.numpy(), 7)
    assert fires == jdet.fires_from_events(ev.numpy(), 7) and fires
    for tol in (0, 3, 40):
        assert tdet.match_fires(fires, truth, tol) == \
            jdet.match_fires(fires, truth, tol)
        pt = tdet.det_point(fires, truth, len(posts), tol)
        pj = jdet.det_point(fires, truth, len(posts), tol)
        assert dataclasses.astuple(pt) == dataclasses.astuple(pj)
    pts = [tdet.det_point(fires[i::2], truth, 500, 3) for i in (0, 1)]
    pjs = [jdet.det_point(fires[i::2], truth, 500, 3) for i in (0, 1)]
    assert dataclasses.astuple(tdet.pool_points(pts)) == \
        dataclasses.astuple(jdet.pool_points(pjs))


def test_calibrate_fire_thresholds_matches_jax(trace):
    posts, truth = trace
    cands = (0.1, 0.3)
    got = tdet.calibrate_fire_thresholds(
        posts, truth, tdet.DetectorConfig(), cands, fa_budget_per_hour=200,
        tol_frames=5)
    want = jdet.calibrate_fire_thresholds(
        posts, truth, jdet.DetectorConfig(), cands, fa_budget_per_hour=200,
        tol_frames=5)
    assert got == want and len(got) == 10
    assert len(set(got)) > 1
