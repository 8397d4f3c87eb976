"""Port conformance, serving: repro_torch's streaming session and serve
loop against the JAX package's, with the same weights and audio.

The weights are the JAX package's ``init_kws`` tree (SMOKE_CONFIG,
d_model 16) converted by ``params_from_numpy``.  The JAX session runs its
plain references (``backend="xla"``, ``fex_backend="xla"``); the port's
session runs on the CPU, i.e. through its kernels' plain versions.
Tolerance: logits within 1e-5 absolute (the FC and ΔGRU products are
summed in another order, σ/tanh may differ by an ulp); votes, transmit
counts and the summary's frames/sparsity equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.data import gscd as jgscd
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import engine as jengine
from repro.launch import streaming as jstream
from repro.models import kws as jkws
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.data import gscd as tgscd
from repro_torch.launch import engine as tengine
from repro_torch.launch import streaming as tstream
from repro_torch.models import kws as tkws

TH = 0.1
ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


def _sessions(weights, batch):
    jparams, np_params = weights
    js = jstream.StreamingKwsSession(jparams, J_SMOKE, threshold=TH,
                                     batch=batch, fex=JFex(), backend="xla",
                                     fex_backend="xla")
    ts = tstream.StreamingKwsSession(tkws.params_from_numpy(np_params),
                                     T_SMOKE, threshold=TH, batch=batch,
                                     device="cpu")
    return js, ts


def test_session_unaligned_chunks_match_jax(weights):
    """Two streams of keyword audio in chunks of 300, 1, 400 and 399
    samples (the host remainder carry, a 1-sample chunk included)."""
    audio, _ = jgscd.synth_batch(np.random.default_rng(0), 2)
    audio = audio[:, 2000:3100]
    js, ts = _sessions(weights, 2)
    outs_j, outs_t, lo = [], [], 0
    for n in (300, 1, 400, 399):
        outs_j.append(js.process_audio(audio[:, lo:lo + n]))
        outs_t.append(ts.process_audio(audio[:, lo:lo + n]))
        lo += n
    for field in ("logits", "votes", "nz"):
        j = np.concatenate([np.asarray(getattr(o, field)) for o in outs_j])
        t = torch.cat([getattr(o, field) for o in outs_t]).numpy()
        assert j.shape == t.shape == (8, 2) + j.shape[2:]
        if field == "logits":
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(t, j)
    sj, st = js.summary(), ts.summary()
    assert st.frames == sj.frames == 16
    assert st.chunks == sj.chunks == 3         # the 1-sample chunk: 0 frames
    assert st.fex_samples == sj.fex_samples
    assert st.sparsity == sj.sparsity and 0.0 < st.sparsity < 1.0
    assert st.energy_nj_per_decision == pytest.approx(
        sj.energy_nj_per_decision, rel=1e-12)
    assert not st.overflowed and ts.unhealthy_slots() == {}


def test_serve_loop_decisions_match_jax(weights):
    """run_audio_requests(depth=1, ctl=None): 3 requests on 2 slots (two
    admission waves, so eviction, re-admission and reset_streams run)
    decide the same classes in the same order in both packages."""
    audio_q, _ = tgscd.synth_batch(np.random.default_rng(5), 3)
    j_audio, _ = jgscd.synth_batch(np.random.default_rng(5), 3)
    np.testing.assert_array_equal(audio_q, j_audio)
    js, ts = _sessions(weights, 2)
    kw = dict(audio_q=audio_q, chunk=2048, chunks_per_utt=4,
              real_frames=8000 // 128, depth=1)
    j_sched, t_sched = jstream.SlotScheduler(js), tstream.SlotScheduler(ts)
    for req in range(3):
        j_sched.submit(req)
        t_sched.submit(req)
    j_done, j_stats = jengine.run_audio_requests(js, j_sched, None, **kw)
    t_done, t_stats = tengine.run_audio_requests(ts, t_sched, None, **kw)
    assert t_done == j_done and len(t_done) == 3
    for key in ("steps", "frames_served", "pad_frames"):
        assert t_stats[key] == j_stats[key]
    assert ts.summary().sparsity == js.summary().sparsity
    assert ts.summary().slo["steps"] == t_stats["steps"]


def test_forward_audio_matches_jax(weights):
    """models.kws.forward_audio (FEx → ΔGRU → mean-pool → FC) on the
    same audio and weights as the JAX package's."""
    from repro_torch.frontend.fex import FeatureExtractor as TFex
    jparams, np_params = weights
    audio, _ = jgscd.synth_batch(np.random.default_rng(2), 2)
    audio = audio[:, 1000:2280]
    j_logits, j_stats = jkws.forward_audio(jparams, J_SMOKE, audio, JFex(),
                                           threshold=TH, backend="xla",
                                           fex_backend="xla")
    t_logits, t_stats = tkws.forward_audio(
        tkws.params_from_numpy(np_params), T_SMOKE, torch.from_numpy(audio),
        TFex(), threshold=TH, backend="pallas")
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t_stats.macs.numpy(),
                                  np.asarray(j_stats.macs))


def test_feature_chunks_equal_audio_path(weights):
    """process_chunk on the FEx's features equals process_audio on the
    audio they came from (same kernels, same state), bit for bit."""
    from repro_torch.frontend.fex import FeatureExtractor as TFex
    audio, _ = jgscd.synth_batch(np.random.default_rng(4), 2)
    audio = audio[:, 3000:3000 + 6 * 128]
    feats = TFex()(torch.from_numpy(audio)).movedim(1, 0)     # (F, B, C)
    s_audio, s_feats = (tstream.StreamingKwsSession(
        tkws.params_from_numpy(weights[1]), T_SMOKE, threshold=TH, batch=2,
        device="cpu") for _ in range(2))
    a = s_audio.process_audio(audio)
    f = s_feats.process_chunk(feats.numpy())
    for x, y in zip(a, f):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert s_feats.summary().frames == s_audio.summary().frames == 12


def test_checkpoint_arrays_npz_loads_into_the_port(weights, tmp_path):
    """A JAX trainer checkpoint ({"params": ...} in arrays.npz) loads
    into the port unchanged."""
    from repro.train import checkpoint
    jparams, np_params = weights
    final = checkpoint.save(tmp_path, 3, {"params": jparams})
    loaded = tkws.load_npz_params(final / "arrays.npz")
    for k in tkws.PARAM_KEYS:
        np.testing.assert_array_equal(loaded[k].numpy(), np_params[k])
    with pytest.raises(ValueError, match="shape"):
        tkws.params_from_numpy({**np_params, "b": np_params["b"][:-1]})


def test_reset_streams_gives_fresh_slot(weights):
    _, np_params = weights
    ts = tstream.StreamingKwsSession(tkws.params_from_numpy(np_params),
                                     T_SMOKE, threshold=TH, batch=2,
                                     device="cpu")
    rng = np.random.default_rng(1)
    ts.process_audio((0.3 * rng.standard_normal((2, 256))).astype(np.float32))
    ts.reset_streams([1])
    fresh = tstream.StreamingKwsSession(tkws.params_from_numpy(np_params),
                                        T_SMOKE, threshold=TH, batch=2,
                                        device="cpu")
    fresh.process_audio(np.zeros((2, 0), np.float32))
    for got, want in zip((*ts.state, *ts.fex_state),
                         (*fresh.state, *fresh.fex_state)):
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert not torch.equal(ts.state.h[0], fresh.state.h[0])   # untouched


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"cascade": object()}, {"supervisor": object()}])
def test_unported_session_options_raise(weights, option):
    if "cascade" in option:
        # The cascade is ported: without a detector it is refused as the
        # reference refuses it.
        with pytest.raises(ValueError, match="DetectorConfig"):
            tstream.StreamingKwsSession(tkws.params_from_numpy(weights[1]),
                                        T_SMOKE, device="cpu", **option)
        return
    if "supervisor" in option:
        # The supervisor is ported: the session takes it as the reference
        # does, and nothing is flagged before a chunk has run.
        sess = tstream.StreamingKwsSession(
            tkws.params_from_numpy(weights[1]), T_SMOKE, device="cpu",
            **option)
        assert sess.supervisor is option["supervisor"]
        assert sess.flagged_slots() == frozenset() and sess.heal() == []
        return
    # The slot mesh is ported: a foreign object as the mesh is refused,
    # as the reference refuses it (its slot_shards reads axis_names).
    with pytest.raises(AttributeError, match="axis_names"):
        jstream.StreamingKwsSession(weights[0], J_SMOKE, **option)
    with pytest.raises(TypeError, match="SlotMesh"):
        tstream.StreamingKwsSession(tkws.params_from_numpy(weights[1]),
                                    T_SMOKE, device="cpu", **option)


def test_input_policies(weights):
    def sess(policy):
        return tstream.StreamingKwsSession(
            tkws.params_from_numpy(weights[1]), T_SMOKE, device="cpu",
            input_policy=policy)
    bad = np.full(128, np.nan, np.float32)
    with pytest.raises(tstream.StreamInputError, match="non-finite"):
        sess("reject").process_audio(bad)
    with pytest.raises(tstream.StreamInputError, match="int16"):
        sess("sanitize").process_audio(np.full(128, 40000, np.int32))
    with pytest.raises(tstream.StreamInputError, match="decodable"):
        sess("trust").process_audio(np.array(["a"] * 128))
    s = sess("sanitize")
    assert s.process_audio(bad).votes.shape == (1, 1)
    assert s.unhealthy_slots() == {}
    t = sess("trust")
    t.process_audio(bad)
    assert t.unhealthy_slots()[0] & tstream.HEALTH_INPUT


def test_scheduler_evict_names_the_slot_state(weights):
    s = tstream.StreamingKwsSession(tkws.params_from_numpy(weights[1]),
                                    T_SMOKE, batch=2, device="cpu")
    sched = tstream.SlotScheduler(s)
    sched.submit("a")
    assert sched.admit() == [(0, "a")]
    assert sched.evict(0) == "a"
    with pytest.raises(ValueError, match="already free"):
        sched.evict(0)
    with pytest.raises(ValueError, match="out of range"):
        sched.evict(5)


def test_serve_parser_defaults_match_the_reference():
    """``--train-steps`` and ``--seed`` mean what the reference's mean, at
    its defaults: 120 quick-training steps, and the stream-synthesis seed
    100.  The port's weight, training and request seed is the port-only
    ``--init-seed`` (default 0: the reference's fixed seeds 0 and 1)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    j = jserve.build_parser().parse_args([])
    t = tserve.build_parser().parse_args([])
    assert (t.train_steps, t.seed) == (j.train_steps, j.seed) == (120, 100)
    assert t.init_seed == 0 and not hasattr(t, "stream_seed")
    t = tserve.build_parser().parse_args(["--seed", "7", "--init-seed", "3"])
    assert (t.seed, t.init_seed) == (7, 3)
    with pytest.raises(SystemExit):
        tserve.build_parser().parse_args(["--stream-seed", "100"])
    help_text = tserve.build_parser().format_help()
    assert "--init-seed" in help_text and "--stream-seed" not in help_text
