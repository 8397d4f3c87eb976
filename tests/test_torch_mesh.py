"""Port conformance, the slot mesh: ``StreamingKwsSession(mesh=...)`` over
2 and 4 shards on the CPU against the JAX package's unsharded session and
against the port's own unsharded session.

The reference proves its own mesh invariance in child processes
(``tests/test_serve.py::SHARDED_CHILD``, ``tests/test_engine.py::
ENGINE_MESH_CHILD``, ``tests/test_faults.py``); here its unsharded session
runs in-process through its plain references (``backend="xla"``,
``fex_backend="xla"``), and the port's shards run on the CPU through its
kernels' plain versions (``SlotMesh.on("cpu", n)``).  The trace is the
reference's ``SHARDED_CHILD``: the deltakws config at full width (FEx 10
→ ΔGRU 64 → FC 12), 4 slots × 2048 samples of seeded audio, a chunk,
``reset_streams([1, 2])`` (one slot per shard at 2 shards), a chunk.
Tolerances: sharded against unsharded port sessions, every output, state
and summary bit for bit; against JAX, int8 every code, vote, event and
summary number equal, float32 votes, transmit counts, events, gates and
awake bits equal, logits within 1e-5 (the FC's products are summed in
another order), summary energies within 1e-9 relative.  This file runs
the plain mode (at 2 and 4 shards: one stream per shard) and the mesh's
small contracts; ``test_torch_mesh_modes.py`` runs detect and cascade on
the same trace through ``check_trace``, and ``test_torch_mesh_serve.py``
the engine and the CLI.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import serve as jserve
from repro.launch import streaming as jstream
from repro.models import detector as jdet
from repro.models import kws as jkws
from repro.parallel import sharding as jshard
from repro_torch.configs.deltakws import CONFIG as T_CFG
from repro_torch.kernels.platform import shard_map_kernels
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.launch.mesh import SlotMesh, make_slot_mesh
from repro_torch.models import detector as tdet
from repro_torch.models import kws as tkws
from repro_torch.parallel import sharding as tshard

TH = 0.1
ATOL = 1e-5
DET = dict(fire_threshold=0.09, release_threshold=0.085)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("deltakws")
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), cfg, input_dim=10)
    # The CLI's stage 0 (kws-cascade, --train-steps 0): the reference's
    # seeded init, 16 units, a binary head over 4 channels.
    args = jserve.build_parser().parse_args(
        ["--mode", "kws-cascade", "--train-steps", "0"])
    _, params0 = jserve._train_stage0(args, None)
    # Its scores on this trace lie in 0.32–0.40: these thresholds wake
    # stage 1 at the start and after the resets and let it sleep between
    # (no score lies within 4e-4 of either).
    cas = dict(wake_threshold=0.35, sleep_threshold=0.335,
               hangover_frames=3, s0_threshold=args.s0_threshold,
               s0_channels=args.s0_channels)
    as_np = lambda p: {k: np.asarray(v) for k, v in p.items()}
    return cfg, params, as_np(params), params0, as_np(params0), cas


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.5, 0.5, (4, 2048)).astype(np.float32)


def _mode_kw(mode, weights, pkg):
    *_, params0, np_p0, cas = weights
    if mode == "plain":
        return {}
    det = jdet if pkg == "jax" else tdet
    kw = dict(detector=det.DetectorConfig(**DET))
    if mode == "cascade":
        stream = jstream if pkg == "jax" else tstream
        kw.update(cascade=stream.CascadeConfig(**cas),
                  stage0_params=(params0 if pkg == "jax"
                                 else tkws.params_from_numpy(np_p0)))
    return kw


def _port(weights, mode, numerics, n, batch=4, **extra):
    np_p = weights[2]
    mesh = None if n == 1 else SlotMesh.on("cpu", n)
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_p), T_CFG, threshold=TH, batch=batch,
        device="cpu", mesh=mesh, numerics=numerics,
        **_mode_kw(mode, weights, "torch"), **extra)


def _trace(sess, audio):
    outs = [sess.process_audio(audio)]
    sess.reset_streams([1, 2])
    outs.append(sess.process_audio(audio))
    return outs


_RUNS: dict = {}


def _reference_runs(weights, audio, mode, numerics):
    """The JAX session's and the unsharded port session's trace (cached
    per mode and numerics)."""
    key = (mode, numerics)
    if key not in _RUNS:
        cfg, params = weights[0], weights[1]
        js = jstream.StreamingKwsSession(
            params, cfg, threshold=TH, batch=4, fex=JFex(), backend="xla",
            fex_backend="xla", numerics=numerics,
            **_mode_kw(mode, weights, "jax"))
        ts = _port(weights, mode, numerics, 1)
        _RUNS[key] = (js, _trace(js, audio), ts, _trace(ts, audio))
    return _RUNS[key]


def _summary_matches(got, want, exact: bool):
    for f in dataclasses.fields(want):
        if f.name == "slo":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and not exact:
            assert a == pytest.approx(b, rel=1e-9, abs=0), f.name
        else:
            assert a == b, f.name


def check_trace(weights, audio, mode, numerics, n):
    """The reference's trace through an n-shard port session, held to the
    unsharded port session bit for bit and to the JAX session."""
    js, outs_j, ts, outs_t = _reference_runs(weights, audio, mode,
                                             numerics)
    sh = _port(weights, mode, numerics, n)
    assert sh.n_shards == n and sh.mesh is not None
    assert [sh.shard_of_slot(s) for s in range(4)] == \
        ([0, 0, 1, 1] if n == 2 else [0, 1, 2, 3])
    outs_s = _trace(sh, audio)
    exact = numerics == "int8"
    for o_s, o_t, o_j in zip(outs_s, outs_t, outs_j):
        assert type(o_s) is type(o_t)
        for f in o_t._fields:
            a, b = getattr(o_s, f), getattr(o_t, f)
            if b is None:
                assert a is None, f
                continue
            assert torch.equal(a, b), f            # sharded == unsharded
            want = np.asarray(getattr(o_j, f))
            if f == "logits":
                np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                           atol=0 if exact else ATOL)
            else:
                np.testing.assert_array_equal(a.numpy(), want, err_msg=f)
        assert o_s.votes.shape == (16, 4)
    for name in ("state", "fex_state", "vad_state", "det_state",
                 "cas_state"):
        a, b = getattr(sh, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        for x, y in zip(tshard.tensors_of(a), tshard.tensors_of(b)):
            assert torch.equal(x, y), name
    if exact:
        for x, y in zip(sh.state, js.state):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert sh.summary() == ts.summary()
    _summary_matches(sh.summary(), js.summary(), exact)
    if mode != "plain":                            # not vacuous
        assert bool(torch.cat([o.gate for o in outs_s]).any())
    if mode == "detect":
        assert bool((torch.cat([o.events for o in outs_s]) >= 0).any())
    if mode == "cascade":
        assert 0 < sh.summary().stage1_duty < 1


@pytest.mark.parametrize("numerics,n", [("float32", 2), ("float32", 4),
                                        ("int8", 2), ("int8", 4)])
def test_reference_trace_sharded(weights, audio, numerics, n):
    check_trace(weights, audio, "plain", numerics, n)


def test_make_slot_mesh_contract():
    """The reference's cases: one device is no mesh, nonsense counts
    raise, and a count beyond the visible cards raises."""
    assert make_slot_mesh(1) is None
    for bad in (0, -2):
        with pytest.raises(ValueError, match=">= 1"):
            make_slot_mesh(bad)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible"):
        make_slot_mesh(visible + 1 if visible > 1 else 2)
    mesh = SlotMesh.on("cpu", 2)
    assert mesh.axis_names == ("data",) and mesh.shape["data"] == 2
    assert tshard.slot_shards(mesh) == 2
    assert tshard.check_slot_partition(mesh, 4) == 2
    with pytest.raises(ValueError, match="do not partition"):
        tshard.check_slot_partition(mesh, 7)
    with pytest.raises(ValueError, match=">= 1"):
        SlotMesh.on("cpu", 0)
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        SlotMesh(["cpu", "meta"])


def test_one_shard_mesh_is_the_unsharded_session(weights, audio):
    """A one-shard mesh takes the unsharded code path: no mesh, no lists,
    the same outputs as a session built without one."""
    np_p = weights[2]
    one = tstream.StreamingKwsSession(
        tkws.params_from_numpy(np_p), T_CFG, threshold=TH, batch=4,
        mesh=SlotMesh.on("cpu", 1))
    assert one.n_shards == 1 and one.mesh is None
    assert one.device == torch.device("cpu")
    *_, outs_t = _reference_runs(weights, audio, "plain", "float32")
    outs = _trace(one, audio)
    for o, o_t in zip(outs, outs_t):
        for a, b in zip(o, o_t):
            assert torch.equal(a, b)
    assert isinstance(one.state, tuple) and not isinstance(
        one._state, list)


def test_scheduler_balances_shards_like_the_reference(weights):
    """4 slots over 2 shards: admissions alternate to the least-loaded
    shard (``occupancy() == [2, 2]``), evictions free a slot on its own
    shard, and the reference's scheduler makes the same choices."""
    sess = _port(weights, "plain", "float32", 2)
    sched = tstream.SlotScheduler(sess)
    for r in range(5):
        sched.submit(r)
    got = sched.admit()
    assert sched.occupancy() == [2, 2] and len(sched) == 1
    assert sched.evict(got[1][0]) == got[1][1]
    assert sched.occupancy() in ([1, 2], [2, 1])
    again = sched.admit()
    assert sched.occupancy() == [2, 2] and again[0][0] == got[1][0]
    sched.evict(got[0][0])
    with pytest.raises(ValueError, match="already free"):
        sched.evict(got[0][0])
    with pytest.raises(ValueError, match="out of range"):
        sched.evict(9)
    # The reference's scheduler and the port's on one two-shard geometry.
    fake = type("Fake", (), {"batch": 4, "n_shards": 2,
                             "shard_of_slot": lambda self, i: i // 2,
                             "flagged_slots": lambda self: frozenset(),
                             "reset_streams": lambda self, s: None})
    jsched = jstream.SlotScheduler(fake())
    tsched = tstream.SlotScheduler(fake())
    for s in (jsched, tsched):
        for r in range(5):
            s.submit(r)
    assert tsched.admit() == jsched.admit() == got
    for s in (jsched, tsched):
        s.evict(got[2][0])
        s.evict(got[0][0])
    assert tsched.admit() == jsched.admit()
    assert tsched.occupancy() == jsched.occupancy()


def test_serve_devices_validation():
    ap = tserve.build_parser()
    for flags, match in ((("--slots", "7", "--devices", "2"), "divide"),
                         (("--devices", "0"), ">= 1")):
        for mod in (tserve, jserve):
            args = mod.build_parser().parse_args(
                ["--mode", "kws-audio", *flags])
            with pytest.raises(ValueError, match=match):
                mod.validate_args(args)
    assert ap.parse_args([]).devices == 1
    # Two shards on a machine without a second card: the reference's
    # "beyond visible" error, raised before any model is built.
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        args = ap.parse_args(["--mode", "kws-audio", "--devices", "2"])
        with pytest.raises((ValueError, RuntimeError),
                           match="visible|is_available"):
            tserve.slot_mesh(args)


def test_sharding_placement_helpers():
    """``put_slot_sharded`` / ``put_replicated`` / the spec trees on the
    CPU, against the reference's specs."""
    mesh = SlotMesh.on("cpu", 2)
    x = torch.arange(24.0).reshape(4, 6)
    tree = {"a": x, "b": (x[:, 0], None)}
    shards = tshard.put_slot_sharded(tree, mesh)
    assert len(shards) == 2
    assert torch.equal(shards[1]["a"], x[2:]) and shards[1]["b"][1] is None
    assert shards[0]["a"].data_ptr() != x.data_ptr()      # a copy
    reps = tshard.put_replicated(tree, mesh)
    assert reps[0] is reps[1]                  # one device, one copy
    assert tshard.put_slot_sharded(tree, None) is tree
    assert tshard.put_replicated(tree, None) is tree
    jtree = {"a": 1, "b": (2, None)}
    assert tshard.slot_specs(jtree) == {"a": tshard.P("data"),
                                        "b": (tshard.P("data"), None)}
    assert jax.tree.map(tuple, jshard.slot_specs(jtree)) == \
        jax.tree.map(tuple, tshard.slot_specs(jtree))
    assert jax.tree.map(tuple, jshard.replicated_specs(jtree)) == \
        jax.tree.map(tuple, tshard.replicated_specs(jtree))
    with pytest.raises(ValueError, match="do not partition"):
        tshard.put_slot_sharded(torch.zeros(3, 2), mesh)


def test_shard_map_kernels_contract():
    """Each shard's call sees its block; the time-major result and the
    health mask are joined on the slot axis; ragged blocks are refused;
    without a mesh the step itself is returned."""
    def step(w, state, feats):
        return state + 1, feats * w, state[:, 0] > 0

    assert shard_map_kernels(step, None, slot_major=(1,), time_major=(2,),
                             n_state_out=1) is step
    mesh = SlotMesh.on("cpu", 2)
    run = shard_map_kernels(step, mesh, slot_major=(1,), time_major=(2,),
                            n_state_out=1)
    state = torch.arange(8.0).reshape(4, 2)
    feats = torch.arange(12.0).reshape(3, 4)
    w = torch.tensor(2.0)
    new, out, health = run([w, w], [state[:2], state[2:]],
                           [feats[:, :2], feats[:, 2:]])
    assert torch.equal(torch.cat(new), state + 1)
    assert torch.equal(out, feats * 2)
    assert torch.equal(health, state[:, 0] > 0)
    with pytest.raises(ValueError, match="differ in size"):
        run([w, w], [state[:1], state[1:]], [feats[:, :2], feats[:, 2:]])
    with pytest.raises(ValueError, match="one entry per shard"):
        run([w], [state[:2], state[2:]], [feats[:, :2], feats[:, 2:]])


def test_supervisor_heals_across_shards(weights):
    """A NaN burst in one slot of shard 1: the joined health mask flags
    that slot alone, the supervisor resets it, the other shard's slots run
    on, and everything equals the unsharded session's."""
    rng = np.random.default_rng(3)
    audio = (0.3 * rng.standard_normal((4, 512))).astype(np.float32)
    bad = audio.copy()
    bad[3, 100:140] = np.nan
    runs = []
    for n in (1, 2):
        sess = _port(weights, "plain", "int8", n,
                     supervisor=tstream.SupervisorConfig(),
                     input_policy="trust")
        outs = [sess.process_audio(a) for a in (audio, bad, audio)]
        runs.append((sess, outs))
    (one, o1), (two, o2) = runs
    for a, b in zip(o1, o2):
        assert torch.equal(a.votes, b.votes) and torch.equal(a.nz, b.nz)
    assert two.summary().recoveries == one.summary().recoveries == 1
    assert two.summary().recovery_reasons == one.summary().recovery_reasons
    assert torch.equal(two._last_health, one._last_health)


def test_kernel_tuning_report_at_the_shard_batch(weights):
    sess = _port(weights, "plain", "int8", 4, batch=8)
    sess.process_audio(np.zeros((8, 0), np.float32))
    rep = sess.kernel_tuning_report()["kernels"]
    assert rep["delta_gru_seq_int"]["shape"] == [2, 10, 64]
    assert rep["batched_iir_fex_int"]["shape"] == [2, 10, 128]
