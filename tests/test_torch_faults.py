"""Port conformance, fault handling and overload: repro_torch's fault
injector, self-healing supervisor, ``set_threshold``, admission
controller and serve flags against the JAX package's, on the same numpy
inputs.

The weights are the JAX package's ``init_kws`` tree at SMOKE_CONFIG
(d_model 16), converted by ``params_from_numpy``.  The JAX session runs
its plain references (``backend="xla"``, ``fex_backend="xla"``); the
port's runs on the CPU, i.e. through its kernels' plain versions.
Tolerances: the injector's chunk lists (NaN positions and Inf signs
included) and action logs equal bit for bit; health masks, recoveries,
recovery reasons, flagged slots, controller levels and every int8 code
equal; float32 votes and transmit counts equal and logits within 1e-5
(the products are summed in another order).
"""
import dataclasses
import sys
import pathlib

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE  # noqa: E402
from repro.data import continuous as jcont  # noqa: E402
from repro.frontend import vad as jvad  # noqa: E402
from repro.frontend.fex import FeatureExtractor as JFex  # noqa: E402
from repro.launch import faults as jfaults  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import streaming as jstream  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.models import kws as jkws  # noqa: E402
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE  # noqa: E402
from repro_torch.frontend import vad as tvad  # noqa: E402
from repro_torch.launch import faults as tfaults  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import streaming as tstream  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.models import kws as tkws  # noqa: E402

TH = 0.1
ATOL = 1e-5
CHUNK = 256                      # 2 frames at frame_shift 128


@pytest.fixture(scope="module")
def weights():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jpool():
    """JAX sessions by (numerics, batch), shared by the module's tests: a
    session keeps its compiled steps across ``reset()``, so each shape
    compiles once."""
    return {}


def _audio(batch, n=CHUNK, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (batch, n)).astype(np.float32)


def _sup(mod, sup):
    return None if sup is None else mod.SupervisorConfig(*sup)


def _port(weights, numerics, batch=2, supervisor=None):
    return tstream.StreamingKwsSession(
        tkws.params_from_numpy(weights[1]), T_SMOKE, threshold=TH,
        batch=batch, device="cpu", numerics=numerics, input_policy="trust",
        supervisor=_sup(tstream, supervisor))


def _pair(weights, jpool, numerics, batch=2, supervisor=None):
    """(JAX session, port session) on the same weights, both fresh at Δ_TH
    TH; the JAX one from ``jpool``, reset."""
    key = (numerics, batch)
    if key not in jpool:
        jpool[key] = jstream.StreamingKwsSession(
            weights[0], J_SMOKE, threshold=TH, batch=batch, fex=JFex(),
            backend="xla", fex_backend="xla", numerics=numerics,
            input_policy="trust")
    js = jpool[key]
    js.reset()
    js.set_threshold(TH)
    js.supervisor = _sup(jstream, supervisor)
    return js, _port(weights, numerics, batch, supervisor)


def _same_out(oj, ot, numerics):
    np.testing.assert_array_equal(ot.votes.numpy(), np.asarray(oj.votes))
    np.testing.assert_array_equal(ot.nz.numpy(), np.asarray(oj.nz))
    atol = 0 if numerics == "int8" else ATOL
    np.testing.assert_allclose(ot.logits.numpy(), np.asarray(oj.logits),
                               rtol=0, atol=atol)


def _same_robustness(js, ts):
    sj, st_ = js.summary(), ts.summary()
    assert st_.recoveries == sj.recoveries
    assert st_.recovery_reasons == sj.recovery_reasons
    assert st_.sat_events == sj.sat_events
    assert ts.unhealthy_slots() == js.unhealthy_slots()
    assert ts.flagged_slots() == js.flagged_slots()


# ------------------------------------------------------------ the injector
def _injector_pair(plan_args, n_slots):
    jplan = jfaults.adversarial_plan(*plan_args[0], **plan_args[1])
    tplan = tfaults.adversarial_plan(*plan_args[0], **plan_args[1])
    return (jfaults.FaultInjector(jplan, n_slots),
            tfaults.FaultInjector(tplan, n_slots))


@settings(deadline=None, max_examples=6)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_injector_matches_jax_bit_for_bit(seed):
    """Equal plans and blocks: the port's chunk lists (NaN positions, Inf
    signs) and action logs equal the reference's, step by step."""
    ji, ti = _injector_pair(((seed,), dict(nan_rate=0.5, structure_rate=0.4,
                                          churn_rate=0.5, stall_rate=0.3)),
                            4)
    for step in range(8):
        block = _audio(4, n=257 + 64 * step, seed=step)
        cj, aj = ji.inject(block)
        ct, at = ti.inject(block)
        assert [dataclasses.astuple(a) for a in at] == \
            [dataclasses.astuple(a) for a in aj]
        assert len(ct) == len(cj)
        for x, y in zip(ct, cj):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.view(np.uint32),
                                          y.view(np.uint32))


def test_injector_validation_and_sample_totals():
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultSpec("gamma_ray", 0.1)
    with pytest.raises(ValueError, match="rate"):
        tfaults.FaultSpec("nan_burst", 1.5)
    with pytest.raises(ValueError, match="burst_samples"):
        tfaults.FaultSpec("nan_burst", 0.1, burst_samples=0)
    with pytest.raises(ValueError, match="count"):
        tfaults.FaultSpec("churn_storm", 0.1, count=0)
    with pytest.raises(ValueError, match="kind:rate"):
        tfaults.parse_fault_specs("nan_burst")
    assert tfaults.parse_fault_specs("nan_burst:0.05, clip:0.1") == \
        tuple(tfaults.FaultSpec(*s) for s in (("nan_burst", 0.05),
                                              ("clip", 0.1)))
    assert tfaults.parse_fault_specs("") == ()
    with pytest.raises(ValueError, match="slot"):
        tfaults.FaultInjector(tfaults.FaultPlan(0, (tfaults.FaultSpec(
            "clip", 0.1, slots=(9,)),)), n_slots=4)
    with pytest.raises(ValueError, match="block"):
        tfaults.FaultInjector(tfaults.adversarial_plan(0), 4).inject(
            _audio(3))
    # Split / dup / drop reshape delivery and never invent samples; the
    # input block is never mutated.
    inj = tfaults.FaultInjector(tfaults.adversarial_plan(
        5, structure_rate=0.9), 2)
    for step in range(10):
        block = _audio(2, seed=step)
        keep = block.copy()
        chunks, actions = inj.inject(block)
        np.testing.assert_array_equal(block, keep)
        total = sum(c.shape[1] for c in chunks)
        dropped = any(a.kind == "drop_chunk" for a in actions)
        dups = sum(a.kind == "dup_chunk" for a in actions)
        assert total == (0 if dropped else CHUNK * (2 ** dups))


# ------------------------------------------------------------ supervisor
@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_quarantine_within_strike_budget_matches_jax(weights, jpool,
                                                      numerics):
    """NaN/Inf poison in slot 1 on two chunks in a row, a strike budget of
    2: flagged (held out of admission) after the first check, healed at
    the second, clean afterwards; every vote, health mask, flagged set,
    recovery count and reason equal to the JAX session's, check by
    check."""
    js, ts = _pair(weights, jpool, numerics, batch=2, supervisor=(1, 2))
    poison = _audio(2, seed=2)
    poison[1, 100:164] = np.nan
    poison[1, 200] = -np.inf
    for i, chunk in enumerate((_audio(2, seed=1), poison, poison,
                               _audio(2, seed=3), _audio(2, seed=4))):
        _same_out(js.process_audio(chunk), ts.process_audio(chunk), numerics)
        _same_robustness(js, ts)
        if i == 1:
            assert ts.unhealthy_slots()[1] & tstream.HEALTH_INPUT
            assert ts.flagged_slots() == {1}
            assert ts.summary().recoveries == 0
    summ = ts.summary()
    assert summ.recoveries == 1 and ts.flagged_slots() == frozenset()
    assert summ.recovery_reasons["input_nonfinite"] == 1
    assert not {k: v for k, v in ts.unhealthy_slots().items()
                if v & tstream.QUARANTINE_DEFAULT}


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_heal_and_admit_skip_flagged_match_jax(weights, jpool, numerics):
    """``heal()`` without a supervisor resets the flagged slot; with a
    strike budget the scheduler skips a flagged slot and keeps the
    request queued, as the reference's does."""
    js, ts = _pair(weights, jpool, numerics, batch=2, supervisor=None)
    poison = _audio(2, seed=5)
    poison[0, :64] = np.inf
    _same_out(js.process_audio(poison), ts.process_audio(poison), numerics)
    assert ts.flagged_slots() == frozenset()        # nobody checks
    assert ts.heal() == js.heal() == [0]
    _same_robustness(js, ts)
    assert ts.summary().recoveries == 1
    assert ts.heal(mask=tstream.HEALTH_SAT) == []

    js, ts = _pair(weights, jpool, numerics, batch=4, supervisor=(1, 2))
    poison = _audio(4, seed=6)
    poison[2, :64] = np.nan
    _same_out(js.process_audio(poison), ts.process_audio(poison), numerics)
    assert ts.flagged_slots() == js.flagged_slots() == {2}
    jsched, tsched = jstream.SlotScheduler(js), tstream.SlotScheduler(ts)
    for r in range(5):
        jsched.submit(r)
        tsched.submit(r)
    got, want = tsched.admit(), jsched.admit()
    assert got == want == [(0, 0), (1, 1), (3, 2)]
    assert len(tsched) == 2 and tsched.occupancy() == [3]
    assert tsched.n_shards == 1
    _same_out(js.process_audio(_audio(4, seed=7)),
              ts.process_audio(_audio(4, seed=7)), numerics)
    _same_robustness(js, ts)                        # slot 2 healed now
    assert ts.flagged_slots() == frozenset()
    assert tsched.admit() == jsched.admit() == [(2, 3)]


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_healed_slot_bit_identical_to_fresh(weights, numerics):
    """After quarantine and reset, both slots' decisions equal those of a
    fresh session reset at the same point, bit for bit."""
    follow = [_audio(2, seed=s) for s in (20, 21)]
    poison = _audio(2, seed=19)
    poison[0, :64] = np.nan
    healed = _port(weights, numerics, supervisor=(1, 1))
    healed.process_audio(poison)
    assert healed.summary().recoveries == 1
    fresh = _port(weights, numerics, supervisor=(1, 1))
    fresh.process_audio(_audio(2, seed=19))         # the clean twin
    fresh.reset_streams([0])
    for c in follow:
        h, f = healed.process_audio(c), fresh.process_audio(c)
        assert torch.equal(h.votes, f.votes) and torch.equal(h.nz, f.nz)
        assert torch.equal(h.logits, f.logits)


def test_supervisor_invisible_on_clean_audio(weights):
    """Clean streams: no recovery, nothing flagged, and every output bit
    equal with the supervisor on or off."""
    on = _port(weights, "float32", supervisor=(1, 1))
    off = _port(weights, "float32", supervisor=None)
    for s in range(3):
        chunk = _audio(2, seed=40 + s)
        a, b = on.process_audio(chunk), off.process_audio(chunk)
        assert torch.equal(a.logits, b.logits) and torch.equal(a.nz, b.nz)
    assert on.summary().recoveries == 0 and on.unhealthy_slots() == {}
    assert on.summary() == off.summary()
    on.reset()
    assert on.summary().recoveries == 0 and on.flagged_slots() == frozenset()


# ------------------------------------------------------------ set_threshold
@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_set_threshold_mid_stream_matches_jax(weights, jpool, numerics):
    """Δ_TH 0.1 → 0.4 → 0.1 between chunks, carried state untouched:
    every output equal to the JAX session doing the same; the switch
    changes what transmits."""
    js, ts = _pair(weights, jpool, numerics, batch=2)
    still = _port(weights, numerics, batch=2)
    for th, seed in ((0.1, 30), (0.4, 31), (0.4, 32), (0.1, 33)):
        js.set_threshold(th)
        ts.set_threshold(th)
        assert ts.threshold == th
        chunk = _audio(2, seed=seed)
        ot = ts.process_audio(chunk)
        _same_out(js.process_audio(chunk), ot, numerics)
        if seed == 31:
            assert not torch.equal(ot.nz, still.process_audio(chunk).nz)
        else:
            still.process_audio(chunk)
    for bad in (-0.1, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite and >= 0"):
            ts.set_threshold(bad)
    state = ts.state
    ts.set_threshold(0.1)                           # the current one: no-op
    assert ts.state is state and ts.threshold == 0.1


CAS_DET = dict(smooth_alpha=0.3, fire_threshold=0.09,
               release_threshold=0.088, refractory_frames=3)
CAS_VAD = dict(energy_threshold=0.02, hangover_frames=6)
# Taken from the cascade serving tests: thresholds read off the JAX run's
# stage-0 scores on this audio (none within 1e-4 of either).
CASCADE = {"float32": (0.405, 0.392), "int8": (0.40, 0.39)}
CAS_CHUNKS = (700, 1, 599)


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_cascade_set_threshold_moves_stage1_only(weights, numerics):
    """A cascade session's set_threshold moves stage 1's Δ_TH: stage 0
    keeps ``s0_threshold``, so the wake trace is that of a session never
    switched, and every output equals the JAX session's."""
    jparams, np_params = weights
    streams = jcont.make_streams(100, 2, duration_s=1.0, snr_db=20.0,
                                 events_per_min=120.0)
    audio = np.stack([s.audio[:sum(CAS_CHUNKS)] for s in streams])
    cfg0 = dataclasses.replace(J_SMOKE, vocab_size=2, d_model=16)
    jp0, _ = jkws.init_kws(jax.random.PRNGKey(7), cfg0, input_dim=4)
    wake, sleep = CASCADE[numerics]
    cas = dict(wake_threshold=wake, sleep_threshold=sleep,
               hangover_frames=3, s0_threshold=0.05, s0_channels=4)

    def port():
        return tstream.StreamingKwsSession(
            tkws.params_from_numpy(np_params), T_SMOKE, threshold=TH,
            batch=2, device="cpu", numerics=numerics,
            detector=tdet.DetectorConfig(**CAS_DET),
            vad=tvad.VADConfig(**CAS_VAD),
            cascade=tstream.CascadeConfig(**cas),
            stage0_params=tkws.params_from_numpy(
                {k: np.asarray(v) for k, v in jp0.items()}))

    js = jstream.StreamingKwsSession(
        jparams, J_SMOKE, threshold=TH, batch=2, fex=JFex(), backend="xla",
        fex_backend="xla", numerics=numerics,
        detector=jdet.DetectorConfig(**CAS_DET),
        vad=jvad.VADConfig(**CAS_VAD),
        cascade=jstream.CascadeConfig(**cas), stage0_params=jp0)
    ts, still = port(), port()
    lo, awake = 0, 0
    for n, th in zip(CAS_CHUNKS, (0.4, 0.4, 0.1)):
        js.set_threshold(th)
        ts.set_threshold(th)
        oj = js.process_audio(audio[:, lo:lo + n])
        ot = ts.process_audio(audio[:, lo:lo + n])
        os_ = still.process_audio(audio[:, lo:lo + n])
        lo += n
        assert torch.equal(ot.awake, os_.awake)     # stage 0 untouched
        np.testing.assert_array_equal(ot.awake.numpy(), np.asarray(oj.awake))
        np.testing.assert_array_equal(ot.events.numpy(),
                                      np.asarray(oj.events))
        _same_out(oj, ot, numerics)
        awake += int(ot.awake.sum())
    for a, b in zip(ts.cas_state.s0, still.cas_state.s0):
        assert torch.equal(a, b)
    assert awake > 0                                # stage 1 ran
    summ = ts.summary()
    assert summ.stage1_duty == still.summary().stage1_duty
    assert summ.sparsity != still.summary().sparsity
    assert summ.sparsity == js.summary().sparsity


# ------------------------------------------------------------ controller
class _StubSession:
    def __init__(self):
        self.thresholds = []

    def set_threshold(self, t):
        self.thresholds.append(t)


class _StubSched:
    def __init__(self):
        self.items = []

    def __len__(self):
        return len(self.items)

    def submit(self, payload):
        self.items.append(payload)


def test_controller_level_trace_matches_jax():
    """The same submit / observe sequence (bursts past the queue bound,
    dead-band stretches, watchdog breaches) through both controllers:
    equal levels, thresholds set and stats at every step."""
    rng = np.random.default_rng(3)
    pol = dict(thresholds=(0.1, 0.2, 0.4), max_queue=8, high_water=0.75,
               low_water=0.25, up_after=2, down_after=3, watchdog_ms=20.0)
    sides = []
    for mod in (jserve, tserve):
        sess, sched = _StubSession(), _StubSched()
        sides.append((mod.AdmissionController(sess, sched,
                                              mod.OverloadPolicy(**pol)),
                      sess, sched))
    for step in range(120):
        arrivals = int(rng.integers(0, 6)) if (step % 30) < 10 else 0
        served = int(rng.integers(0, 4))
        step_s = float(rng.choice([0.001, 0.005, 0.05]))
        for ctl, sess, sched in sides:
            for r in range(arrivals):
                ctl.submit(r)
            del sched.items[:served]
            ctl.observe(step_s)
        (jc, js_, _), (tc, ts_, _) = sides
        assert tc.stats() == jc.stats() and tc.level == jc.level
        assert ts_.thresholds == js_.thresholds
    stats = sides[1][0].stats()
    assert stats["escalations"] >= 2 and stats["releases"] >= 1
    assert stats["shed"] > 0 and stats["watchdog_breaches"] > 0


def test_overload_policy_validation():
    for kw, match in ((dict(thresholds=(0.4, 0.1)), "ascending"),
                      (dict(thresholds=(0.1, 0.1)), "ascending"),
                      (dict(thresholds=()), "rung"),
                      (dict(high_water=0.2, low_water=0.6), "low_water"),
                      (dict(max_queue=0), "max_queue"),
                      (dict(up_after=0), "up_after")):
        with pytest.raises(ValueError, match=match):
            tserve.OverloadPolicy(**kw)
    assert tserve._parse_ladder("0.2, 0.4", 0.1) == \
        jserve._parse_ladder("0.2, 0.4", 0.1) == (0.1, 0.2, 0.4)
    assert tserve._parse_ladder("", 0.1) == (0.1,)


# ------------------------------------------------------------ CLI
def _args(*extra):
    return tserve.build_parser().parse_args(["--mode", "kws-audio", *extra])


@pytest.mark.parametrize("flags,match", [
    (("--slots", "0"), "slots"),
    (("--threshold", "-0.5"), "threshold"),
    (("--threshold", "nan"), "threshold"),
    (("--watchdog-ms", "-1"), "watchdog"),
    (("--max-queue", "0"), "max-queue"),
    (("--inflight-depth", "0"), "inflight-depth"),
    (("--faults", "bogus_kind:0.5"), "fault"),
    (("--faults", "nan_burst"), "kind:rate"),
    (("--degrade-thresholds", "0.05"), "ascending"),
])
def test_validate_args_rejects(flags, match):
    with pytest.raises(ValueError, match=match):
        tserve.validate_args(_args(*flags))
    with pytest.raises(ValueError, match=match):     # as the reference
        jserve.validate_args(jserve.build_parser().parse_args(
            ["--mode", "kws-audio", *flags]))


def test_session_extras_force_trust_under_faults():
    args = _args("--faults", "nan_burst:0.5", "--fault-seed", "3")
    sup, policy, inj = tserve._session_extras(args)
    assert sup == tstream.SupervisorConfig() and policy == "trust"
    assert inj.plan == tfaults.FaultPlan(3, (tfaults.FaultSpec(
        "nan_burst", 0.5),)) and inj.n_slots == args.slots
    sup, policy, inj = tserve._session_extras(_args(
        "--no-supervisor", "--input-policy", "sanitize"))
    assert sup is None and policy == "sanitize" and inj is None
    assert (args.inflight_depth, args.max_queue, args.watchdog_ms) == \
        (2, 64, 0.0)


def test_serve_faults_cli_on_cpu(capsys):
    """A small fault run of the CLI: NaN bursts every step, duplicated and
    split chunks, the supervisor healing, depth 2."""
    argv = ["--mode", "kws-audio", "--device", "cpu", "--slots", "1",
            "--train-steps", "0",
            "--requests", "1", "--chunk-samples", "2048", "--numerics",
            "int8", "--faults", "nan_burst:1.0,dup_chunk:0.3,"
            "one_sample_chunk:0.5", "--degrade-thresholds", "0.2,0.4",
            "--max-queue", "4"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "pipeline depth 2" in out and "host-blocked/step" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("robustness"))
    assert "input_nonfinite" in line and "controller level 0" in line
    assert int(line.split()[1]) >= 1               # slot recoveries
