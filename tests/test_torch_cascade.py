"""Port conformance, the wake cascade's parts: repro_torch's wake machine,
masked ΔGRU scans and event-driven compaction against the JAX package's,
on the same numpy inputs.

The JAX side runs its plain scans (``backend="xla"``); the port runs its
kernel wrappers on CPU tensors, i.e. the plain versions.  Tolerances: the
wake machine, every integer code, transmit count, compaction report and
counter — equal; float hs and state within 1e-5 of the reference's
masked scan (the products Δ·W are summed in another order by each
library; XLA also fuses its masked scan differently from its dense one),
while the frozen rows and an awake-everywhere trace against the port's
own unmasked scan are held bit for bit (same arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import delta_gru as jdg
from repro.core import fixed_point as jfp
from repro.kernels import compaction as jcomp
from repro.launch import streaming as jstream
from repro_torch.core import delta_gru as tdg
from repro_torch.core import fixed_point as tfp
from repro_torch.kernels import compaction as tcomp
from repro_torch.kernels import delta_gru_seq as tdgs
from repro_torch.kernels import wake_head as twh
from repro_torch.launch import streaming as tstream
from test_torch_xla_math import xla_fma  # noqa: F401  (a fixture)

ATOL = 1e-5


# ----------------------------------------------------------- wake machine --
def _wake_all(cfg, score, awake=None, hang=None):
    """(closed form, loop, JAX) on one chunk of (F, B) scores."""
    B = score.shape[1]
    awake = np.zeros(B, bool) if awake is None else np.array(awake)
    hang = np.zeros(B, np.int32) if hang is None else np.array(hang)
    tcfg = tstream.CascadeConfig(*cfg)
    args = (torch.from_numpy(awake), torch.from_numpy(hang),
            torch.from_numpy(score))
    closed = tstream.cascade_wake_scan(tcfg, *args)
    loop = tstream.cascade_wake_scan_loop(tcfg, *args)
    ref = jstream.cascade_wake_scan(cfg, jnp.asarray(awake),
                                    jnp.asarray(hang), jnp.asarray(score))
    return ([t.numpy() for t in closed], [t.numpy() for t in loop],
            [np.asarray(a) for a in ref])


def _assert_wake_equal(cfg, score, awake=None, hang=None):
    closed, loop, ref = _wake_all(cfg, score, awake, hang)
    for c, lo, r, name in zip(closed, loop, ref, ("trace", "awake", "hang")):
        assert c.dtype == r.dtype, name
        np.testing.assert_array_equal(c, r, err_msg=name)
        np.testing.assert_array_equal(lo, r, err_msg=name)
    return closed


@pytest.mark.parametrize("case", ["wake-hold-sleep", "hangover",
                                  "hold-refreshes"])
def test_wake_machine_reference_cases(case):
    """The reference's own wake-machine cases (tests/test_cascade.py)."""
    if case == "wake-hold-sleep":
        cfg = jstream.CascadeConfig(0.5, 0.3, 0)
        score, want = [0.40, 0.60, 0.35, 0.31, 0.29, 0.45], [0, 1, 1, 1, 0, 0]
    elif case == "hangover":
        cfg = jstream.CascadeConfig(0.5, 0.3, 3)
        score, want = [0.9] + [0.0] * 6, [1, 1, 1, 1, 0, 0, 0]
    else:
        cfg = jstream.CascadeConfig(0.5, 0.3, 3)
        score = [0.9, 0.0, 0.4, 0.0, 0.0, 0.0, 0.0]
        want = [1, 1, 1, 1, 1, 1, 0]
    trace, _, _ = _assert_wake_equal(
        cfg, np.asarray(score, np.float32)[:, None])
    np.testing.assert_array_equal(trace[:, 0], want)


@pytest.mark.parametrize("hangover,wake,sleep,nan", [
    (0, 0.6, 0.4, False), (2, 0.5, 0.5, False), (3, 0.6, 0.3, True),
    (5, 0.7, 0.2, True)])
def test_wake_machine_carried_split_points(hangover, wake, sleep, nan):
    """Hangover 0, wake = sleep and NaN scores, over carried chunks that
    include a one-frame and a zero-frame chunk: every chunk's trace and
    carried state equal the loop's and JAX's, and the pieces equal the
    whole."""
    cfg = jstream.CascadeConfig(wake, sleep, hangover)
    rng = np.random.default_rng(hangover)
    score = rng.uniform(0, 1, (60, 4)).astype(np.float32)
    if nan:
        score[rng.random(score.shape) < 0.1] = np.nan
    whole, _, _ = _assert_wake_equal(cfg, score)
    parts, awake, hang = [], None, None
    for lo, hi in ((0, 13), (13, 14), (14, 14), (14, 41), (41, 60)):
        trace, awake, hang = _assert_wake_equal(cfg, score[lo:hi], awake,
                                                hang)
        parts.append(trace)
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    assert 0 < whole.mean() < 1


def test_wake_machine_fuzz_over_reached_states():
    """Random thresholds (wake = sleep in a fifth of the cases), hangovers
    0–5, chunk lengths 0–39 and NaN scores, from the carried states the
    machine reached on a random prefix: the chunk's trace and carried
    state equal the loop's, and JAX's run over prefix and chunk at once
    (one JAX call a case: its scan compiles per call)."""
    rng = np.random.default_rng(11)
    awake_frames = 0
    for _ in range(30):
        sleep = float(rng.uniform(0.2, 0.6))
        wake = sleep if rng.random() < 0.2 else float(rng.uniform(sleep, 0.9))
        cfg = jstream.CascadeConfig(wake, sleep, int(rng.integers(0, 6)))
        tcfg = tstream.CascadeConfig(*cfg)
        score = rng.uniform(0, 1, (int(rng.integers(0, 60)), 8))
        score[rng.random(score.shape) < 0.05] = np.nan
        score = score.astype(np.float32)
        cut = int(rng.integers(0, len(score) + 1))
        zero = (torch.zeros(8, dtype=torch.bool),
                torch.zeros(8, dtype=torch.int32))
        _, awake, hang = tstream.cascade_wake_scan_loop(
            tcfg, *zero, torch.from_numpy(score[:cut]))
        args = (awake, hang, torch.from_numpy(score[cut:]))
        closed = tstream.cascade_wake_scan(tcfg, *args)
        loop = tstream.cascade_wake_scan_loop(tcfg, *args)
        ref = jstream.cascade_wake_scan(cfg, jnp.zeros(8, bool),
                                        jnp.zeros(8, jnp.int32),
                                        jnp.asarray(score))
        want = (np.asarray(ref[0])[cut:], np.asarray(ref[1]),
                np.asarray(ref[2]))
        for c, lo, w in zip(closed, loop, want):
            np.testing.assert_array_equal(c.numpy(), w)
            np.testing.assert_array_equal(lo.numpy(), w)
        awake_frames += int(closed[0].sum())
    assert awake_frames > 0


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_wake_machine_op_count_is_independent_of_the_frame_count():
    cfg = tstream.CascadeConfig(0.6, 0.4, 3)
    counts = []
    for F in (1, 8, 32, 200):
        score = torch.rand((F, 5), generator=torch.Generator().manual_seed(F))
        awake = torch.tensor([True, False, True, False, True])
        hang = torch.tensor([2, 0, 0, 0, 3], dtype=torch.int32)
        with _CountOps() as ops:
            tstream.cascade_wake_scan(cfg, awake, hang, score)
        counts.append(ops.n)
    assert len(set(counts)) == 1 and counts[0] <= 50, counts


@pytest.mark.parametrize("B", [1, 31, 32, 33, 256, 1000])
def test_wake_head_plan_covers_every_slot(B):
    grid, block = twh.wake_launch_plan(B, 2)
    assert block % 32 == 0 and 32 <= block <= twh.BLOCK
    assert grid * block >= B and (grid - 1) * block < B
    for K in (1, twh.MAX_CLASSES + 1):
        with pytest.raises(ValueError, match="classes"):
            twh.wake_launch_plan(B, K)


def test_wake_head_plain_version_is_softmax_then_the_closed_form():
    """On a CPU tensor ``wake_head`` runs its plain version: XLA's softmax,
    class 1, then the closed-form machine, from a carried state."""
    from repro_torch.kernels.detect_head import xla_softmax
    cfg = tstream.CascadeConfig(0.6, 0.45, 3)
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((40, 6, 2), generator=gen)
    awake = torch.tensor([True, False] * 3)
    hang = torch.tensor([2, 0, 0, 0, 3, 0], dtype=torch.int32)
    got = twh.wake_head(logits, awake, hang, cfg)
    want = tstream.cascade_wake_scan_loop(
        cfg, awake, hang, xla_softmax(logits)[..., 1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < got[0].float().mean() < 1
    with pytest.raises(ValueError, match="hang must be"):
        twh.wake_head(logits, awake, hang.long(), cfg)


# ---------------------------------------------------------- masked scans --
I, H, T, B = 6, 12, 20, 5


def _float_case(seed=0):
    rng = np.random.default_rng(seed)
    w = ((rng.standard_normal((I, 3 * H)) / np.sqrt(I)).astype(np.float32),
         (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
         (0.1 * rng.standard_normal(3 * H)).astype(np.float32))
    xs = np.cumsum(0.2 * rng.standard_normal((T, B, I)), 0).astype(np.float32)
    awake = rng.random((T, B)) < 0.5
    awake[:, 0] = False                     # asleep throughout
    awake[:, 1] = True                      # awake throughout
    awake[0, 2] = False                     # first frame asleep
    awake[-1, 3] = False                    # last frame asleep
    return w, xs, awake


def _warm_states(w, xs):
    """A non-trivial carried state: the port's and JAX's after 8 frames."""
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    _, jst, _ = jdg.delta_gru_scan(jp, jnp.asarray(xs[:8]), 0.0,
                                   backend="xla")
    tp = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    _, tst, _ = tdg.delta_gru_scan(tp, torch.from_numpy(xs[:8]), 0.0,
                                   backend="pallas")
    return jp, jst, tp, tst


@pytest.mark.parametrize("th", [0.0, 0.1])
def test_masked_float_scan_matches_jax_and_freezes(th):
    w, xs, awake = _float_case()
    jp, jst, tp, tst = _warm_states(w, xs)
    x = xs[8:]
    j_hs, j_st, j_stats = jdg.masked_delta_gru_scan(
        jp, jnp.asarray(x), th, jst, jnp.asarray(awake[8:]))
    hs, st, stats = tdg.masked_delta_gru_scan(
        tp, torch.from_numpy(x), th, tst, torch.from_numpy(awake[8:]))
    np.testing.assert_allclose(hs.numpy(), np.asarray(j_hs), rtol=0,
                               atol=ATOL)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    for f in ("nz_dx", "nz_dh", "macs", "macs_dense", "sram_reads"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(j_stats, f)), f)
    # Slot 0 slept throughout: its state and every hs row are the carried
    # state's, bit for bit, and it counted no work.
    for got, before in zip(st, tst):
        assert torch.equal(got[0], before[0])
    assert torch.equal(hs[:, 0], tst.h[0].expand(len(x), H))
    assert int(stats.macs[:, 0].sum()) == 0 and (stats.macs_dense > 0).all()


def test_masked_float_scan_awake_everywhere_is_the_unmasked_scan():
    w, xs, _ = _float_case(1)
    _, _, tp, tst = _warm_states(w, xs)
    x = torch.from_numpy(xs[8:])
    hs_m, st_m, stats_m = tdg.masked_delta_gru_scan(
        tp, x, 0.1, tst, torch.ones(x.shape[:2], dtype=torch.bool))
    hs_d, st_d, stats_d = tdg.delta_gru_scan(tp, x, 0.1, tst,
                                             backend="pallas")
    assert torch.equal(hs_m, hs_d)
    for a, b in zip((*st_m, *stats_m), (*st_d, *stats_d)):
        assert torch.equal(a, b)


def test_masked_blocked_path_freezes_like_the_sequence_path():
    """``smem_budget_bytes=0`` forces the block-sparse path (delta_matvec
    twice per frame): same freeze, same counts, hs and state equal to the
    sequence path's plain version, both within 1e-5 of JAX."""
    w, xs, awake = _float_case(2)
    jp, jst, tp, tst = _warm_states(w, xs)
    x, a = torch.from_numpy(xs[8:]), torch.from_numpy(awake[8:])
    hs_b, st_b, stats_b = tdg.masked_delta_gru_scan(tp, x, 0.1, tst, a,
                                                    smem_budget_bytes=0)
    hs_s, st_s, stats_s = tdg.masked_delta_gru_scan(tp, x, 0.1, tst, a)
    j_hs, _, _ = jdg.masked_delta_gru_scan(jp, jnp.asarray(xs[8:]), 0.1, jst,
                                           jnp.asarray(awake[8:]))
    np.testing.assert_allclose(hs_b.numpy(), np.asarray(j_hs), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(hs_b.numpy(), hs_s.numpy(), rtol=0, atol=ATOL)
    for f in ("nz_dx", "nz_dh", "macs"):
        assert torch.equal(getattr(stats_b, f), getattr(stats_s, f))
    for got, before in zip(st_b, tst):
        assert torch.equal(got[0], before[0])


@pytest.fixture(scope="module")
def int_case():
    w, xs, awake = _float_case(3)
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    jw, fmt = jfp.quantize_gru(jp)
    codes = np.array(jfp.to_code(jnp.asarray(xs * 0.4), fmt.feat_frac, 16,
                                 jnp.int16))
    tw = tfp.IntGruWeights(*(torch.from_numpy(np.array(a)) for a in jw))
    tfmt = tfp.GruFormats(**{f: getattr(fmt, f) for f in
                             tfp.GruFormats.__dataclass_fields__})
    return jw, fmt, tw, tfmt, codes, awake


@pytest.mark.parametrize("th", [0.0, 0.1])
def test_masked_int_scan_bit_exact_against_jax(int_case, th, xla_fma):
    jw, fmt, tw, tfmt, codes, awake = int_case
    _, jst, _, _ = jfp.int_gru_scan(jw, fmt, jnp.asarray(codes[:8]), th,
                                    backend="xla")
    _, tst, _, _ = tfp.int_gru_scan(tw, tfmt, torch.from_numpy(codes[:8]),
                                    th, backend="pallas")
    want = jfp.masked_int_gru_scan(jw, fmt, jnp.asarray(codes[8:]), th, jst,
                                   jnp.asarray(awake[8:]))
    got = tfp.masked_int_gru_scan(tw, tfmt, torch.from_numpy(codes[8:]), th,
                                  tst, torch.from_numpy(awake[8:]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w_ in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    for g, w_ in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[2][:, 0].sum() == 0 and got[2][:, 1].sum() > 0
    for g, before in zip(got[1], tst):
        assert torch.equal(g[0], before[0])
    # Awake everywhere: the unmasked integer scan.
    ones = torch.ones((T - 8, B), dtype=torch.bool)
    full = tfp.masked_int_gru_scan(tw, tfmt, torch.from_numpy(codes[8:]), th,
                                   tst, ones)
    dense = tfp.int_gru_scan(tw, tfmt, torch.from_numpy(codes[8:]), th, tst,
                             backend="pallas")
    assert torch.equal(full[0], dense[0])
    for g, d in zip((*full[1], *full[2:]), (*dense[1], *dense[2:])):
        assert torch.equal(g, d)


def test_masked_scans_check_the_trace_and_refuse_wide_int8():
    w, xs, awake = _float_case()
    tp = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    st = tdg.init_delta_state(B, I, H, tp)
    x = torch.from_numpy(xs)
    with pytest.raises(ValueError, match="awake has shape"):
        tdg.masked_delta_gru_scan(tp, x, 0.1, st,
                                  torch.ones((T, B + 1), dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        tdg.masked_delta_gru_scan(tp, x, 0.1, st, torch.ones((T, B)))
    wide = tfp.IntGruWeights(torch.zeros((10, 3 * 400), dtype=torch.int8),
                             torch.zeros((400, 3 * 400), dtype=torch.int8),
                             torch.zeros(3 * 400, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="227 KB"):
        tfp.masked_int_gru_scan(
            wide, tfp.GruFormats(), torch.zeros((2, 1, 10), dtype=torch.int16),
            0.1, tfp.init_int_delta_state(1, 10, 400, wide),
            torch.ones((2, 1), dtype=torch.bool))


@pytest.mark.parametrize("I_,H_,B_,T_", [(10, 64, 256, 32), (4, 16, 33, 1),
                                         (4, 16, 256, 100), (7, 5, 3, 100)])
def test_masked_launch_plans_equal_the_unmasked(I_, H_, B_, T_):
    """The wake bits live in registers (csrc/wake_bits.cuh), so each
    wrapper launches its masked instantiation with the unmasked plan, at
    stage 1's width and stage 0's: a CTA per stream, threads over every
    column and input, the shared memory the kernel's layout needs."""
    for plan, smem in (
            (tdgs.gru_launch_plan(B_, I_, H_),
             tdgs.seq_kernel_smem_bytes(I_, H_)),
            (tdgs.gru_int_launch_plan(B_, I_, H_, T_),
             tdgs.int_seq_kernel_smem_bytes(
                 I_, H_, min(T_, tdgs.INT_X_FRAMES)))):
        assert plan["ctas"] == B_ and plan["smem_bytes"] == smem
        assert plan["threads"] % 32 == 0
        assert plan["threads"] >= max(3 * H_, I_)


# ----------------------------------------------------- event-driven mode --
def _held_case(rng, I_, H_, Bn, Tn):
    """Inputs where some slots hold (constant input under a wide
    deadband) while the others move."""
    xs = (rng.normal(size=(Tn, Bn, I_)) * 0.5).astype(np.float32)
    frozen = np.arange(Bn) % 2 == 0
    xs[:, frozen] = xs[0, frozen]
    return xs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_event_driven_float_is_the_dense_scan(backend):
    rng = np.random.default_rng(42)
    I_, H_, Bn, Tn, th = 5, 8, 6, 17, 0.2
    xs = _held_case(rng, I_, H_, Bn, Tn)
    w = _float_case(4)[0]
    tp = tdg.DeltaGRUParams(torch.from_numpy(w[0][:I_, :3 * H_]),
                            torch.from_numpy(w[1][:H_, :3 * H_]),
                            torch.from_numpy(w[2][:3 * H_]))
    st = tdg.init_delta_state(Bn, I_, H_, tp)
    warm = torch.from_numpy(xs[:1]).expand(150, -1, -1)
    _, st, _ = tdg.delta_gru_scan(tp, warm, th, st, backend=backend)
    x = torch.from_numpy(xs)
    hs_d, st_d, stats_d = tdg.delta_gru_scan(tp, x, th, st, backend=backend)
    tcomp.reset_counters()
    parts, st_e, nzx = [], st, []
    for lo, hi in ((0, 5), (5, 6), (6, 17)):
        hs_c, st_e, stats_c = tdg.delta_gru_scan(tp, x[lo:hi], th, st_e,
                                                 backend=backend,
                                                 event_driven=True)
        parts.append(hs_c)
        nzx.append(stats_c.nz_dx)
    assert tcomp.counters()["slots_skipped"] > 0
    assert torch.equal(torch.cat(parts), hs_d)
    assert torch.equal(torch.cat(nzx), stats_d.nz_dx)
    for a, b in zip(st_e, st_d):
        assert torch.equal(a, b)


def test_event_driven_int8_reports_and_counters_equal_jax(int_case, xla_fma,
                                                         monkeypatch):
    """The integer path: bit for bit the dense scan, and every chunk's
    CompactionReport and the module counters equal the reference's."""
    jw, fmt, tw, tfmt, _, _ = int_case
    rng = np.random.default_rng(43)
    xs = _held_case(rng, I, H, 7, 21)
    codes = np.asarray(jfp.to_code(jnp.asarray(xs * 0.8), fmt.feat_frac, 16,
                                   jnp.int16))
    th = 0.2
    warm = np.broadcast_to(codes[:1], (150,) + codes.shape[1:]).copy()
    _, jst, _, _ = jfp.int_gru_scan(jw, fmt, jnp.asarray(warm), th,
                                    backend="xla")
    _, tst, _, _ = tfp.int_gru_scan(tw, tfmt, torch.from_numpy(warm), th,
                                    backend="pallas")
    dense = tfp.int_gru_scan(tw, tfmt, torch.from_numpy(codes), th, tst,
                             backend="pallas")
    reports = {"jax": [], "port": []}
    for side, mod in (("jax", jcomp), ("port", tcomp)):
        def spy(*a, _orig=mod.event_driven_seq, _side=side):
            out = _orig(*a)
            reports[_side].append(tuple(int(v) for v in out[-1]))
            return out
        monkeypatch.setattr(mod, "event_driven_seq", spy)
    jcomp.reset_counters()
    tcomp.reset_counters()
    parts, st_e, jst_e = [], tst, jst
    for lo, hi in ((0, 1), (1, 9), (9, 21)):
        hs_c, st_e, nzx_c, nzh_c = tfp.int_gru_scan(
            tw, tfmt, torch.from_numpy(codes[lo:hi]), th, st_e,
            backend="pallas", event_driven=True)
        _, jst_e, _, _ = jfp.int_gru_scan(
            jw, fmt, jnp.asarray(codes[lo:hi]), th, state=jst_e,
            backend="xla", event_driven=True)
        parts.append((hs_c, nzx_c, nzh_c))
    assert len(reports["port"]) == 3
    assert reports["port"] == reports["jax"]
    assert sum(r[1] for r in reports["port"]) > 0          # n_skipped
    assert tcomp.counters() == jcomp.counters()
    for i, full in enumerate((dense[0], dense[2], dense[3])):
        assert torch.equal(torch.cat([p[i] for p in parts]), full)
    for a, b in zip(st_e, dense[1]):
        assert torch.equal(a, b)
    for a, b in zip(st_e, jst_e):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
