"""Port conformance, ΔGRU: repro_torch's ΔGRU against the JAX package's.

Same numpy weights and inputs through ``repro.core.delta_gru_scan``
(``backend="xla"``, the reference the repo's own tests pin its Pallas
kernel to) and the port's ``delta_gru_scan(backend="pallas")`` on CPU
tensors (the kernels' plain versions).  Tolerance: hs and state within
1e-5 absolute — the products Δ·W are summed in another order by each
library's matmul — and the per-frame transmit counts equal.  The
block-sparse path (``delta_matvec`` twice per frame, taken where the
sequence kernel cannot hold the weights) is held to 2e-5, the bound of
the reference's own test of its fallback (``tests/test_delta_gru_seq.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_gru as jdg
from repro_torch.core import delta_gru as tdg

I, H, T, B = 10, 16, 12, 3
ATOL = 1e-5


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((I, 3 * H)) / np.sqrt(I)).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (0.1 * rng.standard_normal(3 * H)).astype(np.float32))


def _xs(seed=1):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(0.15 * rng.standard_normal((T, B, I)), axis=0)
    return walk.astype(np.float32)


def _jax(w, xs, th):
    p = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    hs, st, stats = jdg.delta_gru_scan(p, jnp.asarray(xs), th,
                                       backend="xla")
    return (np.asarray(hs), [np.asarray(a) for a in st],
            np.asarray(stats.nz_dx), np.asarray(stats.nz_dh))


@pytest.mark.parametrize("th", [0.0, 0.1])
def test_matches_jax_with_carried_state(th):
    """The port, run as two chunks [0:5] and [5:12] with the state
    carried, equals the JAX scan over all 12 frames."""
    w, xs = _weights(), _xs()
    j_hs, j_st, j_nzx, j_nzh = _jax(w, xs, th)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    xt = torch.tensor(xs)
    hs_a, st, stats_a = tdg.delta_gru_scan(p, xt[:5], th, backend="pallas")
    hs_b, st, stats_b = tdg.delta_gru_scan(p, xt[5:], th, st,
                                           backend="pallas")
    np.testing.assert_allclose(torch.cat([hs_a, hs_b]).numpy(), j_hs,
                               rtol=0, atol=ATOL)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        torch.cat([stats_a.nz_dx, stats_b.nz_dx]).numpy(), j_nzx)
    np.testing.assert_array_equal(
        torch.cat([stats_a.nz_dh, stats_b.nz_dh]).numpy(), j_nzh)
    if th > 0:
        assert j_nzx.sum() < T * B * I       # the threshold skips deltas


def test_plain_kernel_version_equals_per_step_cell():
    """backend="pallas" on the CPU (the kernel's plain version) and
    backend="xla" (the per-step cell) do the same ops: bit-identical."""
    w, xs = _weights(2), _xs(3)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    a = tdg.delta_gru_scan(p, torch.tensor(xs), 0.1, backend="pallas")
    b = tdg.delta_gru_scan(p, torch.tensor(xs), 0.1, backend="xla")
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for x, y in zip((*a[1], *a[2]), (*b[1], *b[2])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_threshold_zero_equals_dense_gru():
    w, xs = _weights(4), _xs(5)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    hs, _, stats = tdg.delta_gru_scan(p, torch.tensor(xs), 0.0,
                                      backend="pallas")
    dense = tdg.dense_gru_scan(p, torch.tensor(xs))
    torch.testing.assert_close(hs, dense, rtol=3e-5, atol=3e-5)
    j_dense = jdg.dense_gru_scan(
        jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w)), jnp.asarray(xs))
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense),
                               rtol=0, atol=ATOL)
    # Δ_TH = 0 transmits every changed component (x is a random walk).
    assert int(stats.nz_dx.sum()) == T * B * I


def test_pallas_raises_above_kernel_shared_memory():
    """The sequence kernel raises for weights beyond one block's shared
    memory (227 KB), naming the limit and the path that holds them;
    ``delta_gru_scan(backend="pallas")`` takes that path, the block-sparse
    fallback, and matches the per-step scan."""
    from repro_torch.kernels import delta_gru_seq as tdgs
    h = 140                                  # (10+140)·420·4 B > 227 KB
    with pytest.raises(ValueError, match="227 KB.*delta_matvec"):
        tdgs.check_kernel_fits(I, h)
    assert not tdgs.seq_kernel_fits(I, h) and tdgs.seq_kernel_fits(I, 132)
    assert not tdgs.seq_kernel_fits(I, 133)            # 233,568 B
    rng = np.random.default_rng(8)
    p = tdg.DeltaGRUParams(
        torch.from_numpy((rng.standard_normal((I, 3 * h)) / 4
                          ).astype(np.float32)),
        torch.from_numpy((rng.standard_normal((h, 3 * h)) / 12
                          ).astype(np.float32)),
        torch.zeros(3 * h))
    xs = torch.from_numpy(rng.standard_normal((3, 2, I)).astype(np.float32))
    hs, _, st = tdg.delta_gru_scan(p, xs, 0.1, backend="pallas")
    hs_x, _, st_x = tdg.delta_gru_scan(p, xs, 0.1, backend="xla")
    assert hs.shape == (3, 2, h)
    torch.testing.assert_close(hs, hs_x, rtol=0, atol=ATOL)
    assert torch.equal(st.nz_dx, st_x.nz_dx)


# Edge cases chip_smoke.py holds the kernel to on the card, here for the
# plain version against JAX: one frame; every row sent (Δ_TH -1, zero
# deltas too); no row sent (Δ_TH above every |Δ|); x encoders in two warps
# (I = 40) beside 3H = 60 columns (H = 20).
@pytest.mark.parametrize("t,i,h,th", [(1, I, H, 0.1), (T, I, H, -1.0),
                                      (T, I, H, 1e9), (T, 40, 20, 0.1)])
def test_plain_version_matches_jax_at_edges(t, i, h, th):
    rng = np.random.default_rng(t + i + h)
    w = ((rng.standard_normal((i, 3 * h)) / np.sqrt(i)).astype(np.float32),
         (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32),
         (0.1 * rng.standard_normal(3 * h)).astype(np.float32))
    xs = np.cumsum(0.15 * rng.standard_normal((t, B, i)), 0).astype(
        np.float32)
    j_hs, j_st, j_nzx, j_nzh = _jax(w, xs, th)
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    hs, st, stats = tdg.delta_gru_scan(p, torch.tensor(xs), th,
                                       backend="pallas")
    np.testing.assert_allclose(hs.numpy(), j_hs, rtol=0, atol=ATOL)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(stats.nz_dx.numpy(), j_nzx)
    np.testing.assert_array_equal(stats.nz_dh.numpy(), j_nzh)
    sent = int(stats.nz_dx.sum() + stats.nz_dh.sum())
    if th < 0:
        assert sent == t * B * (i + h)
    if th > 1e6:
        assert sent == 0


@pytest.mark.parametrize("i", [10, 20, 40, 64, 96])
def test_gru_launch_plan_holds_the_fallback_boundary(i):
    """The float kernel's plan: one CTA per stream, a warp multiple of
    threads covering 3H and I, and shared memory as the kernel lays it
    out (weights at a pitch of 3H rounded up to 4 floats, a list segment
    per warp, two gate rows, the counts).  Only the weights decide where
    the fallback starts: still H = 133 at I = 10."""
    from repro_torch.kernels import delta_gru_seq as tdgs
    h_max = max(h for h in range(1, 342) if tdgs.seq_kernel_fits(i, h))
    plan = tdgs.gru_launch_plan(3, i, h_max)
    with pytest.raises(ValueError, match="227 KB"):
        tdgs.gru_launch_plan(3, i, h_max + 1)
    assert plan["ctas"] == 3 and plan["threads"] % 32 == 0
    assert plan["threads"] >= max(3 * h_max, i)
    pitch = -(-3 * h_max // 4) * 4
    weights = 4 * (i + h_max) * pitch
    assert plan["smem_bytes"] == tdgs.seq_kernel_smem_bytes(i, h_max)
    assert weights < plan["smem_bytes"] <= tdgs.MAX_SMEM_BYTES
    assert plan["smem_bytes"] - weights < 6_000        # the rest is small
    if i == 10:
        assert h_max == 132
        assert tdgs.gru_launch_plan(32, 10, 64) == {
            "ctas": 32, "threads": 192,
            "smem_bytes": 4 * 74 * 192 + 256 * 3 + 8 * 192 + 16}


def _spy_matvec(monkeypatch):
    """Count the block-sparse path's ``delta_matvec`` calls."""
    calls = []
    real = tdg.delta_matvec

    def spy(*a, **k):
        calls.append(k["block_i"])
        return real(*a, **k)
    monkeypatch.setattr(tdg, "delta_matvec", spy)
    return calls


def test_blocked_fallback_matches_jax_and_carries_state(monkeypatch):
    """I=256, H=128 forced through the block-sparse path
    (``smem_budget_bytes=1024``, as the reference's test forces it with
    ``vmem_budget_bytes``) against the JAX per-step scan; two chunks with
    the state carried equal one call."""
    rng = np.random.default_rng(11)
    i, h, t, b = 256, 128, 8, 4
    w = ((rng.standard_normal((i, 3 * h)) / np.sqrt(i)).astype(np.float32),
         (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32),
         np.zeros(3 * h, np.float32))
    xs = rng.standard_normal((t, b, i)).astype(np.float32)
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    j_hs, j_st, j_stats = jdg.delta_gru_scan(jp, jnp.asarray(xs), 0.3,
                                             backend="xla")
    calls = _spy_matvec(monkeypatch)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    xt = torch.from_numpy(xs)
    kw = dict(backend="pallas", smem_budget_bytes=1024)
    hs, st, stats = tdg.delta_gru_scan(p, xt, 0.3, **kw)
    assert len(calls) == 2 * t and set(calls) == {128}
    np.testing.assert_allclose(hs.numpy(), np.asarray(j_hs), rtol=2e-5,
                               atol=2e-5)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_array_equal(stats.nz_dx.numpy(),
                                  np.asarray(j_stats.nz_dx))
    np.testing.assert_array_equal(stats.nz_dh.numpy(),
                                  np.asarray(j_stats.nz_dh))
    hs_a, st_a, _ = tdg.delta_gru_scan(p, xt[:3], 0.3, **kw)
    hs_b, st_b, _ = tdg.delta_gru_scan(p, xt[3:], 0.3, st_a, **kw)
    assert torch.equal(torch.cat([hs_a, hs_b]), hs)
    for x, y in zip(st_b, st):
        assert torch.equal(x, y)


def test_full_width_forced_fallback_equals_sequence_path(monkeypatch):
    """The paper's width (I=10, H=64) forced through the block-sparse
    path (``smem_budget_bytes=0``): one input block per matvec, so it
    equals the sequence kernel's plain version bit for bit, and the JAX
    per-step scan within 2e-5."""
    rng = np.random.default_rng(12)
    h = 64
    w = ((rng.standard_normal((I, 3 * h)) / np.sqrt(I)).astype(np.float32),
         (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32),
         (0.1 * rng.standard_normal(3 * h)).astype(np.float32))
    xs = np.cumsum(0.2 * rng.standard_normal((16, 3, I)), 0).astype(
        np.float32)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    seq = tdg.delta_gru_scan(p, torch.from_numpy(xs), 0.1, backend="pallas")
    calls = _spy_matvec(monkeypatch)
    blk = tdg.delta_gru_scan(p, torch.from_numpy(xs), 0.1, backend="pallas",
                             smem_budget_bytes=0)
    assert sorted(set(calls)) == [10, 64] and len(calls) == 2 * 16
    for x, y in zip((blk[0], *blk[1], *blk[2]), (seq[0], *seq[1], *seq[2])):
        assert torch.equal(x, y)
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    j_hs, _, _ = jdg.delta_gru_scan(jp, jnp.asarray(xs), 0.1, backend="xla")
    np.testing.assert_allclose(blk[0].numpy(), np.asarray(j_hs), rtol=2e-5,
                               atol=2e-5)


def test_session_above_shared_memory_serves_through_fallback(monkeypatch):
    """A session at H=160 (348 KB of weights per block, above 227 KB)
    takes the block-sparse path with no knob set, and decides as the JAX
    package's per-step reference does on the same weights: per-frame
    votes and transmit counts of its session, and forward_audio."""
    import dataclasses

    import jax
    from repro.configs.deltakws import CONFIG as J_CONFIG
    from repro.data import gscd as jgscd
    from repro.frontend.fex import FeatureExtractor as JFex
    from repro.launch import streaming as jstream
    from repro.models import kws as jkws
    from repro_torch.configs.deltakws import CONFIG as T_CONFIG
    from repro_torch.frontend.fex import FeatureExtractor as TFex
    from repro_torch.launch import streaming as tstream
    from repro_torch.models import kws as tkws
    jcfg = dataclasses.replace(J_CONFIG, d_model=160)
    tcfg = dataclasses.replace(T_CONFIG, d_model=160)
    jparams, _ = jkws.init_kws(jax.random.PRNGKey(3), jcfg, input_dim=10)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    audio, _ = jgscd.synth_batch(np.random.default_rng(9), 2)
    audio = audio[:, 1500:1500 + 10 * 128]
    calls = _spy_matvec(monkeypatch)
    ts = tstream.StreamingKwsSession(tkws.params_from_numpy(np_params), tcfg,
                                     threshold=0.1, batch=2, device="cpu")
    js = jstream.StreamingKwsSession(jparams, jcfg, threshold=0.1, batch=2,
                                     fex=JFex(), backend="xla",
                                     fex_backend="xla")
    got, want = ts.process_audio(audio), js.process_audio(audio)
    assert len(calls) == 2 * 10
    np.testing.assert_array_equal(got.votes.numpy(), np.asarray(want.votes))
    np.testing.assert_array_equal(got.nz.numpy(), np.asarray(want.nz))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=2e-5)
    t_logits, _ = tkws.forward_audio(tkws.params_from_numpy(np_params), tcfg,
                                     torch.from_numpy(audio), TFex(),
                                     threshold=0.1, backend="pallas")
    j_logits, _ = jkws.forward_audio(jparams, jcfg, audio, JFex(),
                                     threshold=0.1, backend="xla",
                                     fex_backend="xla")
    np.testing.assert_array_equal(t_logits.argmax(-1).numpy(),
                                  np.argmax(np.asarray(j_logits), -1))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=2e-5)


def test_unknown_backend_rejected():
    w = _weights()
    p = tdg.DeltaGRUParams(*(torch.tensor(a) for a in w))
    with pytest.raises(ValueError, match="unknown"):
        tdg.delta_gru_scan(p, torch.zeros(1, 1, I), backend="pallas-int")
