"""Port conformance, kernel autotuning: ``repro_torch.kernels.autotune``
against the reference's ``repro.kernels.autotune`` — cache robustness,
the validation messages word for word, dispatch pickup — and the
property that makes tuning safe: every legal knob value gives the
default launch's outputs bit for bit, in both numerics.

On the CPU the kernel wrappers run their plain versions, which honour
``block_b`` by running slices of streams and validate ``block_t`` /
``unroll`` (the kernels' own knobs are held bit for bit on the card by
``chip_smoke.py``).  The live reference is the JAX package's
``backend="xla"`` scans: int8 and the FEx bit for bit, the float ΔGRU
within 1e-5 (its matmul sums run in another order).  Every test that
records points the cache at a temporary file.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.core import delta_gru as jdg
from repro.core import fixed_point as jfp
from repro.frontend import fex as jfx
from repro.kernels import autotune as jat
from repro.kernels import delta_gru_seq as jdgs
from repro.kernels import iir_fex as jiir
from repro.launch import streaming as jstream
from repro.models import kws as jkws
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.core import delta_gru as tdg
from repro_torch.core import fixed_point as tfp
from repro_torch.frontend import fex as tfx
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import delta_gru_seq as tdgs
from repro_torch.kernels import iir_fex as tiir
from repro_torch.launch import streaming as tstream
from repro_torch.models import kws as tkws

TH = 0.2
ATOL = 1e-5
SHIFT = 128


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Point both packages' autotune cache at a fresh temp file."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(tat.ENV_CACHE, str(path))
    monkeypatch.delenv(tat.ENV_ENABLE, raising=False)
    tat.clear_memo()
    jat.clear_memo()
    yield path
    tat.clear_memo()
    jat.clear_memo()


# ------------------------------------------------------------ cache I/O
def test_missing_cache_falls_back_to_defaults(cache):
    assert not cache.exists()
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) is None
    assert tat.resolve("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                       B=8, T=100) == {}


def test_corrupt_cache_falls_back_without_error(cache):
    cache.write_text("{ this is not json !!!")
    tat.clear_memo()
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) is None
    cache.write_text(json.dumps({"schema": tat.SCHEMA_VERSION,
                                 "entries": [1, 2, 3]}))
    tat.clear_memo()
    assert tat.resolve("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                       B=8, T=100) == {}
    cache.write_text(json.dumps({"schema": tat.SCHEMA_VERSION, "entries": {
        tat.cache_key("delta_gru_seq", (8, 64, 64), "float32", 0.2):
            {"config": [4]}}}))
    tat.clear_memo()
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) is None
    # Recording over a corrupt file starts a fresh, well-formed one.
    cache.write_text("{ not json")
    tat.record("delta_gru_seq", (8, 64, 64), "float32", 0.2,
               {"block_b": 2}, tuned_us=1.0, default_us=2.0)
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) == \
        {"block_b": 2}


def test_stale_schema_falls_back(cache):
    key = tat.cache_key("delta_gru_seq", (8, 64, 64), "float32", 0.2)
    cache.write_text(json.dumps({
        "schema": tat.SCHEMA_VERSION + 1,
        "entries": {key: {"config": {"block_b": 2}}}}))
    tat.clear_memo()
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) is None


def test_record_then_hit_roundtrip(cache):
    key = tat.record("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                     {"block_b": 4, "block_t": 2}, tuned_us=10.0,
                     default_us=20.0)
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) == \
        {"block_b": 4, "block_t": 2}
    blob = json.loads(cache.read_text())
    assert blob["schema"] == tat.SCHEMA_VERSION == jat.SCHEMA_VERSION
    assert blob["entries"][key]["speedup"] == pytest.approx(2.0)
    tat.record("batched_iir_fex", (8, 10, 128), "float32", 0.0,
               {"block_b": 8, "unroll": None}, tuned_us=1.0,
               default_us=2.0)
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2) == \
        {"block_b": 4, "block_t": 2}
    # A knob left at the default launch (None) is not written.
    assert tat.lookup("batched_iir_fex", (8, 10, 128), "float32", 0.0) == \
        {"block_b": 8}


def test_key_separates_threshold_buckets_and_platform(cache, monkeypatch):
    tat.record("delta_gru_seq", (8, 64, 64), "float32", 0.2,
               {"block_t": 2}, tuned_us=1.0, default_us=2.0, device="cpu")
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.21,
                      device="cpu") == {"block_t": 2}
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.5,
                      device="cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    k_cpu = tat.cache_key("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                          device="cpu")
    k_gpu = tat.cache_key("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                          device="cuda:0")
    assert k_cpu.endswith("|cpu-eager")
    assert k_gpu.endswith("|cuda-NVIDIA H100 80GB HBM3")
    assert tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                      device="cuda:0") is None
    # The reference's keys differ in the platform only: one file holds
    # both packages' tunings.
    k_ref = jat.cache_key("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                          interpret=True)
    assert k_ref.rsplit("|", 1)[0] == k_cpu.rsplit("|", 1)[0]
    assert k_ref != k_cpu


def test_one_cache_file_holds_both_packages(cache):
    jat.record("delta_gru_seq", (8, 12, 16), "float32", 0.2,
               {"block_b": 2}, tuned_us=1.0, default_us=2.0, interpret=True)
    tat.record("delta_gru_seq", (8, 12, 16), "float32", 0.2,
               {"block_b": 4}, tuned_us=1.0, default_us=2.0, device="cpu")
    jat.clear_memo()
    assert jat.lookup("delta_gru_seq", (8, 12, 16), "float32", 0.2,
                      interpret=True) == {"block_b": 2}
    assert tat.lookup("delta_gru_seq", (8, 12, 16), "float32", 0.2,
                      device="cpu") == {"block_b": 4}
    assert len(json.loads(cache.read_text())["entries"]) == 2


def test_resolve_sanitizes_illegal_knobs(cache):
    tat.record("delta_gru_seq", (8, 64, 64), "float32", 0.2,
               {"block_b": 4, "block_t": 8}, tuned_us=1.0, default_us=2.0)
    assert tat.resolve("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                       B=8, T=30) == {"block_b": 4}
    assert tat.resolve("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                       B=6, T=32) == {"block_t": 8}
    tat.record("batched_iir_fex", (8, 10, 128), "float32", 0.0,
               {"block_b": 1, "unroll": 4}, tuned_us=1.0, default_us=2.0)
    assert tat.resolve("batched_iir_fex", (8, 10, 128), "float32", 0.0,
                       B=8, frame_shift=128) == {"unroll": 4}
    tat.record("batched_iir_fex_int", (8, 10, 128), "int16", 0.0,
               {"block_b": 1, "unroll": 3}, tuned_us=1.0, default_us=2.0)
    assert tat.resolve("batched_iir_fex_int", (8, 10, 128), "int16", 0.0,
                       B=8, frame_shift=128) == {"block_b": 1}
    # The same answers as the reference's resolve on the same entries.
    for kernel, shape, dtype, th, kw in (
            ("delta_gru_seq", (8, 64, 64), "float32", 0.2,
             dict(B=8, T=30)),
            ("batched_iir_fex", (8, 10, 128), "float32", 0.0,
             dict(B=8, frame_shift=128)),
            ("batched_iir_fex_int", (8, 10, 128), "int16", 0.0,
             dict(B=8, frame_shift=128))):
        cfg = tat.lookup(kernel, shape, dtype, th)
        jat.record(kernel, shape, dtype, th, cfg, tuned_us=1.0,
                   default_us=2.0)
        assert tat.resolve(kernel, shape, dtype, th, **kw) == jat.resolve(
            kernel, shape, dtype, th, **kw)


def test_env_disable_ignores_entries(cache, monkeypatch):
    tat.record("delta_gru_seq", (8, 64, 64), "float32", 0.2,
               {"block_t": 2}, tuned_us=1.0, default_us=2.0)
    monkeypatch.setenv(tat.ENV_ENABLE, "0")
    assert not tat.autotune_enabled()
    assert tat.resolve("delta_gru_seq", (8, 64, 64), "float32", 0.2,
                       B=8, T=100) == {}


@pytest.mark.parametrize("threshold", [0.27, 5.0, -1.0, 0.04, 0.05, 1.0])
def test_threshold_bucket_matches_reference(threshold):
    assert tat.threshold_bucket(threshold) == jat.threshold_bucket(threshold)
    # A float32 tensor buckets as the reference buckets a float32 value.
    assert tat.threshold_bucket(torch.tensor(threshold)) == \
        jat.threshold_bucket(jnp.float32(threshold))


@pytest.mark.parametrize("bad", [object(), "abc", None, torch.zeros(2)])
def test_threshold_that_float_cannot_read_is_bucket_zero(bad):
    assert tat.threshold_bucket(bad) == 0.0


_RACER = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch.kernels import autotune
tag = int(sys.argv[1])
for i in range(30):
    autotune.record("delta_gru_seq", (8, 64, 64), "float32", 0.1 * tag,
                    {{"block_b": 8, "block_t": 16}},
                    tuned_us=10.0 + i, default_us=20.0, device="cpu")
print("done", tag)
"""


def test_concurrent_writers_never_corrupt_cache(cache, tmp_path):
    """Two processes hammering ``record`` against one cache file: the
    worst case is a lost update, never a torn file."""
    src = str(pathlib.Path(__file__).resolve().parent.parent / "src")
    script = tmp_path / "racer.py"
    script.write_text(_RACER.format(src=src))
    env = dict(os.environ, REPRO_AUTOTUNE_CACHE=str(cache))
    procs = [subprocess.Popen([sys.executable, str(script), str(tag)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for tag in (1, 2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
        assert b"done" in out
    blob = json.loads(cache.read_text())
    assert blob["schema"] == tat.SCHEMA_VERSION
    assert isinstance(blob["entries"], dict) and blob["entries"]
    assert not list(cache.parent.glob("*.tmp"))
    tat.clear_memo()
    hits = [tat.lookup("delta_gru_seq", (8, 64, 64), "float32", 0.1 * tag,
                       device="cpu") for tag in (1, 2)]
    assert any(h == {"block_b": 8, "block_t": 16} for h in hits)


# ------------------------------------------- validation, word for word
@pytest.mark.parametrize("B,block_b", [(8, 3), (8, 0), (8, -2), (8, 16),
                                       (6, 4), (8, True), (8, 2.0)])
def test_block_b_messages_equal_reference(B, block_b):
    with pytest.raises(ValueError) as want:
        jat.validate_block_b("delta_gru_seq", B, block_b)
    with pytest.raises(ValueError) as got:
        tat.validate_block_b("delta_gru_seq", B, block_b)
    assert str(got.value) == str(want.value)
    assert tat.validate_block_b("k", 8, None) == 8
    assert tat.validate_block_b("k", 8, 4) == 4


@pytest.mark.parametrize("name,value,axis,n", [
    ("unroll", 7, "frame_shift", 128), ("block_t", 0, "T", 100),
    ("block_t", 3, "T", 32), ("unroll", False, "frame_shift", 128)])
def test_divisor_messages_equal_reference(name, value, axis, n):
    with pytest.raises(ValueError) as want:
        jat.validate_divisor("batched_iir_fex", name, value, axis, n)
    with pytest.raises(ValueError) as got:
        tat.validate_divisor("batched_iir_fex", name, value, axis, n)
    assert str(got.value) == str(want.value)
    assert tat.validate_divisor("k", "block_t", None, "T", 100) == 1
    assert tat.validate_divisor("k", "block_t", 25, "T", 100) == 25


# -------------------------------------------------------------- inputs
def _gru_case(seed=0, I=12, H=16, T=20, B=8):
    rng = np.random.default_rng(seed)
    w = ((rng.standard_normal((I, 3 * H)) / np.sqrt(I)).astype(np.float32),
         (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
         (0.1 * rng.standard_normal(3 * H)).astype(np.float32))
    xs = np.cumsum(0.3 * rng.standard_normal((T, B, I)), 0).astype(
        np.float32)
    return w, xs


def _flat(out):
    res = []
    for o in out:
        if isinstance(o, (tuple, list)):
            res.extend(o)
        elif hasattr(o, "_fields"):
            res.extend(o)
        else:
            res.append(o)
    return res


def _bit_equal(a_out, b_out):
    for a, b in zip(_flat(a_out), _flat(b_out), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.is_floating_point:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)


def _audio(B, n, seed):
    return (np.random.default_rng(seed).standard_normal((B, n)) * 0.1
            ).astype(np.float32)


# --------------------------------------- every legal knob, bit for bit
@pytest.fixture(scope="module")
def float_case():
    w, xs = _gru_case(0, T=10, B=4)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    x = torch.from_numpy(xs)
    base = tdg.delta_gru_scan(p, x, TH, backend="pallas",
                              consult_cache=False)
    j_hs, _, _ = jdg.delta_gru_scan(
        jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w)), jnp.asarray(xs),
        TH, backend="xla")
    return p, x, base, np.asarray(j_hs)


@pytest.mark.parametrize("block_b", [None, 1, 2, 4])
def test_float_gru_knobs_bit_identical(block_b, float_case):
    """Every block_b × block_t on the port's dispatch equals its default
    launch bit for bit, and the JAX scan within 1e-5."""
    p, x, base, j_hs = float_case
    for block_t in (None, 1, 2, 5, 10):
        got = tdg.delta_gru_scan(p, x, TH, backend="pallas",
                                 block_b=block_b, block_t=block_t)
        _bit_equal(base, got)
        np.testing.assert_allclose(got[0].numpy(), j_hs, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def int_case():
    w, xs = _gru_case(2, T=10, B=4)
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    jw, fmt = jfp.quantize_gru(jp)
    xc = np.asarray(jfp.to_code(jnp.asarray(xs), fmt.feat_frac, 16,
                                jnp.int16))
    golden = jfp.int_gru_scan(jw, fmt, jnp.asarray(xc), TH, backend="xla")
    tw = tfp.IntGruWeights(*(torch.from_numpy(np.asarray(a)) for a in jw))
    return tw, fmt, torch.from_numpy(xc), golden


@pytest.mark.parametrize("block_b", [None, 1, 2, 4])
def test_int_gru_knobs_bit_identical(block_b, int_case):
    tw, fmt, xc, golden = int_case
    tfmt = tfp.GruFormats(**{f: getattr(fmt, f)
                             for f in tfp.GruFormats.__dataclass_fields__})
    for block_t in (None, 1, 2, 5, 10):
        hs, st, nzx, nzh = tfp.int_gru_scan(tw, tfmt, xc, TH,
                                            backend="pallas",
                                            block_b=block_b,
                                            block_t=block_t)
        np.testing.assert_array_equal(hs.numpy(), np.asarray(golden[0]))
        for a, b in zip(st, golden[1]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(nzx.numpy(), np.asarray(golden[2]))
        np.testing.assert_array_equal(nzh.numpy(), np.asarray(golden[3]))


@pytest.fixture(scope="module")
def fex_case():
    """Audio, the packed bank, and its integer codes and formats as the
    reference derives them (``quantize_fex`` of the bank's formats)."""
    cfg = jfx.FExConfig()
    bank = jfx.build_sos_bank(cfg)
    coef = np.asarray(jiir.pack_coefficients(bank))
    b_fmt, a_fmt = jfx.sos_formats(bank, cfg.b_bits, cfg.a_bits)
    jcodes, jfmt = jfp.quantize_fex(coef, cfg.env_alpha, b_fmt.frac_bits,
                                    a_fmt.frac_bits, log_eps=cfg.log_eps)
    audio = _audio(4, 2 * SHIFT + 37, 4)
    acodes = np.asarray(jfp.to_code(jnp.asarray(audio), jfmt.feat_frac, 16,
                                    jnp.int16))
    return coef, audio, np.asarray(jcodes), jfmt, acodes


@pytest.mark.parametrize("block_b", [None, 1, 2, 4])
def test_float_fex_knobs_bit_identical(block_b, fex_case):
    """Every block_b × a spread of legal unrolls (up to frame_shift) equals
    the JAX package's scan bit for bit."""
    coef, audio = fex_case[:2]
    jf, js = jfx.fex_scan(jnp.asarray(audio), jnp.asarray(coef),
                          backend="xla")
    for unroll in (None, 1, 16, 128):
        tf, ts = tfx.fex_scan(torch.from_numpy(audio),
                              torch.from_numpy(coef), backend="pallas",
                              block_b=block_b, unroll=unroll)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("block_b", [None, 1, 2, 4])
def test_int_fex_knobs_bit_identical(block_b, fex_case):
    """The integer FEx on codes: every block_b × unroll equals the JAX
    package's golden integer scan, codes and registers."""
    _, _, jcodes, jfmt, acodes = fex_case
    tfmt = tfp.FexFormats(**{f: getattr(jfmt, f)
                             for f in tfp.FexFormats.__dataclass_fields__})
    jf, js = jfp.int_fex_scan(jnp.asarray(acodes), jnp.asarray(jcodes),
                              jfp.init_int_fex_state(4, 10), jfmt,
                              backend="xla")
    for unroll in (None, 2, 8, 64):
        tf, ts = tfp.int_fex_scan(torch.from_numpy(acodes),
                                  torch.from_numpy(jcodes),
                                  tfp.init_int_fex_state(4, 10), tfmt,
                                  backend="pallas", block_b=block_b,
                                  unroll=unroll)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_wrappers_take_knobs_and_masked_takes_none():
    """The four wrappers' plain versions honour block_b (slices
    stitched), validate the rest; the masked instantiation takes none."""
    w, xs = _gru_case(3, T=6, B=4)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    st = tdg.init_delta_state(4, 12, 16, p)
    x = torch.from_numpy(xs)
    base = tdgs.delta_gru_seq(x, *st, p.w_x, p.w_h, TH)
    _bit_equal(base, tdgs.delta_gru_seq(x, *st, p.w_x, p.w_h, TH, block_b=1,
                                        block_t=3))
    _bit_equal(base, tdgs.delta_gru_seq_ref(x, *st, p.w_x, p.w_h, TH,
                                            block_b=2))
    awake = torch.ones((6, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="masked instantiation"):
        tdgs.delta_gru_seq(x, *st, p.w_x, p.w_h, TH, awake, block_b=2)
    with pytest.raises(ValueError, match="delta_gru_seq: block_t=4 is not"):
        tdgs.delta_gru_seq_ref(x, *st, p.w_x, p.w_h, TH, block_t=4)
    coef = torch.rand(6, 3) * 0.1
    a = torch.from_numpy(_audio(4, 256, 5))
    s0 = tiir.init_fex_kernel_state(4, 3)
    _bit_equal(tiir.batched_iir_fex(a, coef, s0),
               tiir.batched_iir_fex(a, coef, s0, block_b=1, unroll=8))
    with pytest.raises(ValueError, match="batched_iir_fex: unroll=3 is not"):
        tiir.batched_iir_fex(a, coef, s0, unroll=3)


# ------------------------------- the reference's knobbed calls, ported
def test_reference_knobbed_calls_run_in_port(cache):
    """The calls of the reference's own tests (``tests/test_autotune.py``)
    with the knobs passed, and with them recorded and picked up by the
    dispatch: no TypeError, and the default's outputs bit for bit."""
    w, xs = _gru_case(0, I=12, H=16, T=20, B=8)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    x = torch.from_numpy(xs)
    base = tdg.delta_gru_scan(p, x, 0.2, backend="pallas")
    _bit_equal(base, tdg.delta_gru_scan(p, x, 0.2, backend="pallas",
                                        block_b=2, block_t=5))
    tat.record("delta_gru_seq", (8, 12, 16), "float32", 0.2,
               {"block_b": 2, "block_t": 5}, tuned_us=1.0, default_us=2.0)
    _bit_equal(base, tdg.delta_gru_scan(p, x, 0.2, backend="pallas"))

    w, fmt = tfp.quantize_gru(p)
    xc = tfp.to_code(x, fmt.feat_frac, 16, torch.int16)
    golden = tfp.int_gru_scan(w, fmt, xc, 0.2, backend="xla")
    _bit_equal(golden, tfp.int_gru_scan(w, fmt, xc, 0.2, backend="pallas",
                                        block_b=4, block_t=4))
    tat.record("delta_gru_seq_int", (8, 12, 16), "int8", 0.2,
               {"block_b": 4, "block_t": 4}, tuned_us=1.0, default_us=2.0)
    _bit_equal(golden, tfp.int_gru_scan(w, fmt, xc, 0.2, backend="pallas"))

    coef = tiir.pack_coefficients(tfx.build_sos_bank(tfx.FExConfig()))
    audio = torch.from_numpy(_audio(8, 2 * SHIFT, 4))
    for backend, kernel, dtype, cfg in (
            ("pallas", "batched_iir_fex", "float32",
             {"block_b": 4, "unroll": 8}),
            ("pallas-int", "batched_iir_fex_int", "int16",
             {"block_b": 2, "unroll": 16})):
        base_f, base_s = tfx.fex_scan(audio, coef, backend=backend)
        _bit_equal((base_f, base_s),
                   tfx.fex_scan(audio, coef, backend=backend, **cfg))
        tat.record(kernel, (8, 10, 128), dtype, 0.0, cfg, tuned_us=1.0,
                   default_us=2.0)
        _bit_equal((base_f, base_s), tfx.fex_scan(audio, coef,
                                                  backend=backend))


@pytest.mark.parametrize("call,text", [
    (lambda a: tdg.delta_gru_scan(a["p"], a["x"], 0.2, backend="pallas",
                                  block_b=3), "delta_gru_seq: block_b=3"),
    (lambda a: tdg.delta_gru_scan(a["p"], a["x"], 0.2, backend="pallas",
                                  block_t=3), "delta_gru_seq: block_t=3"),
    (lambda a: tfp.int_gru_scan(a["w"], a["fmt"], a["xc"], 0.2,
                                backend="pallas", block_b=5),
     "delta_gru_seq_int: block_b=5"),
    (lambda a: tfx.fex_scan(a["audio"], a["coef"], backend="pallas",
                            unroll=5), "batched_iir_fex: unroll=5"),
    (lambda a: tfx.fex_scan(a["audio"], a["coef"], backend="pallas-int",
                            block_b=3), "batched_iir_fex_int: block_b=3"),
])
def test_illegal_knobs_raise_the_reference_message(call, text):
    w, xs = _gru_case(1, I=12, H=16, T=20, B=8)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    x = torch.from_numpy(xs)
    wq, fmt = tfp.quantize_gru(p)
    args = {"p": p, "x": x, "w": wq, "fmt": fmt,
            "xc": tfp.to_code(x, fmt.feat_frac, 16, torch.int16),
            "audio": torch.zeros((8, 256)),
            "coef": tiir.pack_coefficients(tfx.build_sos_bank(
                tfx.FExConfig()))}
    with pytest.raises(ValueError, match=text + " is not a positive divisor"):
        call(args)


def test_illegal_wrapper_messages_equal_the_reference_kernels():
    """The reference's Pallas wrappers refuse before they trace; the port's
    wrappers give the same message."""
    w, xs = _gru_case(1, I=12, H=16, T=20, B=8)
    jp = jdg.DeltaGRUParams(*(jnp.asarray(a) for a in w))
    jst = jdg.init_delta_state(8, 12, 16, jp)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    st = tdg.init_delta_state(8, 12, 16, p)
    x = torch.from_numpy(xs)
    for kw in ({"block_b": 3}, {"block_t": 7}):
        with pytest.raises(ValueError) as want:
            jdgs.delta_gru_seq(jnp.asarray(xs), *jst, jp.w_x, jp.w_h, 0.2,
                               interpret=True, **kw)
        with pytest.raises(ValueError) as got:
            tdgs.delta_gru_seq(x, *st, p.w_x, p.w_h, 0.2, **kw)
        assert str(got.value) == str(want.value)
    audio = np.zeros((8, 256), np.float32)
    coef = np.asarray(jiir.pack_coefficients(jfx.build_sos_bank(
        jfx.FExConfig())))
    for kw in ({"block_b": 3}, {"unroll": 3}):
        with pytest.raises(ValueError) as want:
            jiir.batched_iir_fex(jnp.asarray(audio), jnp.asarray(coef),
                                 jiir.init_fex_kernel_state(8, 10),
                                 interpret=True, **kw)
        with pytest.raises(ValueError) as got:
            tiir.batched_iir_fex(torch.from_numpy(audio),
                                 torch.from_numpy(coef),
                                 tiir.init_fex_kernel_state(8, 10), **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------- dispatch pickup
def test_dispatch_passes_the_tuned_knobs(cache, monkeypatch):
    """A recorded config reaches the wrapper; ``consult_cache=False``
    leaves the default launch and reads no file."""
    seen = []
    real = tdg.delta_gru_seq

    def spy(*a, **kw):
        seen.append({k: kw.get(k) for k in ("block_b", "block_t")})
        return real(*a, **kw)

    monkeypatch.setattr(tdg, "delta_gru_seq", spy)
    w, xs = _gru_case(0, T=8, B=4)
    p = tdg.DeltaGRUParams(*(torch.from_numpy(a) for a in w))
    x = torch.from_numpy(xs)
    tat.record("delta_gru_seq", (4, 12, 16), "float32", 0.2,
               {"block_b": 2, "block_t": 3}, tuned_us=1.0, default_us=2.0,
               device="cpu")
    tdg.delta_gru_scan(p, x, 0.2, backend="pallas")
    tdg.delta_gru_scan(p, x, 0.2, backend="pallas", block_t=4)
    loads = []
    monkeypatch.setattr(tat, "_load_entries",
                        lambda: loads.append(1) or {})
    tdg.delta_gru_scan(p, x, 0.2, backend="pallas", consult_cache=False)
    # block_t 3 does not divide T = 8: dropped; an explicit knob wins.
    assert seen == [{"block_b": 2, "block_t": None},
                    {"block_b": 2, "block_t": 4},
                    {"block_b": None, "block_t": None}]
    assert loads == []


def test_cpu_tune_writes_a_winner_the_dispatch_picks_up(cache, monkeypatch):
    rep = tat.tune_delta_gru_seq(T=4, B=2, I=3, H=4, threshold=0.2,
                                 iters=1, device="cpu")
    assert rep["cache_key"] in json.loads(cache.read_text())["entries"]
    assert rep["platform"] == "cpu-eager"
    assert rep["best_us"] <= rep["default_us"]
    assert rep["default_config"] == {"block_b": 2, "block_t": 1}
    assert len(rep["sweep"]) >= 3
    winner = {k: v for k, v in rep["best_config"].items() if v is not None}
    assert tat.resolve("delta_gru_seq", (2, 3, 4), "float32", 0.2, B=2,
                       T=4, device="cpu") == winner
    seen = []
    real = tdg.delta_gru_seq
    monkeypatch.setattr(tdg, "delta_gru_seq", lambda *a, **kw: (
        seen.append({k: kw[k] for k in ("block_b", "block_t")}),
        real(*a, **kw))[1])
    p = tdg.init_delta_gru(torch.Generator().manual_seed(0), 3, 4)
    tdg.delta_gru_scan(p, torch.zeros((4, 2, 3)), 0.2, backend="pallas")
    assert {k: v for k, v in seen[0].items() if v is not None} == winner
    rep = tat.tune_batched_iir_fex(B=2, seconds=0.032, iters=1,
                                   variant="int", device="cpu")
    assert rep["cache_key"] in json.loads(cache.read_text())["entries"]
    assert rep["default_config"] == {"block_b": 2, "unroll": None}
    assert {e["unroll"] for e in rep["sweep"]} >= {None, 1, 2, 4, 8, 16}


def test_float_fex_sweep_never_times_block_b_one(cache):
    rep = tat.tune_batched_iir_fex(B=2, seconds=0.016, iters=1,
                                   device="cpu", write=False)
    assert all(e["block_b"] != 1 for e in rep["sweep"])
    assert "cache_key" not in rep and not cache.exists()


# -------------------------------------------------------------- session
def _jax_params():
    params, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=10)
    return params, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_session_tuning_report_matches_jax(numerics, cache):
    """The same recorded tunings (under each package's platform) give the
    same report: kernels, shapes and configs (int8: the ΔGRU; the
    reference's int8 session reports its float FEx's key, the port the
    integer kernel it launches)."""
    from repro.frontend.fex import FExConfig as JFExConfig
    jparams, np_params = _jax_params()
    gru = "delta_gru_seq_int" if numerics == "int8" else "delta_gru_seq"
    gdt = "int8" if numerics == "int8" else "float32"
    H = J_SMOKE.d_model
    for rec, kw in ((jat.record, {"interpret": None}),
                    (tat.record, {"device": "cpu"})):
        rec(gru, (2, 10, H), gdt, 0.2, {"block_t": 2}, tuned_us=1.0,
            default_us=2.0, **kw)
    jat.clear_memo()
    js = jstream.StreamingKwsSession(jparams, J_SMOKE, threshold=0.2,
                                     batch=2, input_dim=10, fex=JFExConfig(),
                                     numerics=numerics)
    ts = tstream.StreamingKwsSession(tkws.params_from_numpy(np_params),
                                     T_SMOKE, threshold=0.2, batch=2,
                                     input_dim=10, fex=tfx.FExConfig(),
                                     device="cpu", numerics=numerics)
    jr, tr = js.kernel_tuning_report(), ts.kernel_tuning_report()
    assert set(tr) == set(jr) == {"platform", "cache", "enabled", "kernels"}
    assert tr["cache"] == jr["cache"] == str(cache)
    assert tr["enabled"] and tr["platform"] == "cpu-eager"
    assert tr["kernels"][gru] == jr["kernels"][gru] == {
        "shape": [2, 10, H], "config": {"block_t": 2}}
    if numerics == "float32":
        assert tr["kernels"] == jr["kernels"]
        assert tr["kernels"]["batched_iir_fex"]["config"] == {}   # cold
    else:
        assert tr["kernels"]["batched_iir_fex_int"] == {
            "shape": [2, 10, 128], "config": {}}


def test_session_reads_the_cache_once_and_serves_bit_identically(
        cache, monkeypatch):
    """A tuned session looks its configurations up when it is built, its
    steps read no file, its kernels get the knobs, and it serves the
    untuned session's outputs bit for bit."""
    _, np_params = _jax_params()
    for k, shape, dtype, th, cfg in (
            ("delta_gru_seq", (4, 10, 16), "float32", 0.1,
             {"block_b": 1, "block_t": 2}),
            ("batched_iir_fex", (4, 10, 128), "float32", 0.0,
             {"block_b": 2, "unroll": 4})):
        tat.record(k, shape, dtype, th, cfg, tuned_us=1.0, default_us=2.0,
                   device="cpu")
    loads = []
    real_load = tat._load_entries
    monkeypatch.setattr(tat, "_load_entries",
                        lambda: loads.append(1) or real_load())
    make = lambda: tstream.StreamingKwsSession(  # noqa: E731
        tkws.params_from_numpy(np_params), T_SMOKE, threshold=0.1, batch=4,
        input_dim=10, fex=tfx.FExConfig(), device="cpu")
    tuned = make()
    built = len(loads)
    assert 1 <= built <= 2
    seen = []
    real_fex, real_gru = tfx.batched_iir_fex, tdg.delta_gru_seq
    monkeypatch.setattr(tfx, "batched_iir_fex", lambda *a, **kw: (
        seen.append(("fex", kw["block_b"], kw["unroll"])),
        real_fex(*a, **kw))[1])
    monkeypatch.setattr(tdg, "delta_gru_seq", lambda *a, **kw: (
        seen.append(("gru", kw["block_b"], kw["block_t"])),
        real_gru(*a, **kw))[1])
    audio = _audio(4, 3 * 256 + 64, 9)
    outs = [tuned.process_audio(audio[:, i:i + 256])
            for i in range(0, 3 * 256, 256)]
    outs.append(tuned.process_audio(audio[:, 768:]))      # 0 frames
    assert len(loads) == built                  # no file access per step
    assert seen == [("fex", 2, 4), ("gru", 1, 2)] * 3
    monkeypatch.setenv(tat.ENV_ENABLE, "0")
    plain = make()
    for got, (i, want) in zip(outs, enumerate(
            plain.process_audio(audio[:, i:i + 256])
            for i in range(0, 3 * 256, 256))):
        _bit_equal((got.logits, got.votes, got.nz),
                   (want.logits, want.votes, want.nz))
    assert seen[6:] == [("fex", None, None), ("gru", None, None)] * 3
    assert tuned.kernel_tuning_report()["kernels"]["delta_gru_seq"][
        "config"] == {"block_b": 1, "block_t": 2}
    assert plain.kernel_tuning_report()["kernels"]["delta_gru_seq"][
        "config"] == {}
