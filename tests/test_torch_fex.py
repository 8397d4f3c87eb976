"""Port conformance, FEx: repro_torch's feature extractor against the JAX
package's, on the same numpy inputs.

The JAX side runs its plain reference (``backend="xla"``; the repo's own
tests pin its Pallas kernel to it bit for bit).  The port runs its kernel
wrapper on CPU tensors, i.e. the kernel's plain version.  Everything is
compared bit for bit: coefficients, raw envelopes, registers and 12-bit
feature codes.  The port fuses the multiply-adds that XLA on the CPU
fuses, flushes denormals as XLA does and computes XLA's own log2
(``kernels/xla_math.py``); XLA fuses only on a host with FMA, which the
``xla_fma`` fixture checks (the test skips, saying so, elsewhere).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.frontend import fex as jfex
from repro_torch.frontend import fex as tfex
from repro_torch.kernels import iir_fex as tiir
from test_torch_xla_math import xla_fma  # noqa: F401  (a fixture)

SHIFT = 128



def _bits_equal(port, ref):
    np.testing.assert_array_equal(np.asarray(port).view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


def _audio(B, T, seed):
    """Speech-like test audio: two drifting tones + noise, 12-bit grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    f = rng.uniform(300, 2500, (B, 2))
    sig = (0.5 * np.sin(2 * np.pi * f[:, :1] * t)
           + 0.3 * np.sin(2 * np.pi * f[:, 1:] * t * (1 + 0.3 * t))
           + 0.05 * rng.standard_normal((B, T)))
    sig *= np.exp(-((t - 0.05) / 0.04) ** 2)          # an onset and decay
    return np.round(np.clip(sig, -1, 1 - 2 ** -11) * 2048) / 2048


@pytest.fixture(scope="module")
def bank():
    fx = jfex.FeatureExtractor()
    coef = np.asarray(fx.coef)
    return fx.cfg, coef


def test_sos_bank_and_packed_coefficients_equal(bank):
    cfg, coef = bank
    np.testing.assert_array_equal(tfex.build_sos_bank(tfex.FExConfig()),
                                  jfex.build_sos_bank(cfg))
    np.testing.assert_array_equal(tfex.FeatureExtractor().coef.numpy(), coef)
    np.testing.assert_array_equal(
        tiir.pack_coefficients(jfex.build_sos_bank(cfg)).numpy(), coef)


def _both(audio, coef, cfg, compress, state=None):
    kw = dict(frame_shift=SHIFT, env_alpha=cfg.env_alpha,
              log_eps=cfg.log_eps, compress=compress)
    jf, js = jfex.fex_scan(jnp.asarray(audio, jnp.float32),
                           jnp.asarray(coef), None, backend="xla", **kw)
    tf, ts = tfex.fex_scan(torch.from_numpy(audio.astype(np.float32)),
                           torch.tensor(coef), state, backend="pallas",
                           **kw)
    return (np.asarray(jf), np.asarray(jfex._pack_state(js)),
            tf.numpy(), tfex._pack_state(ts).numpy())


def test_raw_envelope_within_fma_drift(bank, xla_fma):
    """Raw envelopes and registers after 1536 samples: bit-equal (the
    port fuses where XLA fuses, so there is no drift left)."""
    cfg, coef = bank
    audio = _audio(2, 12 * SHIFT, seed=0)
    jf, js, tf, ts = _both(audio, coef, cfg, compress=False)
    assert jf.shape == tf.shape == (2, 12, coef.shape[1])
    _bits_equal(tf, jf)
    _bits_equal(ts, js)


def test_feature_codes_zero_mismatches(bank, xla_fma):
    cfg, coef = bank
    audio = _audio(3, 16 * SHIFT + 37, seed=1)
    jf, js, tf, ts = _both(audio, coef, cfg, compress=True)
    mismatched = int(np.count_nonzero(tf != jf))
    assert mismatched == 0, f"{mismatched} of {jf.size} 12-bit codes differ"
    _bits_equal(ts, js)
    codes = tf / 2.0 ** -11
    assert np.array_equal(codes, np.round(codes))   # on the 12-bit grid


def test_registers_decaying_through_denormals_equal_jax(bank, xla_fma):
    """Filter state seeded at ~1e-36 and silent input: the registers decay
    below 2^-126 within a few hundred samples, where XLA flushes them to
    zero.  Registers and raw envelopes stay bit-equal throughout."""
    cfg, coef = bank
    rng = np.random.default_rng(6)
    state = (1e-36 * rng.standard_normal((3, 5, coef.shape[1]))
             ).astype(np.float32)
    state[:, 4] = np.abs(state[:, 4])
    audio = np.zeros((3, 4 * SHIFT), np.float32)
    jstate = jfex._unpack_state(jnp.asarray(state))
    tstate = tfex._unpack_state(torch.from_numpy(state))
    kw = dict(frame_shift=SHIFT, env_alpha=cfg.env_alpha,
              log_eps=cfg.log_eps, compress=False)
    jf, js = jfex.fex_scan(jnp.asarray(audio), jnp.asarray(coef), jstate,
                           backend="xla", **kw)
    tf, ts = tfex.fex_scan(torch.from_numpy(audio), torch.tensor(coef),
                           tstate, backend="pallas", **kw)
    js, ts = np.asarray(jfex._pack_state(js)), tfex._pack_state(ts).numpy()
    _bits_equal(tf.numpy(), jf)
    _bits_equal(ts, js)
    assert np.count_nonzero(js == 0) > js.size // 2    # flushed, not tiny


@pytest.mark.parametrize("cuts", [(SHIFT, 5 * SHIFT), (3 * SHIFT, 4 * SHIFT)])
def test_chunks_with_carried_state_equal_one_call(bank, cuts):
    """[a|b|c] with the state carried == one call (frame-aligned splits:
    fex_scan consumes whole frames; the session carries the remainder,
    see test_torch_serving)."""
    cfg, coef = bank
    audio = torch.from_numpy(_audio(2, 8 * SHIFT, seed=2).astype(np.float32))
    kw = dict(frame_shift=SHIFT, env_alpha=cfg.env_alpha,
              log_eps=cfg.log_eps, backend="pallas")
    c = torch.tensor(coef)
    once, s_once = tfex.fex_scan(audio, c, **kw)
    feats, state, lo = [], None, 0
    for hi in (*cuts, audio.shape[1]):
        f, state = tfex.fex_scan(audio[:, lo:hi], c, state, **kw)
        feats.append(f)
        lo = hi
    torch.testing.assert_close(torch.cat(feats, 1), once, rtol=0, atol=0)
    torch.testing.assert_close(tfex._pack_state(state),
                               tfex._pack_state(s_once), rtol=0, atol=0)


def test_feature_extractor_matches_jax(bank):
    """The callable FEx (12-bit ADC quantization + bank + compression) on
    raw, un-quantized audio: the same codes as the JAX extractor."""
    rng = np.random.default_rng(3)
    audio = (0.4 * rng.standard_normal((2, 10 * SHIFT))).astype(np.float32)
    jf = np.asarray(jfex.FeatureExtractor()(jnp.asarray(audio),
                                            backend="xla"))
    tf = tfex.FeatureExtractor()(torch.from_numpy(audio)).numpy()
    assert int(np.count_nonzero(tf != jf)) == 0


def test_short_chunk_consumes_no_frame():
    c = tfex.FeatureExtractor().coef
    st = tfex.init_fex_state(2, c.shape[1])
    f, s = tfex.fex_scan(torch.zeros(2, SHIFT - 1), c, st, backend="pallas")
    assert f.shape == (2, 0, c.shape[1])
    torch.testing.assert_close(tfex._pack_state(s), tfex._pack_state(st))


# ------------------------------- the float FEx kernel's launch plan --
@pytest.mark.parametrize("B,C", [(1, 10), (3, 10), (32, 10), (33, 10),
                                 (256, 10), (5, 7), (1, 1)])
def test_fex_launch_plan_covers_every_pair(B, C):
    """One CTA per 32 (stream, channel) pairs: the grid covers every pair
    and no CTA is empty; four warps (feed, section 0, section 1,
    envelope); the audio ring and the y0 / y1 rings fit a thread block's
    227 KB."""
    plan = tiir.fex_launch_plan(B, C)
    lanes = tiir.FEX_LANES
    assert (plan["ctas"] - 1) * lanes < B * C <= plan["ctas"] * lanes
    assert plan["threads"] == 4 * 32 and plan["smem_bytes"] <= 232_448
    # 4 audio slots and 2 slots each for y0 and y1, every slot a tile of
    # 64 samples (+ 4 floats of padding) per lane, float32.
    assert plan["smem_bytes"] == 4 * (4 + 2 + 2) * lanes * 68
    if (B, C) in ((32, 10), (256, 10)):
        assert plan["ctas"] == B * C // 32      # 10 and 80 CTAs


def test_fex_launch_plan_refuses_empty_batches():
    with pytest.raises(ValueError, match="B >= 1"):
        tiir.fex_launch_plan(0, 10)
