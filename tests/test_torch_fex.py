"""Port conformance, FEx: repro_torch's feature extractor against the JAX
package's, on the same numpy inputs.

The JAX side runs its plain reference (``backend="xla"``; the repo's own
tests pin its Pallas kernel to it bit for bit).  The port runs its kernel
wrapper on CPU tensors, i.e. the kernel's plain version.  Tolerances:
coefficients are bit-exact.  Raw envelopes agree to a relative 1e-5, not
bit for bit: XLA on the CPU contracts ``a*b + c`` into one FMA, while the
port (like PyTorch's eager ops and its kernel, built with --fmad=false)
rounds the product first, and the recursion carries the ulp differences
(measured: at most 2.9e-6 relative over 1536 samples).  12-bit feature
codes are compared by counting mismatches (an ulp of FMA drift or of log2
can flip a code at a rounding boundary) and must count 0 on these inputs.
"""

ENV_RTOL = 1e-5       # relative; FMA contraction drift, see above
STATE_ATOL = 1e-7     # absolute, on registers of magnitude <= 1e-2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.frontend import fex as jfex
from repro_torch.frontend import fex as tfex
from repro_torch.kernels import iir_fex as tiir

SHIFT = 128


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


def test_raw_envelope_within_fma_drift(bank):
    cfg, coef = bank
    audio = _audio(2, 12 * SHIFT, seed=0)
    jf, js, tf, ts = _both(audio, coef, cfg, compress=False)
    assert jf.shape == tf.shape == (2, 12, coef.shape[1])
    np.testing.assert_allclose(tf, jf, rtol=ENV_RTOL, atol=0)
    np.testing.assert_allclose(ts, js, rtol=ENV_RTOL, atol=STATE_ATOL)


def test_feature_codes_zero_mismatches(bank):
    cfg, coef = bank
    audio = _audio(3, 16 * SHIFT + 37, seed=1)
    jf, js, tf, ts = _both(audio, coef, cfg, compress=True)
    mismatched = int(np.count_nonzero(tf != jf))
    assert mismatched == 0, f"{mismatched} of {jf.size} 12-bit codes differ"
    np.testing.assert_allclose(ts, js, rtol=ENV_RTOL, atol=STATE_ATOL)
    codes = tf / 2.0 ** -11
    assert np.array_equal(codes, np.round(codes))   # on the 12-bit grid


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
