"""IIR band-pass filter design — pure numpy (no scipy at runtime).

A verbatim copy of ``repro/frontend/filters.py``: the port imports
nothing of the JAX package, not even its numpy-only modules.

Designs the paper's 4th-order Butterworth band-pass filters as a cascade of
two second-order sections (SOS), via the classic analog-prototype route:

  1. 2nd-order Butterworth low-pass prototype (poles at −1/√2 ± j/√2),
  2. low-pass → band-pass transform  s → (s² + ω₀²)/(B·s),
  3. bilinear transform with frequency prewarping,
  4. pole pairing into two biquads, each with zeros at z = ±1
     (numerator (1 − z⁻²) — the "hardware-friendly symmetry" the paper
     exploits: b₁ = 0, b₂ = −b₀, so each biquad has ONE distinct b
     multiplier and two a multipliers).

Also provides the Mel-spaced filterbank used by the FEx (16 channels,
100 Hz – 3.95 kHz, Nyquist-limited for 8 kHz audio; the 10-channel
selection covers ≈506 Hz – 3.2 kHz — see frontend/fex.py's faithfulness
notes on the paper's "516 Hz – 4.22 kHz").
"""
from __future__ import annotations

import numpy as np

FS_DEFAULT = 8000.0


def mel(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_inv(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_center_frequencies(n_channels: int = 16, fmin: float = 100.0,
                           fmax: float = 3950.0) -> np.ndarray:
    """Mel-spaced center frequencies (fmax defaults just below Nyquist/2 @8k)."""
    return mel_inv(np.linspace(mel(fmin), mel(fmax), n_channels))


def band_edges_from_centers(centers: np.ndarray) -> np.ndarray:
    """−3 dB band edges halfway (in mel) between adjacent centers."""
    m = mel(centers)
    half = np.diff(m) / 2.0
    lo = m - np.concatenate([[half[0]], half])
    hi = m + np.concatenate([half, [half[-1]]])
    return np.stack([mel_inv(lo), mel_inv(hi)], axis=-1)   # (C, 2)


def design_butter_bandpass_sos(f_lo: float, f_hi: float,
                               fs: float = FS_DEFAULT) -> np.ndarray:
    """4th-order Butterworth BPF → SOS array of shape (2, 6): [b0 b1 b2 1 a1 a2].

    Normalized to unit gain at the (geometric) center frequency.
    """
    assert 0 < f_lo < f_hi < fs / 2, (f_lo, f_hi, fs)
    T = 1.0 / fs
    # Prewarp band edges.
    w1 = 2.0 / T * np.tan(np.pi * f_lo * T)
    w2 = 2.0 / T * np.tan(np.pi * f_hi * T)
    w0 = np.sqrt(w1 * w2)
    bw = w2 - w1

    # 2nd-order Butterworth LP prototype poles.
    lp_poles = np.array([np.exp(1j * 3 * np.pi / 4), np.exp(1j * 5 * np.pi / 4)])

    # LP→BP: each prototype pole p yields two band-pass poles solving
    #   s² − p·bw·s + w0² = 0.
    bp_poles = []
    for p in lp_poles:
        disc = np.sqrt((p * bw) ** 2 / 4.0 - w0 ** 2 + 0j)
        bp_poles.extend([p * bw / 2.0 + disc, p * bw / 2.0 - disc])
    bp_poles = np.array(bp_poles)

    # Bilinear transform of poles; zeros: 2 at s=0 → z=1, 2 at s=∞ → z=−1.
    k = 2.0 / T
    z_poles = (k + bp_poles) / (k - bp_poles)

    # Group into conjugate pairs (pair each pole with its conjugate partner).
    pairs = _conjugate_pairs(z_poles)

    sos = np.zeros((2, 6), dtype=np.float64)
    for i, (p1, p2) in enumerate(pairs):
        a1 = -(p1 + p2).real
        a2 = (p1 * p2).real
        sos[i] = [1.0, 0.0, -1.0, 1.0, a1, a2]

    # Normalize overall gain to 1 at the digital center frequency.
    f0_dig = np.sqrt(f_lo * f_hi)
    g = np.abs(_sos_freq_response(sos, np.array([f0_dig]), fs))[0]
    g_per = (1.0 / g) ** 0.5
    sos[:, :3] *= g_per
    return sos


def _conjugate_pairs(poles: np.ndarray):
    """Pair complex poles with their conjugates."""
    upper = sorted([p for p in poles if p.imag >= 0], key=lambda p: p.real)
    lower = sorted([p for p in poles if p.imag < 0], key=lambda p: p.real)
    if len(upper) == len(lower) == 2:
        return [(upper[0], lower[0]), (upper[1], lower[1])]
    # Degenerate (real poles) fallback: sequential pairing.
    ps = sorted(poles, key=lambda p: (p.real, p.imag))
    return [(ps[0], ps[1]), (ps[2], ps[3])]


def _sos_freq_response(sos: np.ndarray, freqs: np.ndarray, fs: float):
    z = np.exp(-2j * np.pi * freqs / fs)
    h = np.ones_like(z, dtype=np.complex128)
    for b0, b1, b2, _, a1, a2 in sos:
        h *= (b0 + b1 * z + b2 * z * z) / (1.0 + a1 * z + a2 * z * z)
    return h


def sos_freq_response(sos: np.ndarray, freqs: np.ndarray, fs: float = FS_DEFAULT):
    """|H(f)| for an (n_sections, 6) SOS cascade."""
    return np.abs(_sos_freq_response(np.asarray(sos), np.asarray(freqs), fs))


def make_filterbank(n_channels: int = 16, fmin: float = 100.0,
                    fmax: float = 3950.0, fs: float = FS_DEFAULT) -> np.ndarray:
    """Bank of 4th-order BPFs: returns (C, 2, 6) SOS coefficients."""
    centers = mel_center_frequencies(n_channels, fmin, fmax)
    edges = band_edges_from_centers(centers)
    bank = np.stack([
        design_butter_bandpass_sos(max(lo, 20.0), min(hi, fs / 2 - 20.0), fs)
        for lo, hi in edges])
    return bank


def sosfilt_np(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Direct-form-II-transposed SOS filter, pure numpy (test oracle)."""
    y = np.asarray(x, dtype=np.float64).copy()
    for b0, b1, b2, _, a1, a2 in np.asarray(sos, dtype=np.float64):
        out = np.empty_like(y)
        s1 = 0.0
        s2 = 0.0
        for n in range(len(y)):
            xn = y[n]
            yn = b0 * xn + s1
            s1 = b1 * xn - a1 * yn + s2
            s2 = b2 * xn - a2 * yn
            out[n] = yn
        y = out
    return y
