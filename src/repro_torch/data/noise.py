"""Noise beds + far-field reverb for real-world scenario synthesis.

A numpy copy of ``repro/data/noise.py``: the same
``np.random.Generator`` state gives the same arrays, bit for bit, in both
packages.  It supplies the acoustic conditions the continuous streams of
``data.continuous`` are mixed under:

  * ``noise_bed(rng, n, kind)`` — a unit-RMS noise track of ``kind``
    "white" (flat spectrum), "pink" (1/f power via FFT shaping — the
    spectral tilt of fans/HVAC/wind) or "babble" (a sum of overlapping
    formant-synthesized utterances drawn from the SynthCommands class
    specs — the hardest condition, because its time-frequency structure
    mimics the keywords themselves).
  * ``image_rir(...)`` — a far-field room impulse response from the
    image-source method on a shoebox room: each reflection of order
    ≤ ``max_order`` contributes a delayed, distance-attenuated,
    wall-absorbed tap.  Deterministic in its geometry (no rng), so a
    scenario cell's room is reproducible from its parameters alone.
  * ``apply_reverb(x, rir)`` — FFT convolution of a stream with an RIR
    (same length as ``x``; the reverb tail is truncated, not wrapped).

All beds are normalized to EXACTLY unit RMS before the caller scales
them, so ``data.continuous.make_stream`` can hit a requested SNR to
within measurement error instead of trusting the generator's nominal
variance (the SNR-accuracy invariant tests assert ±0.5 dB).
"""
from __future__ import annotations

import dataclasses

import numpy as np

NOISE_KINDS = ("white", "pink", "babble")

_SPEED_OF_SOUND = 343.0          # m/s


def _unit_rms(x: np.ndarray) -> np.ndarray:
    rms = float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    return (x / (rms + 1e-12)).astype(np.float32)


def white(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n,) float32 white noise, unit RMS."""
    return _unit_rms(rng.standard_normal(n))


def pink(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n,) float32 pink (1/f-power) noise, unit RMS.

    FFT shaping: white spectrum scaled by 1/sqrt(f) (power ∝ 1/f), DC
    bin zeroed.  The invariant test checks the realized octave-band
    slope, not just the recipe.
    """
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n)
    scale = np.zeros_like(f)
    scale[1:] = 1.0 / np.sqrt(f[1:])
    return _unit_rms(np.fft.irfft(spec * scale, n))


def babble(rng: np.random.Generator, n: int, n_talkers: int = 6,
           fs: int = 8000) -> np.ndarray:
    """(n,) float32 babble: ``n_talkers`` independent voices speaking
    over each other, unit RMS.

    Each voice is a back-to-back stream of formant-synthesized
    utterances drawn from the SynthCommands class specs with fresh
    jitter, so the bed shares the keywords' time-frequency structure —
    the condition that stresses the detector's false-alarm behaviour
    most (a white bed barely excites the formant-tracking FEx channels).
    """
    if n_talkers < 1:
        raise ValueError(f"n_talkers must be >= 1, got {n_talkers}")
    from repro_torch.data.continuous import _synth_utterance
    from repro_torch.data.gscd import _SPECS

    specs = list(_SPECS.values())
    bed = np.zeros(n, np.float64)
    for _ in range(n_talkers):
        pos = int(rng.uniform(0.0, 0.3) * fs)
        while pos < n:
            utt = _synth_utterance(rng, specs[rng.integers(len(specs))],
                                   float(rng.uniform(0.25, 0.5)))
            end = min(pos + len(utt), n)
            bed[pos:end] += utt[:end - pos]
            pos = end + int(rng.uniform(0.02, 0.25) * fs)
    return _unit_rms(bed)


def noise_bed(rng: np.random.Generator, n: int, kind: str = "white"
              ) -> np.ndarray:
    """Dispatch on ``kind`` ∈ NOISE_KINDS → (n,) float32, unit RMS."""
    if n < 1:
        raise ValueError(f"noise bed length must be >= 1, got {n}")
    if kind == "white":
        return white(rng, n)
    if kind == "pink":
        return pink(rng, n)
    if kind == "babble":
        return babble(rng, n)
    raise ValueError(f"unknown noise kind {kind!r} "
                     f"(choose one of {list(NOISE_KINDS)})")


# ------------------------------------------------------------------ reverb --

@dataclasses.dataclass(frozen=True)
class ReverbSpec:
    """A far-field room for the image-source method (all meters).

    room: (Lx, Ly, Lz) shoebox dimensions.
    source / mic: positions inside the room.
    absorption: wall energy absorption coefficient in (0, 1] — each
      reflection multiplies the tap amplitude by sqrt(1 − absorption).
    max_order: highest image order (0 = direct path only).
    """

    room: tuple[float, float, float] = (5.0, 4.0, 3.0)
    source: tuple[float, float, float] = (3.5, 2.8, 1.6)
    mic: tuple[float, float, float] = (1.2, 1.5, 1.1)
    absorption: float = 0.35
    max_order: int = 6


def image_rir(spec: ReverbSpec = ReverbSpec(), fs: int = 8000
              ) -> np.ndarray:
    """Room impulse response of ``spec`` by the image-source method.

    For every image index (nx, ny, nz) with |n|∞ ≤ max_order and every
    reflection parity, the mirrored source position contributes one tap
    at delay = distance / c with amplitude r^(bounces) / distance, where
    r = sqrt(1 − absorption).  Taps land on the nearest sample (no
    fractional-delay filtering — a deliberate simplification; what the
    scenario matrix needs is a realistic smearing of keyword energy, not
    an auralization-grade room).  Normalized so the DIRECT-path tap has
    unit amplitude; the convolution therefore preserves the dry signal's
    scale and the reverb tail adds on top (far-field attenuation is the
    SNR knob's job, not the RIR's).
    """
    if not 0.0 < spec.absorption <= 1.0:
        raise ValueError(f"absorption must be in (0, 1], "
                         f"got {spec.absorption}")
    if spec.max_order < 0:
        raise ValueError(f"max_order must be >= 0, got {spec.max_order}")
    room = np.asarray(spec.room, np.float64)
    src = np.asarray(spec.source, np.float64)
    mic = np.asarray(spec.mic, np.float64)
    if np.any(room <= 0.0):
        raise ValueError(f"room dimensions must be positive, got {spec.room}")
    for name, p in (("source", src), ("mic", mic)):
        if np.any(p < 0.0) or np.any(p > room):
            raise ValueError(f"{name} position {tuple(p)} is outside the "
                             f"room {spec.room}")
    r = float(np.sqrt(1.0 - spec.absorption))
    orders = np.arange(-spec.max_order, spec.max_order + 1)
    taps: list[tuple[float, float]] = []          # (delay_s, amplitude)
    # Allen–Berkley images: along each axis the source's mirror set is
    # x = 2 n L ± x_s, reached through |2n − p| wall reflections.
    for nx in orders:
        for ny in orders:
            for nz in orders:
                for px in (0, 1):
                    for py in (0, 1):
                        for pz in (0, 1):
                            img = np.array([
                                2 * nx * room[0] + (-src[0] if px else src[0]),
                                2 * ny * room[1] + (-src[1] if py else src[1]),
                                2 * nz * room[2] + (-src[2] if pz else src[2]),
                            ])
                            dist = float(np.linalg.norm(img - mic))
                            bounces = (abs(2 * nx - px) + abs(2 * ny - py)
                                       + abs(2 * nz - pz))
                            taps.append((dist / _SPEED_OF_SOUND,
                                         r ** bounces / max(dist, 0.1)))
    n = int(np.ceil(max(t for t, _ in taps) * fs)) + 1
    rir = np.zeros(n, np.float64)
    for delay_s, amp in taps:
        rir[int(round(delay_s * fs))] += amp
    direct = float(np.linalg.norm(src - mic))
    rir *= max(direct, 0.1)                       # unit direct-path tap
    return rir.astype(np.float32)


def apply_reverb(x: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """Convolve stream ``x`` with ``rir`` (FFT overlap, O(n log n)),
    truncated back to ``len(x)`` — events keep their dry sample spans
    and only the tail energy is smeared forward."""
    if len(rir) < 1:
        raise ValueError("rir must hold at least one tap")
    n = len(x) + len(rir) - 1
    nfft = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(rir, nfft), nfft)
    return y[:len(x)].astype(np.float32)
