"""SynthCommands: the 12-class formant-synthesized keyword set.

A numpy copy of the ``synth_batch`` part of ``repro/data/gscd.py``: 1 s
utterances at 8 kHz, each class a two-formant trajectory + band noise.
The same ``np.random.Generator`` state gives the same audio in both
packages, which is how the port's serving requests are made.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.kws import CLASSES

FS = 8000
T = 8000     # 1 second


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    f1_start: float
    f1_end: float
    f2_start: float
    f2_end: float
    noise: float
    am_rate: float     # amplitude-modulation rate (syllable rhythm)


# 10 keyword classes + silence + unknown (paper's 12-class GSCD task)
_SPECS = {
    "down": ClassSpec(600, 300, 1800, 900, 0.02, 3.0),
    "go": ClassSpec(400, 600, 1000, 1400, 0.02, 2.0),
    "left": ClassSpec(500, 450, 1700, 2100, 0.03, 4.0),
    "no": ClassSpec(450, 650, 1200, 900, 0.02, 2.5),
    "off": ClassSpec(550, 350, 900, 1200, 0.04, 3.5),
    "on": ClassSpec(500, 700, 950, 1250, 0.03, 2.2),
    "right": ClassSpec(400, 520, 1900, 1500, 0.03, 4.5),
    "stop": ClassSpec(650, 380, 1500, 1100, 0.05, 5.0),
    "up": ClassSpec(350, 800, 1100, 1700, 0.02, 2.8),
    "yes": ClassSpec(480, 420, 2100, 1700, 0.03, 3.8),
}


def _synth_keyword(rng: np.random.Generator, spec: ClassSpec) -> np.ndarray:
    t = np.arange(T) / FS
    # random utterance placement within the 1 s window
    start = rng.uniform(0.05, 0.3)
    dur = rng.uniform(0.3, 0.55)
    env = np.exp(-0.5 * ((t - start - dur / 2) / (dur / 2.5)) ** 2)
    env *= 0.5 * (1 + np.cos(2 * np.pi * spec.am_rate * (t - start))) ** 0.7
    jitter = rng.uniform(0.9, 1.1)
    f1 = (spec.f1_start + (spec.f1_end - spec.f1_start) * (t - start) / dur) * jitter
    f2 = (spec.f2_start + (spec.f2_end - spec.f2_start) * (t - start) / dur) * jitter
    ph1 = 2 * np.pi * np.cumsum(f1) / FS
    ph2 = 2 * np.pi * np.cumsum(f2) / FS
    sig = env * (0.6 * np.sin(ph1) + 0.4 * np.sin(ph2))
    sig += spec.noise * rng.standard_normal(T)
    sig += 0.005 * rng.standard_normal(T)                 # mic noise floor
    peak = np.max(np.abs(sig)) + 1e-9
    return (sig / peak * rng.uniform(0.3, 0.9)).astype(np.float32)


def _synth_silence(rng) -> np.ndarray:
    return (0.01 * rng.standard_normal(T)).astype(np.float32)


def _synth_unknown(rng) -> np.ndarray:
    # random formant trajectory not matching any keyword
    spec = ClassSpec(rng.uniform(300, 800), rng.uniform(300, 800),
                     rng.uniform(900, 2200), rng.uniform(900, 2200),
                     rng.uniform(0.02, 0.06), rng.uniform(1.5, 6.0))
    return _synth_keyword(rng, spec)


def synth_batch(rng: np.random.Generator, batch: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """→ (audio (B, 8000) float32 in [-1,1], labels (B,) int32)."""
    labels = rng.integers(0, len(CLASSES), batch)
    audio = np.empty((batch, T), np.float32)
    for i, lb in enumerate(labels):
        name = CLASSES[lb]
        if name == "silence":
            audio[i] = _synth_silence(rng)
        elif name == "unknown":
            audio[i] = _synth_unknown(rng)
        else:
            audio[i] = _synth_keyword(rng, _SPECS[name])
    return audio, labels.astype(np.int32)
