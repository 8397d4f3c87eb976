"""SynthCommands: the formant-synthesized keyword set, and its vocabularies.

A numpy copy of the synthesis part of ``repro/data/gscd.py``: 1 s
utterances at 8 kHz, each class a two-formant trajectory + band noise,
over the paper's 12-class set or an 11- or 13..37-class ``Vocab``.  The
same ``np.random.Generator`` state gives the same audio in both packages,
which is how the port's serving requests and continuous streams are made.
Reading real GSCD wavs (``load_dataset``, ``load_utterance_bank``) waits
for a dataset on disk.
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


# GSCD-v2 words beyond the paper's 10-keyword task, in the fixed order
# procedural specs are assigned (so a 35-class vocab is stable across
# runs and machines).
_V2_EXTRA_WORDS = (
    "backward", "bed", "bird", "cat", "dog", "eight", "five", "follow",
    "forward", "four", "happy", "house", "learn", "marvin", "nine", "one",
    "seven", "sheila", "six", "three", "tree", "two", "visual", "wow",
    "zero")


def _extra_spec(rng: np.random.Generator) -> ClassSpec:
    """A procedurally drawn two-formant spec for a vocabulary word with
    no hand-tuned entry in ``_SPECS`` (same parameter ranges as the
    hand-tuned ten, so extra classes are neither easier nor harder)."""
    return ClassSpec(
        f1_start=float(rng.uniform(300, 800)),
        f1_end=float(rng.uniform(300, 800)),
        f2_start=float(rng.uniform(900, 2200)),
        f2_end=float(rng.uniform(900, 2200)),
        noise=float(rng.uniform(0.02, 0.05)),
        am_rate=float(rng.uniform(1.5, 6.0)))


@dataclasses.dataclass(frozen=True)
class Vocab:
    """A vocabulary: ordered class names + a synthesis spec per keyword.

    ``names[0]`` is always "silence"; keyword classes are the names with
    an entry in ``specs``.  ``first_keyword`` is the smallest class id
    eligible to fire a detection event (what ``DetectorConfig``
    consumes) — non-keyword service classes ("silence", "unknown") sort
    before every keyword by construction.
    """

    names: tuple[str, ...]
    specs: dict[str, ClassSpec]

    @property
    def n_classes(self) -> int:
        return len(self.names)

    @property
    def first_keyword(self) -> int:
        return next(i for i, n in enumerate(self.names) if n in self.specs)

    @property
    def keyword_ids(self) -> tuple[int, ...]:
        return tuple(i for i, n in enumerate(self.names) if n in self.specs)


def make_vocab(n_classes: int = 12, seed: int = 1234) -> Vocab:
    """The scenario matrix's vocabulary axis.

    n_classes=12: the paper's head — silence, unknown, 10 keywords.
    n_classes=11: the paper's 11-class metric as a head — "unknown"
      dropped, keyword ids shift down by one (exercises a non-default
      ``first_keyword`` end to end).
    n_classes 13..37: silence, unknown, 10 base keywords + (n−12)
      GSCD-v2 words (procedural specs, seeded — 35 is GSCD-v2's full
      word list).
    """
    if n_classes == 12:
        return Vocab(names=tuple(CLASSES), specs=dict(_SPECS))
    if n_classes == 11:
        names = tuple(n for n in CLASSES if n != "unknown")
        return Vocab(names=names, specs=dict(_SPECS))
    n_extra = n_classes - 12
    if not 0 < n_extra <= len(_V2_EXTRA_WORDS):
        raise ValueError(
            f"unsupported vocab size {n_classes} (supported: 11, 12, "
            f"13..{12 + len(_V2_EXTRA_WORDS)})")
    rng = np.random.default_rng(seed)
    extra = {w: _extra_spec(rng) for w in _V2_EXTRA_WORDS[:n_extra]}
    return Vocab(names=tuple(CLASSES) + tuple(extra),
                 specs={**_SPECS, **extra})


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


def synth_batch(rng: np.random.Generator, batch: int,
                vocab: Vocab | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """→ (audio (B, 8000) float32 in [-1,1], labels (B,) int32).

    ``vocab`` (default: the paper's 12-class set) sizes the label space:
    labels are indices into ``vocab.names`` and keyword audio comes from
    ``vocab.specs`` — the 11/35-class heads train on exactly this."""
    names = CLASSES if vocab is None else vocab.names
    specs = _SPECS if vocab is None else vocab.specs
    labels = rng.integers(0, len(names), batch)
    audio = np.empty((batch, T), np.float32)
    for i, lb in enumerate(labels):
        name = names[lb]
        if name == "silence":
            audio[i] = _synth_silence(rng)
        elif name == "unknown":
            audio[i] = _synth_unknown(rng)
        else:
            audio[i] = _synth_keyword(rng, specs[name])
    return audio, labels.astype(np.int32)
