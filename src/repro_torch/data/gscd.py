"""Google Speech Commands loaders + the SynthCommands fallback.

A numpy copy of ``repro/data/gscd.py``: 1 s synthetic utterances at
8 kHz, each class a two-formant trajectory + band noise, over the paper's
12-class set or an 11- or 13..37-class ``Vocab`` — the same
``np.random.Generator`` state gives the same audio in both packages,
which is how the port's training batches, serving requests and continuous
streams are made — and the readers of real GSCD wavs
(``<path>/<label>/<uid>.wav``, 16-bit PCM at a multiple of 8 kHz):
``load_wav_8k``, ``load_dataset`` and ``load_utterance_bank``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import wave

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


def synth_epoch(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return synth_batch(rng, n)


# ------------------------------------------------------------- real GSCD
def load_wav_8k(path: pathlib.Path) -> np.ndarray:
    """Read one GSCD wav → (8000,) float32 at 8 kHz.

    A corrupt file in a 100k-file dataset should name ITSELF, not
    surface as a bare ``struct.error`` three frames deep — every failure
    mode here (truncated/garbage container, wrong sample format, empty
    payload, unusable rate) raises ``ValueError`` carrying the path.
    """
    try:
        with wave.open(str(path), "rb") as w:
            fs = w.getframerate()
            width = w.getsampwidth()
            n = w.getnframes()
            raw = w.readframes(n)
    except (wave.Error, EOFError, OSError) as e:
        raise ValueError(f"corrupt or unreadable wav {path}: {e}") from e
    if width != 2:
        raise ValueError(f"{path}: expected 16-bit PCM, got "
                         f"{8 * width}-bit")
    if n == 0 or len(raw) == 0:
        raise ValueError(f"{path}: wav holds no samples")
    if len(raw) < 2 * n:
        raise ValueError(f"{path}: truncated payload ({len(raw)} bytes "
                         f"for {n} declared frames)")
    if fs < FS or fs % FS != 0:
        raise ValueError(f"{path}: sample rate {fs} is not a multiple "
                         f"of {FS} (cannot decimate)")
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if fs != FS:                                   # naive decimation
        x = x[::fs // FS]
    if len(x) < T:
        x = np.pad(x, (0, T - len(x)))
    return x[:T]


def load_dataset(path: str | None, n_per_class: int = 100, seed: int = 0):
    """Real GSCD if ``path`` given, else SynthCommands."""
    if n_per_class < 1:
        raise ValueError(f"n_per_class must be >= 1, got {n_per_class}")
    if path is None:
        rng = np.random.default_rng(seed)
        return synth_batch(rng, n_per_class * len(CLASSES))
    root = pathlib.Path(path)
    if not root.is_dir():
        raise ValueError(f"GSCD path {root} is not a directory")
    audio, labels = [], []
    for li, name in enumerate(CLASSES):
        d = root / name
        if not d.exists():
            continue
        for f in sorted(d.glob("*.wav"))[:n_per_class]:
            audio.append(load_wav_8k(f))
            labels.append(li)
    if not audio:
        raise ValueError(
            f"GSCD path {root} holds no <label>/<uid>.wav files for any "
            f"of the {len(CLASSES)} classes ({', '.join(CLASSES[:4])}, …)")
    return np.stack(audio), np.asarray(labels, np.int32)


def _trim_utterance(x: np.ndarray, rel_threshold: float = 0.05,
                    pad: int = 160) -> np.ndarray:
    """Cut a fixed-window clip down to its voiced span: the samples
    whose |x| exceeds ``rel_threshold`` × peak, ±``pad`` samples of
    context.  A continuous-stream placement needs a TIGHT span — the 1 s
    GSCD window hides the word somewhere inside it, which would poison
    the ground-truth event bounds."""
    peak = float(np.max(np.abs(x)))
    if peak <= 0.0:
        return x
    voiced = np.flatnonzero(np.abs(x) >= rel_threshold * peak)
    lo = max(int(voiced[0]) - pad, 0)
    hi = min(int(voiced[-1]) + pad + 1, len(x))
    return x[lo:hi]


def load_utterance_bank(path: str | pathlib.Path,
                        vocab: Vocab | None = None
                        ) -> dict[int, list[np.ndarray]]:
    """Real GSCD keywords as a continuous-stream placement bank.

    Reads ``<path>/<label>/<uid>.wav`` (the committed
    ``tests/fixtures/gscd_mini`` layout, or a real GSCD root), trims
    each clip to its voiced span and returns {class_id: [utterance
    arrays]} keyed by ``vocab`` class ids (default: the 12-class set).
    Only labels that are keyword classes of the vocab are loaded.
    ``data.continuous.make_stream(utterances=...)`` composes these real
    keywords into labeled noisy streams — the scenario matrix's
    real-keyword mode.
    """
    vocab = make_vocab(12) if vocab is None else vocab
    root = pathlib.Path(path)
    if not root.is_dir():
        raise ValueError(f"utterance bank path {root} is not a directory")
    bank: dict[int, list[np.ndarray]] = {}
    for cid in vocab.keyword_ids:
        d = root / vocab.names[cid]
        if not d.is_dir():
            continue
        utts = [_trim_utterance(load_wav_8k(f))
                for f in sorted(d.glob("*.wav"))]
        utts = [u for u in utts if len(u) > 0]
        if utts:
            bank[cid] = utts
    if not bank:
        raise ValueError(
            f"utterance bank path {root} holds no keyword wavs for any "
            f"of {[vocab.names[c] for c in vocab.keyword_ids]}")
    return bank
