"""Continuous-audio stream synthesis with ground-truth event labels.

A numpy copy of ``repro/data/continuous.py``: the same
``np.random.Generator`` state gives the same streams and events, bit for
bit, in both packages.  A stream is keyword utterances (formant-
synthesized, or clips from an in-memory utterance bank ``{class_id:
[clips]}``) placed into a background-noise bed at a controlled SNR,
separated by exponentially distributed silences, with the exact sample
span and label of every placed keyword.  ``launch/serve.py --mode
kws-detect`` scores detector fires against these ground-truth events
(FA/hr, miss rate — the DET-curve axes).

Scenario axes: the noise bed is one of ``data.noise``'s kinds (white /
pink / babble), a far-field room can be applied with ``reverb=``
(image-method RIR convolution of the MIXED stream — events keep their dry
sample spans), and the class space is a ``data.gscd.Vocab`` so the same
synthesis drives 11-, 12- and 35-class heads.

Level convention: keywords are synthesized at the TRAINING amplitude
distribution (peak 0.3–0.9, what ``gscd.synth_batch`` produces), and
``snr_db`` sets the noise bed RELATIVE to the keyword RMS.  The bed is
normalized to exactly unit RMS before scaling, so the realized SNR
matches the request to within measurement error
(``ContinuousStream.keyword_rms`` / ``noise_rms`` record the exact
pre-clip levels).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import noise as noise_mod
from repro_torch.data.gscd import FS, ClassSpec, Vocab, _SPECS, make_vocab
from repro_torch.models.kws import CLASSES

DEFAULT_VOCAB = make_vocab(12)

KEYWORD_CLASSES = tuple(i for i, name in enumerate(CLASSES)
                        if name in _SPECS)        # class ids 2..11


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One ground-truth keyword occurrence (inclusive sample bounds)."""

    start: int        # first sample of the utterance
    end: int          # last sample (inclusive)
    label: int        # class id (vocab index; default models.kws.CLASSES)

    def frames(self, frame_shift: int = 128) -> tuple[int, int, int]:
        """(start_frame, end_frame, label) at decision granularity."""
        return (self.start // frame_shift, self.end // frame_shift,
                self.label)


@dataclasses.dataclass(frozen=True)
class ContinuousStream:
    """A synthesized always-on audio stream with its event labels."""

    audio: np.ndarray                  # (T,) float32 in [-1, 1)
    events: list[StreamEvent]
    fs: int = FS
    snr_db: float = 0.0                # the REQUESTED SNR
    noise_kind: str = "white"
    keyword_rms: float = 0.0           # measured mean keyword RMS (pre-clip)
    noise_rms: float = 0.0             # measured bed RMS actually mixed in

    @property
    def duration_s(self) -> float:
        return len(self.audio) / self.fs

    @property
    def measured_snr_db(self) -> float:
        """Realized keyword-over-bed SNR from the recorded pre-clip
        levels (the invariant tests hold this to ±0.5 dB of the
        request)."""
        if self.keyword_rms <= 0.0 or self.noise_rms <= 0.0:
            return float("nan")
        return float(20.0 * np.log10(self.keyword_rms / self.noise_rms))

    def truth_frames(self, frame_shift: int = 128
                     ) -> list[tuple[int, int, int]]:
        """Ground truth at frame granularity — the ``detector.det_point``
        truth format."""
        return [e.frames(frame_shift) for e in self.events]


def _synth_utterance(rng: np.random.Generator, spec: ClassSpec,
                     dur_s: float) -> np.ndarray:
    """One keyword utterance occupying EXACTLY its returned samples
    (unlike ``gscd._synth_keyword``, which hides the utterance somewhere
    inside a fixed 1 s window — useless as a ground-truth span)."""
    n = int(round(dur_s * FS))
    t = np.arange(n) / FS
    env = np.exp(-0.5 * ((t - dur_s / 2) / (dur_s / 2.5)) ** 2)
    env *= 0.5 * (1 + np.cos(2 * np.pi * spec.am_rate * t)) ** 0.7
    jitter = rng.uniform(0.9, 1.1)
    f1 = (spec.f1_start + (spec.f1_end - spec.f1_start) * t / dur_s) * jitter
    f2 = (spec.f2_start + (spec.f2_end - spec.f2_start) * t / dur_s) * jitter
    sig = env * (0.6 * np.sin(2 * np.pi * np.cumsum(f1) / FS)
                 + 0.4 * np.sin(2 * np.pi * np.cumsum(f2) / FS))
    sig += spec.noise * rng.standard_normal(n)
    peak = np.max(np.abs(sig)) + 1e-9
    return (sig / peak * rng.uniform(0.3, 0.9)).astype(np.float32)


def _draw_utterance(rng: np.random.Generator, label: int, vocab: Vocab,
                    utterances: dict[int, list[np.ndarray]] | None
                    ) -> np.ndarray:
    """One placement-ready utterance for ``label``: a real clip from the
    bank (rescaled to the training peak distribution) when a bank is
    supplied, else formant synthesis from the vocab's spec."""
    if utterances is not None:
        clips = utterances[label]
        clip = clips[rng.integers(len(clips))]
        peak = float(np.max(np.abs(clip))) + 1e-9
        return (clip / peak * rng.uniform(0.3, 0.9)).astype(np.float32)
    spec = vocab.specs[vocab.names[label]]
    return _synth_utterance(rng, spec, float(rng.uniform(0.3, 0.55)))


def make_stream(rng: np.random.Generator, duration_s: float = 30.0,
                snr_db: float = 10.0, events_per_min: float = 12.0,
                keyword_classes: tuple[int, ...] | None = None,
                min_gap_s: float = 0.4, *, noise: str = "white",
                reverb=None, vocab: Vocab | None = None,
                utterances: dict[int, list[np.ndarray]] | None = None
                ) -> ContinuousStream:
    """Synthesize one continuous stream.

    duration_s: total stream length (hours-long streams are fine — cost
      is O(T log T) numpy).
    snr_db: keyword-RMS over noise-RMS ratio of the background bed.
    events_per_min: mean keyword rate; inter-keyword gaps are
      ``min_gap_s`` plus an exponential draw, so silence stretches
      dominate at low rates (the always-on regime the VAD gate targets).
    keyword_classes: class ids eligible for placement (default: every
      keyword of the vocab, or every class the utterance bank holds).
    noise: bed kind — "white", "pink" or "babble" (``data.noise``).
    reverb: ``None`` (near-field), a ``data.noise.ReverbSpec`` (room
      solved by the image method) or a precomputed RIR array; applied to
      the MIXED stream, so both keywords and bed arrive far-field.
      Events keep their dry sample spans — the smeared tail lands in the
      scorer's tolerance window, exactly like a real far-field mic.
    vocab: the class space (default: the paper's 12-class set); event
      labels index ``vocab.names``.
    utterances: {class_id: [clips]} in-memory bank of keyword clips to
      place instead of synthesizing.

    Keywords never overlap; each placement is recorded as a
    ``StreamEvent`` with exact inclusive sample bounds.

    Raises ``ValueError`` for unusable combinations (non-positive or
    non-finite duration, non-finite SNR, negative rate or gap, unknown
    noise kind, class ids outside the vocab/bank) rather than
    synthesizing an empty/NaN stream that fails obscurely in the
    detector scoring downstream.
    """
    if not np.isfinite(duration_s) or duration_s <= 0.0:
        raise ValueError(f"duration_s must be finite and > 0, "
                         f"got {duration_s}")
    if not np.isfinite(snr_db):
        raise ValueError(f"snr_db must be finite, got {snr_db} "
                         f"(use a large value, not inf, for 'no noise')")
    if not np.isfinite(events_per_min) or events_per_min < 0.0:
        raise ValueError(f"events_per_min must be finite and >= 0, "
                         f"got {events_per_min}")
    if not np.isfinite(min_gap_s) or min_gap_s < 0.0:
        raise ValueError(f"min_gap_s must be finite and >= 0, "
                         f"got {min_gap_s}")
    if noise not in noise_mod.NOISE_KINDS:
        raise ValueError(f"unknown noise kind {noise!r} "
                         f"(choose one of {list(noise_mod.NOISE_KINDS)})")
    vocab = DEFAULT_VOCAB if vocab is None else vocab
    eligible = (tuple(sorted(utterances)) if utterances is not None
                else vocab.keyword_ids)
    if keyword_classes is None:
        keyword_classes = eligible
    if not keyword_classes:
        raise ValueError("keyword_classes must not be empty")
    bad = [c for c in keyword_classes if c not in eligible]
    if bad:
        raise ValueError(f"keyword_classes {list(bad)} are not placeable "
                         f"class ids (eligible: {list(eligible)})")
    n_total = int(round(duration_s * FS))
    audio = np.zeros(n_total, np.float32)
    events: list[StreamEvent] = []

    # Place keywords left to right with exponential gaps.
    mean_gap_s = max(60.0 / max(events_per_min, 1e-6) - 0.45, 0.05)
    pos = int(rng.exponential(mean_gap_s) * FS)
    kw_rms = []
    while True:
        label = int(keyword_classes[rng.integers(len(keyword_classes))])
        utt = _draw_utterance(rng, label, vocab, utterances)
        if pos + len(utt) > n_total:
            break
        audio[pos:pos + len(utt)] += utt
        events.append(StreamEvent(start=pos, end=pos + len(utt) - 1,
                                  label=label))
        kw_rms.append(float(np.sqrt(np.mean(utt ** 2))))
        pos += len(utt) + int((min_gap_s + rng.exponential(mean_gap_s)) * FS)

    # Noise bed at snr_db below the mean keyword RMS (or a quiet mic
    # floor when the stream holds no keywords at all).  The bed is
    # unit-RMS by construction, so the realized SNR IS the request.
    ref_rms = float(np.mean(kw_rms)) if kw_rms else 0.05
    noise_rms = ref_rms / (10.0 ** (snr_db / 20.0))
    audio += noise_rms * noise_mod.noise_bed(rng, n_total, noise)
    if reverb is not None:
        rir = (reverb if isinstance(reverb, np.ndarray)
               else noise_mod.image_rir(reverb))
        audio = noise_mod.apply_reverb(audio, rir)
    np.clip(audio, -1.0, 1.0 - 2.0 ** -11, out=audio)
    return ContinuousStream(audio=audio, events=events, snr_db=snr_db,
                            noise_kind=noise, keyword_rms=ref_rms,
                            noise_rms=noise_rms)


def make_streams(seed: int, n_streams: int, **kw) -> list[ContinuousStream]:
    """Independent streams (one per serving slot), seeded per stream."""
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1, got {n_streams}")
    return [make_stream(np.random.default_rng(seed + 1000 * i), **kw)
            for i in range(n_streams)]


def frame_labels(stream: ContinuousStream, frame_shift: int = 128
                 ) -> np.ndarray:
    """(F,) int32 per-frame labels: the event's class over its frame
    span, silence (class 0) elsewhere — detection-training targets."""
    n_frames = len(stream.audio) // frame_shift
    labels = np.zeros(n_frames, np.int32)           # vocab id 0 = silence
    for e in stream.events:
        s, end, lb = e.frames(frame_shift)
        labels[s:min(end + 1, n_frames)] = lb
    return labels


def synth_frame_batch(rng: np.random.Generator, batch: int,
                      duration_s: float = 2.0, snr_db: float = 20.0,
                      events_per_min: float = 40.0, frame_shift: int = 128,
                      noise: str = "white", vocab: Vocab | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """A batch of short streams with FRAME-level labels for detection
    training: → (audio (B, T), labels (B, F) int32).

    Per-frame supervision is what calibrates the posterior trace the
    decision head consumes — utterance-level mean-pool training leaves
    noise-frame posteriors unconstrained.  ``noise`` and
    ``vocab`` ride through to ``make_stream`` so scenario training sees
    the bed/class space it will be evaluated under."""
    n = int(round(duration_s * FS))
    n -= n % frame_shift
    if n <= 0:
        raise ValueError(f"duration_s={duration_s} yields no whole "
                         f"{frame_shift}-sample frame at {FS} Hz")
    audio = np.empty((batch, n), np.float32)
    labels = np.empty((batch, n // frame_shift), np.int32)
    for i in range(batch):
        s = make_stream(rng, duration_s=duration_s, snr_db=snr_db,
                        events_per_min=events_per_min, noise=noise,
                        vocab=vocab)
        audio[i] = s.audio[:n]
        labels[i] = frame_labels(s, frame_shift)[:n // frame_shift]
    return audio, labels
