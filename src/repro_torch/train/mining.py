"""Hard-negative mining of false-alarm segments.

Port of ``repro/train/mining.py``.  A detector's false alarms per hour
come from the tail of the background distribution: the few noise
segments whose time-frequency shape excites a keyword class.  Uniformly
sampled background almost never contains them, so the current model picks
its own worst false-alarm segments and they are fed back as explicit
negatives.

``mine_hard_negatives`` synthesizes keyword-free noisy streams, scores
each candidate by the model's peak smoothed keyword posterior (the EMA the
serving head applies, so "hard" means "would fire"), and returns the top-k
as a ready-to-train batch of features with all-silence frame labels.  On
a CUDA device the candidates' features come from the ``iir_fex`` kernel
and their per-frame logits from ``delta_gru_seq``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.continuous import make_stream
from repro_torch.data.gscd import Vocab
from repro_torch.kernels.detect_head import xla_softmax
from repro_torch.models import kws


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    """Knobs of one mining round.

    n_candidates: keyword-free candidate streams synthesized per round.
    top_k: hardest candidates returned (must be ≤ n_candidates).
    duration_s: candidate stream length (matches the training streams).
    noise / snr_db: background condition to mine in.
    smooth_alpha: EMA applied to posteriors before taking the peak
      (mirror of ``DetectorConfig.smooth_alpha``).
    first_keyword: first class id that counts as a keyword posterior.
    """

    n_candidates: int = 24
    top_k: int = 8
    duration_s: float = 2.0
    noise: str = "babble"
    snr_db: float = 5.0
    smooth_alpha: float = 0.25
    first_keyword: int = 2


def _ema(posts: np.ndarray, alpha: float) -> np.ndarray:
    """(F, K) → (F, K) exponential moving average, s_0 = 0 (the serving
    head's ramp-from-silence convention)."""
    out = np.zeros_like(posts)
    s = np.zeros(posts.shape[-1], posts.dtype)
    for f in range(len(posts)):
        s = s + alpha * (posts[f] - s)
        out[f] = s
    return out


def mine_hard_negatives(params, cfg, fex, rng: np.random.Generator,
                        mining: MiningConfig = MiningConfig(),
                        threshold: float | None = None,
                        vocab: Vocab | None = None,
                        frame_shift: int = 128
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One mining round → (feats (k, F, C) float32, frame_labels (k, F)
    int32, scores (k,) float32), hardest first, as numpy arrays.

    Candidates are keyword-free streams (``events_per_min=0``) in the
    configured noise bed, scored by the float forward
    (``kws.forward_frames``, ``backend="pallas"``) at the training Δ_TH on
    the params' device; the labels are all silence.
    """
    if mining.top_k > mining.n_candidates:
        raise ValueError(f"top_k ({mining.top_k}) must be <= n_candidates "
                         f"({mining.n_candidates})")
    n = int(round(mining.duration_s * 8000))
    n -= n % frame_shift
    if n <= 0:
        raise ValueError(f"duration_s={mining.duration_s} yields no whole "
                         f"frame")
    audio = np.empty((mining.n_candidates, n), np.float32)
    for i in range(mining.n_candidates):
        s = make_stream(rng, duration_s=mining.duration_s,
                        snr_db=mining.snr_db, events_per_min=0.0,
                        noise=mining.noise, vocab=vocab)
        audio[i] = s.audio[:n]
    with torch.no_grad():
        feats = fex(torch.from_numpy(audio).to(params["w_x"].device))
        logits, _ = kws.forward_frames(params, cfg, feats, threshold,
                                       backend="pallas")
        posts = xla_softmax(logits).movedim(0, 1).cpu().numpy()
    scores = np.empty(mining.n_candidates, np.float32)
    for i in range(mining.n_candidates):
        sm = _ema(posts[i], mining.smooth_alpha)
        scores[i] = float(np.max(sm[:, mining.first_keyword:]))
    order = np.argsort(-scores)[:mining.top_k]
    labels = np.zeros((mining.top_k, n // frame_shift), np.int32)
    return (feats.cpu().numpy()[order], labels,
            scores[order].astype(np.float32))
