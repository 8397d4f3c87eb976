"""Always-on keyword DETECTION head + detection metrics.

PyTorch port of ``repro/models/detector.py``.  The deployment scenario is
an unbounded audio stream in which the detector must decide *when* a
keyword occurred.  This module turns per-frame class posteriors into
discrete keyword EVENTS with a posterior-smoothing / hysteresis state
machine, and scores event streams against ground truth with the
deployment metrics — false alarms per hour vs. miss rate.

Decision head (``detector_scan``), per stream slot and per 16 ms frame:

  1. **Smooth**: an exponential moving average over the per-frame class
     posteriors, ``s_t = s_{t-1} + α (p_t − s_{t-1})`` with ``s_0 = 0``.
  2. **Score**: the smoothed posteriors of the KEYWORD classes (class
     ids >= ``first_keyword`` — "silence" and "unknown" never fire).
  3. **Hysteresis**: idle → in-event when a keyword's score rises ABOVE
     its ``fire_threshold`` (this rising edge emits exactly one event,
     labeled with the highest exceeding keyword); in-event → idle when
     every keyword's score falls BELOW its ``release_threshold``.
  4. **Refractory**: after a fire, new fires are suppressed for
     ``refractory_frames`` frames.

``detector_step`` / ``detector_scan`` are the plain PyTorch version of
the head that the CUDA kernel ``csrc/detect_head.cu`` runs
(``kernels/detect_head.py``).  They round as XLA:CPU rounds the
reference: the EMA's product is fused into its add (``xla_math.fma``,
exact), and a difference that lands below 2^-126 is flushed to zero,
as XLA's FTZ mode flushes it.  Everything is elementwise along the slot
axis and sequential along frames only, so a stream processed in chunks
with the state carried gives the same bits as in one piece.

Scoring (host-side, numpy, exact): a fire is a HIT if it lands inside a
ground-truth event's ``[start − tol, end + tol]`` frame window with the
right label (each truth event can be claimed once; matched greedily in
time order); every unmatched fire is a FALSE ALARM; every unclaimed truth
event is a MISS.  ``det_point`` reduces a fire list to (miss rate,
FA/hr).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import xla_math as xm

FRAME_S = 0.016                       # 16 ms per decision (paper)
NO_EVENT = -1                         # events-array value for "no fire"


class DetectorConfig(NamedTuple):
    """Static configuration of the detection head.

    smooth_alpha: EMA coefficient on the per-frame posteriors (1.0 = no
      smoothing).
    fire_threshold: smoothed keyword posterior that opens an event
      (strictly-above comparison): one scalar for every keyword, or a
      tuple with one threshold PER keyword class (length
      n_classes − first_keyword, in class-id order), as
      ``calibrate_fire_thresholds`` produces.
    release_threshold: smoothed keyword posterior that closes the event
      (strictly-below, every keyword); scalar or per-keyword tuple, and
      elementwise <= fire_threshold (the hysteresis band).
    refractory_frames: minimum frames between two fires (~16 ms each).
    first_keyword: first class id eligible to fire.
    """

    smooth_alpha: float = 0.25
    fire_threshold: float | tuple[float, ...] = 0.55
    release_threshold: float | tuple[float, ...] = 0.40
    refractory_frames: int = 30
    first_keyword: int = 2


def band_inverted(cfg: DetectorConfig) -> bool:
    """True when any keyword's release threshold exceeds its fire
    threshold (the session-construction check, scalar- and
    per-keyword-aware).  Raises ``ValueError`` when the two thresholds
    are tuples of incompatible lengths."""
    fire = np.asarray(cfg.fire_threshold, np.float32)
    rel = np.asarray(cfg.release_threshold, np.float32)
    try:
        return bool(np.any(rel > fire))
    except ValueError as e:
        raise ValueError(
            f"fire_threshold and release_threshold must broadcast "
            f"(per-keyword tuples need equal lengths): got shapes "
            f"{fire.shape} and {rel.shape}") from e


def keyword_thresholds(cfg: DetectorConfig, n_classes: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(fire, release) as float32 arrays of one threshold per keyword
    class (n_classes − first_keyword of them), scalars broadcast.  Raises
    ``ValueError`` for a head with no keyword class or a tuple of the
    wrong length."""
    n_kw = n_classes - cfg.first_keyword
    if cfg.first_keyword < 0 or n_kw < 1:
        raise ValueError(f"first_keyword={cfg.first_keyword} leaves no "
                         f"keyword class among {n_classes}")
    out = []
    for name in ("fire_threshold", "release_threshold"):
        th = np.asarray(getattr(cfg, name), np.float32)
        if th.ndim > 1 or (th.ndim == 1 and th.shape[0] not in (1, n_kw)):
            raise ValueError(f"{name} has shape {th.shape}; expected a "
                             f"scalar or one per keyword ({n_kw})")
        out.append(np.broadcast_to(th, (n_kw,)).copy())
    return out[0], out[1]


class DetectorState(NamedTuple):
    """Per-slot carried state of the decision head (device-resident).

    smooth: (B, K) float32 — EMA-smoothed posteriors.
    active: (B,) int32 — class id of the event currently open, or
      ``NO_EVENT`` when idle (the hysteresis latch).
    refract: (B,) int32 — frames left in the refractory window.
    """

    smooth: torch.Tensor
    active: torch.Tensor
    refract: torch.Tensor


def init_detector_state(batch: int, n_classes: int,
                        device="cpu") -> DetectorState:
    """Idle detector: zero smoothed posteriors, no open event."""
    return DetectorState(
        smooth=torch.zeros((batch, n_classes), dtype=torch.float32,
                           device=device),
        active=torch.full((batch,), NO_EVENT, dtype=torch.int32,
                          device=device),
        refract=torch.zeros((batch,), dtype=torch.int32, device=device))


def detector_step(cfg: DetectorConfig, state: DetectorState,
                  post: torch.Tensor) -> tuple[DetectorState, torch.Tensor]:
    """One frame of the decision head.  post: (B, K) posteriors.

    Returns (new_state, event (B,) int32): the fired keyword class id on
    the fire frame, ``NO_EVENT`` otherwise.
    """
    diff = xm.ftz(post.float() - state.smooth)
    smooth = xm.fma(cfg.smooth_alpha, diff, state.smooth)
    fire_th, rel_th = (torch.from_numpy(t).to(smooth.device) for t in
                       keyword_thresholds(cfg, smooth.shape[-1]))
    kw = smooth[:, cfg.first_keyword:]
    exceed = kw > fire_th                              # (B, K_kw)
    # First index among equal maxima, as jnp.argmax.
    cls = (torch.argmax(torch.where(exceed, kw, float("-inf")), dim=-1)
           + cfg.first_keyword).to(torch.int32)
    idle = state.active == NO_EVENT
    fire = idle & (state.refract == 0) & exceed.any(dim=-1)
    release = ~idle & (kw < rel_th).all(dim=-1)
    no_event = torch.full_like(cls, NO_EVENT)
    active = torch.where(fire, cls,
                         torch.where(release, no_event, state.active))
    refract = torch.where(fire,
                          torch.full_like(state.refract,
                                          cfg.refractory_frames),
                          torch.clamp(state.refract - 1, min=0))
    event = torch.where(fire, cls, no_event)
    return DetectorState(smooth=smooth, active=active, refract=refract), event


def detector_scan(cfg: DetectorConfig, state: DetectorState,
                  posts: torch.Tensor) -> tuple[DetectorState, torch.Tensor]:
    """Run the decision head over a chunk of frames.

    posts: (F, B, K) per-frame class posteriors, frame-major.  Returns
    (carried state, events (F, B) int32) — ``events[f, b]`` is the fired
    keyword class id at frame f of slot b, ``NO_EVENT`` where none fired.
    Scanning [a|b] with the state carried equals scanning the
    concatenation.
    """
    events = []
    for post in posts:
        state, ev = detector_step(cfg, state, post)
        events.append(ev)
    if not events:
        return state, torch.zeros((0, posts.shape[1]), dtype=torch.int32,
                                  device=posts.device)
    return state, torch.stack(events)


def detector_state_flags(state: DetectorState) -> torch.Tensor:
    """(B,) bool, True where the slot's EMA is poisoned: a healthy slot's
    ``smooth`` is a convex combination of softmax outputs, finite and in
    [0, 1]; anything else means the latch can never fire or release
    sanely again and the slot needs a reset."""
    s = state.smooth
    bad = ~torch.isfinite(s) | (s < -1e-6) | (s > 1.0 + 1e-6)
    return bad.any(dim=-1)


# ---------------------------------------------------------------- metrics --

@dataclasses.dataclass(frozen=True)
class DetPoint:
    """One operating point on the DET curve (exact counts, host-side)."""

    n_events: int          # ground-truth keyword events in the stream
    hits: int
    misses: int
    false_alarms: int
    miss_rate: float       # misses / n_events (0.0 when no events)
    fa_per_hour: float
    hours: float           # audio hours scored (frames × 16 ms)


def fires_from_events(events: np.ndarray, frame_offset: int = 0
                      ) -> list[tuple[int, int]]:
    """Decode a detector ``events`` array into a fire list.

    events: (F,) or (F, 1) int32 from ``detector_scan`` (single stream).
    Returns [(frame, class_id)] with ``frame_offset`` added — pass the
    running frame count when accumulating across serve chunks.
    """
    ev = np.asarray(events).reshape(-1)
    frames = np.flatnonzero(ev != NO_EVENT)
    return [(int(f) + frame_offset, int(ev[f])) for f in frames]


def match_fires(fires: Sequence[tuple[int, int]],
                truth: Sequence[tuple[int, int, int]],
                tol_frames: int = 0) -> tuple[int, int]:
    """Greedy time-order matching of fires against truth events.

    fires: [(frame, class_id)] sorted by frame; truth: [(start_frame,
    end_frame, class_id)] with inclusive bounds.  A fire claims an
    unclaimed truth event whose label matches and whose
    ``[start − tol, end + tol]`` window contains the fire frame,
    preferring an event whose TRUE span contains the fire over a
    tolerance-only match (so when adjacent same-class windows overlap, a
    fire inside event B cannot be mis-credited to the earlier missed
    event A), earliest-start among equals.  Each truth event can be
    claimed once — a second fire on the same event is a false alarm (the
    hysteresis/refractory machinery exists to make that rare).  Returns
    (hits, false_alarms).
    """
    claimed: set[int] = set()
    false_alarms = 0
    for frame, cls in fires:
        exact = tolerated = None
        for i, (start, end, label) in enumerate(truth):
            if i in claimed or label != cls:
                continue
            if start <= frame <= end:
                exact = i
                break
            if tolerated is None and \
                    start - tol_frames <= frame <= end + tol_frames:
                tolerated = i
        hit = exact if exact is not None else tolerated
        if hit is None:
            false_alarms += 1
        else:
            claimed.add(hit)
    return len(claimed), false_alarms


def det_point(fires: Sequence[tuple[int, int]],
              truth: Sequence[tuple[int, int, int]], n_frames: int,
              tol_frames: int = 0, frame_s: float = FRAME_S) -> DetPoint:
    """Reduce a fire list to one (miss rate, FA/hr) operating point.

    ``n_frames`` is the total frames SCORED (it defines the hours the
    false alarms are normalized by), not the frames with speech.
    """
    hits, false_alarms = match_fires(fires, truth, tol_frames)
    n_events = len(truth)
    misses = n_events - hits
    hours = n_frames * frame_s / 3600.0
    return DetPoint(
        n_events=n_events, hits=hits, misses=misses,
        false_alarms=false_alarms,
        miss_rate=misses / n_events if n_events else 0.0,
        fa_per_hour=false_alarms / hours if hours > 0 else 0.0,
        hours=hours)


def calibrate_fire_thresholds(posts: np.ndarray,
                              truth: Sequence[tuple[int, int, int]],
                              base_cfg: DetectorConfig,
                              candidates: Sequence[float],
                              fa_budget_per_hour: float = 60.0,
                              tol_frames: int = 0) -> tuple[float, ...]:
    """Per-keyword fire thresholds from a recorded posterior trace.

    Per-cell calibration for a scenario (noise bed, SNR, vocabulary): one
    shared scalar threshold forces every keyword onto the same operating
    point, but under noise the per-class posterior statistics diverge —
    a babble bed pushes confusable words' false-alarm rates up while
    distinct words keep headroom.  This sweeps each keyword class
    INDEPENDENTLY (all other keyword columns zeroed, so the global
    hysteresis latch sees only the class under calibration — the same
    ``detector_scan`` code path the serving step runs) and picks, per
    class, the most permissive candidate whose class-restricted false
    alarms stay within ``fa_budget_per_hour``; among candidates inside
    the budget, lowest miss count wins, earliest (most permissive)
    among equals.  Falls back to the strictest candidate when none meets
    the budget.

    posts: (F, K) float posterior trace of a CALIBRATION stream (use a
      different seed than the evaluation stream — calibrating on the
      eval stream is leakage).
    truth: ground-truth events of the calibration stream
      (``ContinuousStream.truth_frames``).
    base_cfg: the config whose smoothing/refractory/first_keyword the
      calibrated thresholds will be served with.
    candidates: scalar fire thresholds to sweep (ascending recommended).
    Returns a tuple of length ``K − first_keyword`` suitable for
    ``DetectorConfig(fire_threshold=...)``.
    """
    if not candidates:
        raise ValueError("candidates must not be empty")
    posts = np.asarray(posts, np.float32)
    n_frames, n_classes = posts.shape
    hours = n_frames * FRAME_S / 3600.0
    fk = base_cfg.first_keyword
    chosen = []
    for cls in range(fk, n_classes):
        cls_truth = [t for t in truth if t[2] == cls]
        solo = posts.copy()
        solo[:, fk:] = 0.0
        solo[:, cls] = posts[:, cls]
        inside_budget = []             # (misses, idx, threshold)
        ordered = sorted(float(c) for c in candidates)
        for idx, cand in enumerate(ordered):
            cfg = base_cfg._replace(fire_threshold=cand,
                                    release_threshold=0.75 * cand)
            state = init_detector_state(1, n_classes)
            _, events = detector_scan(cfg, state,
                                      torch.from_numpy(solo[:, None, :]))
            fires = fires_from_events(events.numpy())
            hits, fas = match_fires(fires, cls_truth, tol_frames)
            if (fas / hours if hours > 0 else 0.0) <= fa_budget_per_hour:
                inside_budget.append((len(cls_truth) - hits, idx, cand))
        chosen.append(min(inside_budget)[2] if inside_budget
                      else ordered[-1])
    return tuple(chosen)


def pool_points(points: Sequence[DetPoint]) -> DetPoint:
    """Pool per-stream DetPoints into one aggregate operating point
    (counts add; rates are recomputed from the pooled counts)."""
    n_events = sum(p.n_events for p in points)
    hits = sum(p.hits for p in points)
    fas = sum(p.false_alarms for p in points)
    hours = sum(p.hours for p in points)
    misses = n_events - hits
    return DetPoint(
        n_events=n_events, hits=hits, misses=misses, false_alarms=fas,
        miss_rate=misses / n_events if n_events else 0.0,
        fa_per_hour=fas / hours if hours > 0 else 0.0, hours=hours)
