"""The serving loops around a ``StreamingKwsSession`` (depth 1).

Port of the synchronous half of ``repro/launch/engine.py``: every step
assembles the host block, dispatches the device step and fetches the
step's votes (or, in detect mode, its events) before the bookkeeping.
The pipelined engine (depth >= 2, CUDA streams/events in place of JAX's
async dispatch) is a later slice.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

__all__ = ["percentiles_ms", "warm_session", "run_audio_requests",
           "run_continuous_detect"]

_DEPTH_NOT_PORTED = ("the pipelined engine (depth >= 2) is not ported to "
                     "repro_torch yet (ROADMAP.md queue 1 item 9)")


def percentiles_ms(samples_s: Sequence[float]) -> dict:
    """p50/p99/p99.9 of a latency sample list, seconds in → ms out.
    Empty input reports zeros (a run that never stepped)."""
    if not len(samples_s):
        return {"p50": 0.0, "p99": 0.0, "p999": 0.0}
    ms = np.asarray(samples_s, np.float64) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)),
            "p999": float(np.percentile(ms, 99.9))}


def warm_session(sess, chunk: int) -> float:
    """Run one zero block of the serving chunk length through the session
    OUTSIDE the timed loop (first-use kernel builds and allocator warm-up),
    fetch it, then reset the session to pristine state.  Returns the
    warm-up wall seconds."""
    t0 = time.perf_counter()
    out = sess.process_audio(np.zeros((sess.batch, chunk), np.float32))
    out.votes.cpu()                         # block until the step ran
    sess.reset()
    return time.perf_counter() - t0


class _Incarnation:
    """One admitted stream life on a slot: vote tally + chunk progress
    ([chunks consumed, real frames left to vote on])."""

    __slots__ = ("req", "counts", "progress")

    def __init__(self, req, n_classes, real_frames):
        self.req = req
        self.counts = np.zeros(n_classes, np.int64)
        self.progress = [0, real_frames]


def run_audio_requests(sess, sched, ctl, *, audio_q, chunk: int,
                       chunks_per_utt: int, real_frames: int,
                       depth: int = 1):
    """The continuous-batching utterance loop (kws-audio).

    Per step: the live slots' next ``chunk`` samples of their requests
    (``audio_q[req]``, zero-padded) go through ``sess.process_audio``;
    the votes are fetched; a slot that consumed ``chunks_per_utt`` chunks
    is evicted and its request decided by majority vote over its
    ``real_frames`` frames of real audio; then free slots are refilled
    from ``sched``.  ``ctl`` (optional) has ``observe(step_seconds)``.
    The session is warmed first (``warm_session``).  Only ``depth=1`` is
    ported.

    Returns ``(done, stats)``: the [(request, predicted class)] list in
    eviction order, and the loop counters (steps, frames_served,
    pad_frames, warmup_s) with the timing block ``slo``, which is also
    attached to the session (``summary().slo``).
    """
    if depth != 1:
        raise NotImplementedError(_DEPTH_NOT_PORTED)
    warmup_s = warm_session(sess, chunk)

    incarnations: dict[int, _Incarnation] = {}   # slot -> current life
    order: list[_Incarnation] = []               # eviction order
    frames_served = pad_frames = steps = decisions = 0
    step_s: list[float] = []

    def admit():
        for slot, req in sched.admit():
            incarnations[slot] = _Incarnation(req, sess.n_classes,
                                              real_frames)

    admit()
    t_first = time.perf_counter()
    while not sched.idle:
        t_begin = time.perf_counter()
        block = np.zeros((sess.batch, chunk), np.float32)
        for slot, req in sched.live.items():
            c0 = incarnations[slot].progress[0]
            seg = audio_q[req, c0 * chunk:(c0 + 1) * chunk]
            block[slot, :len(seg)] = seg    # zero-pad a short final chunk
        votes = sess.process_audio(block).votes.cpu().numpy()
        n_f = votes.shape[0]
        decisions += n_f * sess.batch
        pad_frames += n_f * (sess.batch - len(sched.live))   # idle slots
        for slot in list(sched.live):
            inc = incarnations[slot]
            st = inc.progress
            n_real = min(n_f, st[1])
            inc.counts += np.bincount(votes[:n_real, slot],
                                      minlength=sess.n_classes)
            st[1] -= n_real
            frames_served += n_real
            pad_frames += n_f - n_real
            st[0] += 1
            if st[0] >= chunks_per_utt:
                sched.evict(slot)
                order.append(inc)
        admit()
        steps += 1
        step_s.append(time.perf_counter() - t_begin)
        if ctl is not None:
            ctl.observe(step_s[-1])
    steady_s = time.perf_counter() - t_first

    done = [(inc.req, int(inc.counts.argmax())) for inc in order]
    slo = {"depth": 1, "steps": steps, "decisions": decisions,
           "steady_state_s": steady_s,
           "decisions_per_s_steady": (decisions / steady_s
                                      if steady_s > 0 else 0.0),
           "step_ms": percentiles_ms(step_s), "warmup_s": warmup_s}
    sess.attach_slo(slo)
    return done, {"steps": steps, "frames_served": frames_served,
                  "pad_frames": pad_frames, "warmup_s": warmup_s,
                  "slo": slo}


def run_continuous_detect(sess, streams_audio, *, chunk: int,
                          n_samples: int, injector=None, depth: int = 1,
                          warm: bool = True, clock=time.perf_counter):
    """The always-on detection loop (kws-detect), depth 1.

    Per step, every slot's next ``chunk`` samples of its stream go
    through ``sess.process_audio`` (a detect-mode session, or a cascade
    session: its ``DetectResult`` carries events masked to the awake
    frames already, so it is served unchanged), the step's events are
    fetched and every slot's fires are appended in frame order.  ``injector`` (fault injection) arrives with the fault
    handling of a later slice and must be ``None``; ``depth >= 2`` raises
    as ``run_audio_requests`` does.

    Returns ``(fires, frame_base, stats)``: per-slot fire lists (for
    ``det_point``), the total frame count, and the loop stats with the
    timing block ``slo`` (also attached to the session summary).
    """
    from repro_torch.models.detector import fires_from_events

    if depth != 1:
        raise NotImplementedError(_DEPTH_NOT_PORTED)
    if injector is not None:
        raise NotImplementedError(
            "fault injection is not ported to repro_torch yet (ROADMAP.md "
            "queue 1 item 8): pass injector=None")
    warmup_s = warm_session(sess, chunk) if warm else 0.0
    slots = sess.batch
    fires: list[list] = [[] for _ in range(slots)]
    frame_base = steps = decisions = 0
    step_s: list[float] = []
    t_first = clock()
    for off in range(0, n_samples, chunk):
        t_begin = clock()
        block = np.stack([s[off:off + chunk] for s in streams_audio])
        events = sess.process_audio(block).events.cpu().numpy()
        for slot in range(slots):
            fires[slot] += fires_from_events(events[:, slot], frame_base)
        frame_base += events.shape[0]
        decisions += events.shape[0] * slots
        steps += 1
        step_s.append(clock() - t_begin)
    steady_s = clock() - t_first
    slo = {"depth": 1, "steps": steps, "decisions": decisions,
           "steady_state_s": steady_s,
           "decisions_per_s_steady": (decisions / steady_s
                                      if steady_s > 0 else 0.0),
           "step_ms": percentiles_ms(step_s), "warmup_s": warmup_s}
    sess.attach_slo(slo)
    return fires, frame_base, {"steps": steps, "warmup_s": warmup_s,
                               "slo": slo}
