"""The pipelined serving engine: overlap host work with device steps.

Port of ``repro/launch/engine.py``.  A synchronous serve loop runs every
phase of a step back to back (assemble the host block, dispatch the
device step, wait for its results, then the bookkeeping), so audio
ingest, device compute and result readback never overlap.
``PipelinedEngine`` keeps up to ``depth`` steps in flight:

    step t-1  ··· fetch ─┐                      (drain: mostly a copy)
    step t    ───────────┼─── computing on device
    step t+1  ─ assemble ┘    (admissions, faults, audio slicing, host)

JAX got the asynchrony for free.  On CUDA the port builds it from three
pieces: the session uploads each block and reset mask from pinned
memory with ``non_blocking=True`` (``streaming._upload``), so a
dispatch never waits for the card; at dispatch the engine starts a
``non_blocking`` device-to-host copy of the fetched field into pinned
memory and records a CUDA event behind it; and a drain waits on that
step's event only, never on the whole stream (a ``.cpu()`` of step t-1
would also wait for step t).  On a CPU session the same code runs with
plain tensors and no events.  A sharded session (``mesh=``) runs each
shard's step on its own CUDA stream and joins the results on the mesh's
first device, whose stream waits on each shard's stream through an
event; the engine's copies and event follow that join, so a drain waits
on exactly the shards' events of that step, and the scheduler's
occupancy counts live streams per shard for ``shard_imbalance``.

Bit-identity contract: the engine issues device operations in exactly
the order the synchronous loop does (per-step pieces, then fault/churn
resets, then admission resets), and every scheduling decision of the
loop drivers below (eviction at ``chunks_per_utt``, admission order,
churn-storm restarts) depends only on chunk COUNTS, which are known at
dispatch time from the result tensors' shapes.  Only the vote and event
VALUES arrive late, and they are tallied per stream *incarnation* (slot
× admission) so a slot recycled mid-flight never pollutes its
predecessor's tally.  ``depth=1`` IS the synchronous loop (dispatch,
then drain at once).  A supervised session fetches its health mask
after every ``check_every`` chunks inside ``process_audio``, which
waits for that step: with the default supervisor depth ≥ 2 degenerates
to depth 1, as in the reference.

Telemetry: per-phase host-blocked time (assemble / dispatch / fetch),
p50/p99/p99.9 step and end-to-end decision latency (assemble start →
results on the host), and the scheduler's shard-occupancy imbalance,
all against an injectable ``clock``.  ``report()`` feeds
``StreamSummary.slo``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["PipelinedEngine", "FetchedStep", "percentiles_ms",
           "warm_session", "run_audio_requests", "run_continuous_detect"]


def percentiles_ms(samples_s: Sequence[float]) -> dict:
    """p50/p99/p99.9 of a latency sample list, seconds in → ms out.
    Empty input reports zeros (a run that never stepped)."""
    if not len(samples_s):
        return {"p50": 0.0, "p99": 0.0, "p999": 0.0}
    ms = np.asarray(samples_s, np.float64) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)),
            "p999": float(np.percentile(ms, 99.9))}


class FetchedStep:
    """One drained pipeline step: host arrays + dispatch metadata.

    ``arrays`` holds the fetched numpy array per piece dispatched for
    the step, in dispatch order; ``piece_frames`` the per-piece frame
    counts; ``meta`` whatever the driver attached at ``submit`` time."""

    __slots__ = ("index", "arrays", "piece_frames", "n_frames", "meta")

    def __init__(self, index, arrays, piece_frames, meta):
        self.index = index
        self.arrays = arrays
        self.piece_frames = piece_frames
        self.n_frames = sum(piece_frames)
        self.meta = meta


class _InFlight:
    """A dispatched step: its results' host copies (pinned, filling on
    CUDA) and the event recorded behind the copies (None on the CPU)."""

    __slots__ = ("index", "host", "event", "piece_frames", "meta",
                 "t_begin")

    def __init__(self, index, host, event, piece_frames, meta, t_begin):
        self.index = index
        self.host = host
        self.event = event
        self.piece_frames = piece_frames
        self.meta = meta
        self.t_begin = t_begin


def _start_fetch(tensors) -> tuple[tuple, Any]:
    """Start copying one step's result tensors to the host.  CUDA: into
    pinned memory with ``non_blocking=True``, an event recorded behind
    the copies; the CPU: the tensors themselves."""
    if not tensors or tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if t.numel():
            h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return tuple(host), event


class PipelinedEngine:
    """Double-buffered host↔device pipeline around a streaming session.

    Drivers use it as::

        eng = PipelinedEngine(sess, depth=2, field="votes", scheduler=sched)
        while serving:
            eng.begin()                     # assemble phase starts
            block = ...                     # host work (slicing, faults)
            _, drained = eng.submit([block], meta=...)   # dispatch + drain
            ...                             # dispatch-time bookkeeping
            for f in drained: integrate(f)  # results from ~depth steps ago
            eng.end()                       # step wall-clock sample
        for f in eng.flush(): integrate(f)
        sess.attach_slo(eng.report())

    ``depth`` bounds the in-flight window: after ``submit`` returns, at
    most ``depth - 1`` steps remain unfetched, so ``depth=1`` fetches
    the step it just dispatched: the synchronous loop, same code path.
    ``field`` names the result attribute fetched per piece ("votes" for
    the utterance loop, "events" for detect/cascade).  ``scheduler``
    (optional) is sampled at every ``end()`` for shard-occupancy
    imbalance.  ``clock`` is injectable for fake-clock telemetry tests.
    """

    def __init__(self, session, *, depth: int = 2, field: str = "votes",
                 scheduler=None,
                 clock: Callable[[], float] = time.perf_counter):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.session = session
        self.depth = depth
        self.field = field
        self._sched = scheduler
        self._clock = clock
        self._queue: list[_InFlight] = []
        self._index = 0
        self._t_begin: float | None = None
        self._t_first: float | None = None
        self._t_last_end: float | None = None
        self.assemble_s = 0.0               # host-blocked phase seconds
        self.dispatch_s = 0.0
        self.fetch_s = 0.0
        self._step_s: list[float] = []
        self._e2e_s: list[float] = []
        self._imbalance: list[int] = []
        self.decisions = 0

    # ------------------------------------------------------- phases --

    def begin(self):
        """Mark the start of a step's host-assemble phase."""
        self._t_begin = self._clock()
        if self._t_first is None:
            self._t_first = self._t_begin

    def submit(self, pieces, meta: Any = None
               ) -> tuple[list[int], list[FetchedStep]]:
        """Dispatch one step's pieces, start their results' copy to the
        host, and drain anything beyond depth.

        Returns ``(piece_frames, drained)``: the per-piece completed
        frame counts, known without waiting from the result tensors'
        shapes, and the fetched steps that fell out of the pipeline
        window, oldest first.  ``meta`` may be a mutable container the
        driver fills AFTER submit returns; it is carried by reference and
        handed back on the step's ``FetchedStep``.
        """
        t_begin = self._t_begin if self._t_begin is not None else self._clock()
        t0 = self._clock()
        self.assemble_s += t0 - t_begin
        outs = [self.session.process_audio(p) for p in pieces]
        host, event = _start_fetch([getattr(o, self.field) for o in outs])
        t1 = self._clock()
        self.dispatch_s += t1 - t0
        piece_frames = [int(h.shape[0]) for h in host]
        self.decisions += sum(piece_frames) * self.session.batch
        self._queue.append(_InFlight(self._index, host, event, piece_frames,
                                     meta, t_begin))
        self._index += 1
        drained = []
        while len(self._queue) > self.depth - 1:
            drained.append(self._fetch_oldest())
        return piece_frames, drained

    def end(self):
        """Close the step: sample wall time and scheduler imbalance."""
        if self._t_begin is None:
            return
        now = self._clock()
        self._step_s.append(now - self._t_begin)
        self._t_last_end = now
        self._t_begin = None
        if self._sched is not None:
            occ = self._sched.occupancy()
            self._imbalance.append(max(occ) - min(occ))

    def flush(self) -> list[FetchedStep]:
        """Drain every in-flight step (oldest first): end of stream."""
        drained = []
        while self._queue:
            drained.append(self._fetch_oldest())
        return drained

    def _fetch_oldest(self) -> FetchedStep:
        inf = self._queue.pop(0)
        t0 = self._clock()
        if inf.event is not None:
            inf.event.synchronize()         # this step's copies, only
        arrays = tuple(h.numpy() for h in inf.host)
        t1 = self._clock()
        self.fetch_s += t1 - t0
        self._e2e_s.append(t1 - inf.t_begin)
        return FetchedStep(inf.index, arrays, inf.piece_frames, inf.meta)

    # ---------------------------------------------------- telemetry --

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def reset_telemetry(self):
        """Zero the timing accumulators (keeps the in-flight queue), e.g.
        after warm-up steps, so first-use builds never reach the
        reported percentiles."""
        self.assemble_s = self.dispatch_s = self.fetch_s = 0.0
        self._step_s = []
        self._e2e_s = []
        self._imbalance = []
        self.decisions = 0
        self._t_begin = None
        self._t_first = None
        self._t_last_end = None

    @property
    def last_step_s(self) -> float:
        return self._step_s[-1] if self._step_s else 0.0

    def report(self) -> dict:
        """The timing block for ``StreamSummary.slo``: the reference's
        keys."""
        steps = len(self._step_s) or self._index
        n = max(steps, 1)
        steady_s = (self._t_last_end - self._t_first
                    if self._t_last_end is not None
                    and self._t_first is not None else sum(self._step_s))
        imb = np.asarray(self._imbalance or [0], np.float64)
        return {
            "depth": self.depth,
            "steps": steps,
            "decisions": self.decisions,
            "steady_state_s": steady_s,
            "decisions_per_s_steady": (self.decisions / steady_s
                                       if steady_s > 0 else 0.0),
            "step_ms": percentiles_ms(self._step_s),
            "e2e_ms": percentiles_ms(self._e2e_s),
            "host_blocked_ms_per_step": {
                "assemble": self.assemble_s * 1e3 / n,
                "dispatch": self.dispatch_s * 1e3 / n,
                "fetch": self.fetch_s * 1e3 / n,
                "total": (self.assemble_s + self.dispatch_s + self.fetch_s)
                * 1e3 / n,
            },
            "shard_imbalance": {"mean": float(imb.mean()),
                                "max": int(imb.max())},
        }


def warm_session(sess, chunk: int) -> float:
    """Run one zero block of the serving chunk length through the session
    OUTSIDE the timed loop (first-use kernel builds and allocator warm-up),
    fetch it, then reset the session to pristine state (stream state and
    telemetry).  Returns the warm-up wall seconds."""
    t0 = time.perf_counter()
    out = sess.process_audio(np.zeros((sess.batch, chunk), np.float32))
    out.votes.cpu()                         # block until the step ran
    sess.reset()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Loop drivers: the two serve-loop shapes, shared by serve.py, chip_smoke.py
# and the tests, so depth 1 and depth >= 2 are the SAME code path with a
# different pipeline window.


class _Incarnation:
    """One admitted stream life on a slot: vote tally + chunk progress.

    A churn storm or re-admission starts a NEW incarnation, so a fetch
    landing after the slot was recycled still credits the life that was
    live when its chunk was dispatched.  ``progress`` is [chunks
    consumed, real frames left to vote on]."""

    __slots__ = ("req", "counts", "progress")

    def __init__(self, req, n_classes, real_frames):
        self.req = req
        self.counts = np.zeros(n_classes, np.int64)
        self.progress = [0, real_frames]


def _apply_actions(sess, actions, fired: dict, live=None) -> list[int]:
    """Carry out a fault plan's driver directives: sleep through stalls,
    reset the churn storms' victims (only the live ones when ``live`` is
    given).  Counts every action by kind into ``fired``.  Returns the
    slots reset."""
    reset: list[int] = []
    for act in actions:
        fired[act.kind] = fired.get(act.kind, 0) + 1
        if act.kind == "stall":
            time.sleep(act.detail)
        elif act.kind == "churn_storm":
            storm = [s for s in act.slots if live is None or s in live]
            sess.reset_streams(storm)       # poof — streams restart
            reset += storm
    return reset


def run_audio_requests(sess, sched, ctl, *, audio_q, chunk: int,
                       chunks_per_utt: int, real_frames: int,
                       injector=None, depth: int = 1, warm: bool = True,
                       clock=time.perf_counter):
    """The continuous-batching utterance loop (kws-audio), pipelined.

    Per step: the live slots' next ``chunk`` samples of their requests
    (``audio_q[req]``, zero-padded) form the block; ``injector`` (a
    ``launch.faults.FaultInjector``) may split, drop, duplicate or
    corrupt it.  Device operations run in the order [pieces..., churn
    resets, admission resets]; a slot that consumed ``chunks_per_utt``
    chunks is evicted (known at dispatch) and its request decided by
    majority vote over its ``real_frames`` frames of real audio; then
    free slots are refilled from ``sched``.  Vote VALUES are integrated
    when their step drains, into the incarnation that was live at
    dispatch.  ``ctl`` (optional) has ``observe(step_seconds)``.

    Returns ``(done, stats)``: the [(request, predicted class)] list in
    eviction order, and the loop counters (steps, frames_served,
    pad_frames, warmup_s, ``pieces``: the dispatched pieces that held a
    whole frame, each one launch of every kernel of the step, and
    ``faults``: the injector's actions by kind) with the
    engine's timing report ``slo``, which is also attached to the
    session (``summary().slo``).
    """
    eng = PipelinedEngine(sess, depth=depth, field="votes",
                          scheduler=sched, clock=clock)
    warmup_s = warm_session(sess, chunk) if warm else 0.0

    incarnations: dict[int, _Incarnation] = {}   # slot -> current life
    order: list[_Incarnation] = []               # eviction order
    frames_served = pad_frames = steps = pieces_run = 0
    fired: dict[str, int] = {}

    def integrate(f: FetchedStep):
        v = (np.concatenate(f.arrays, axis=0) if f.arrays
             else np.zeros((0, sess.batch), np.int32))
        for inc, slot, n_real in f.meta:
            inc.counts += np.bincount(v[:n_real, slot],
                                      minlength=sess.n_classes)

    def admit():
        for slot, req in sched.admit():
            incarnations[slot] = _Incarnation(req, sess.n_classes,
                                              real_frames)

    admit()
    while not sched.idle:
        eng.begin()
        block = np.zeros((sess.batch, chunk), np.float32)
        for slot, req in sched.live.items():
            c0 = incarnations[slot].progress[0]
            seg = audio_q[req, c0 * chunk:(c0 + 1) * chunk]
            block[slot, :len(seg)] = seg    # zero-pad a short final chunk
        pieces, actions = ([block], []) if injector is None \
            else injector.inject(block)
        contribs: list[tuple] = []          # filled below, post-submit
        piece_frames, drained = eng.submit(pieces, meta=contribs)
        n_f = sum(piece_frames)
        pieces_run += sum(1 for pf in piece_frames if pf)
        for s in _apply_actions(sess, actions, fired, sched.live):
            incarnations[s] = _Incarnation(sched.live[s], sess.n_classes,
                                           real_frames)  # same request
        pad_frames += n_f * (sess.batch - len(sched.live))   # idle slots
        for slot in list(sched.live):
            inc = incarnations[slot]
            st = inc.progress
            n_real = min(n_f, st[1])
            contribs.append((inc, slot, n_real))
            st[1] -= n_real
            frames_served += n_real
            pad_frames += n_f - n_real
            st[0] += 1
            if st[0] >= chunks_per_utt:
                sched.evict(slot)
                order.append(inc)
        for f in drained:
            integrate(f)
        admit()
        steps += 1
        eng.end()
        if ctl is not None:
            ctl.observe(eng.last_step_s)
    for f in eng.flush():
        integrate(f)

    done = [(inc.req, int(inc.counts.argmax())) for inc in order]
    slo = eng.report()
    slo["warmup_s"] = warmup_s
    sess.attach_slo(slo)
    return done, {"steps": steps, "frames_served": frames_served,
                  "pad_frames": pad_frames, "pieces": pieces_run,
                  "faults": fired, "warmup_s": warmup_s, "slo": slo}


def run_continuous_detect(sess, streams_audio, *, chunk: int,
                          n_samples: int, injector=None, depth: int = 1,
                          warm: bool = True, clock=time.perf_counter):
    """The always-on detection loop (kws-detect / kws-cascade), pipelined.

    Per step, every slot's next ``chunk`` samples of its stream form the
    block (a detect-mode session, or a cascade session: its
    ``DetectResult`` carries events masked to the awake frames already);
    fault actions (stall / churn resets) are applied BEFORE the pieces
    are dispatched (the detect loops' order; the audio loop applies them
    after), and every slot's fires are appended in frame order: the
    per-piece frame offsets advance at dispatch from the pieces' shapes,
    so the fire positions are exact though the event values land later.

    Returns ``(fires, frame_base, stats)``: per-slot fire lists (for
    ``det_point``), the total frame count, and the loop stats (steps,
    pieces, faults, warmup_s, as ``run_audio_requests`` counts them) with
    the timing report ``slo`` (also attached to the session summary).
    """
    from repro_torch.models.detector import fires_from_events

    eng = PipelinedEngine(sess, depth=depth, field="events", clock=clock)
    warmup_s = warm_session(sess, chunk) if warm else 0.0
    slots = sess.batch
    fires: list[list] = [[] for _ in range(slots)]
    frame_base = steps = pieces_run = 0
    fired: dict[str, int] = {}

    def integrate(f: FetchedStep):
        for ev, base in zip(f.arrays, f.meta):
            for slot in range(slots):
                fires[slot] += fires_from_events(ev[:, slot], base)

    for off in range(0, n_samples, chunk):
        eng.begin()
        block = np.stack([s[off:off + chunk] for s in streams_audio])
        pieces, actions = ([block], []) if injector is None \
            else injector.inject(block)
        _apply_actions(sess, actions, fired)
        bases: list[int] = []
        piece_frames, drained = eng.submit(pieces, meta=bases)
        for pf in piece_frames:             # offsets fixed at dispatch
            bases.append(frame_base)
            frame_base += pf
            pieces_run += pf > 0
        steps += 1
        eng.end()
        for f in drained:
            integrate(f)
    for f in eng.flush():
        integrate(f)

    slo = eng.report()
    slo["warmup_s"] = warmup_s
    sess.attach_slo(slo)
    return fires, frame_base, {"steps": steps, "pieces": pieces_run,
                               "faults": fired, "warmup_s": warmup_s,
                               "slo": slo}
