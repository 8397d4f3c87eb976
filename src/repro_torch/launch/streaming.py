"""Streaming KWS sessions — raw audio in, decisions or keyword events out.

PyTorch port of ``repro/launch/streaming.py``, in both numerics,
unsharded or over a slot mesh.  The session keeps FEx
state, ΔGRU state and op-count telemetry on the device between chunks;
the host hands over a chunk of raw audio and gets device tensors back.
One float32 chunk is one call of ``_process_audio_chunk``: 12-bit
quantize → FEx (``batched_iir_fex``, one kernel launch) → ΔGRU
(``delta_gru_seq``, one kernel launch) → FC + argmax → telemetry and
per-slot health flags.  ``numerics="int8"`` runs the deployed integer
datapath instead (``_process_audio_chunk_int``): 12-bit ADC codes →
integer FEx (``batched_iir_fex_int``) → int8-weight / int16-state ΔGRU
with the 24-bit saturating accumulator (``delta_gru_seq_int``) → integer
FC, decisions as argmaxes over int32 logit codes.  Nothing in the step
calls ``.item()`` or ``.cpu()``, and the audio block and the reset masks
go up through pinned memory with ``non_blocking=True``
(``_upload``), so without a supervisor ``process_audio`` and
``reset_streams`` never wait for the card; only the caller's fetch of
the results does (``launch.engine`` fetches through pinned memory and
one CUDA event per step).

    sess = StreamingKwsSession(params, cfg, threshold=0.1, batch=32)
    for audio in chunks:                       # (32, samples) raw audio
        votes = sess.process_audio(audio).votes.cpu()   # one fetch
    print(sess.summary())                      # one fetch for telemetry

With ``detector=`` the session is an always-on DETECTOR
(``_process_audio_chunk_detect[_int]``): the frames' energies gate the
features through the VAD (``frontend/vad.py``, in closed form: the same
~20 launches whatever the chunk's length) before the ΔGRU, and the FC logits go through the
detection head kernel (``detect_head``: softmax → EMA → hysteresis latch
over the chunk, one launch), which returns per-frame keyword events.

With ``cascade=`` and ``stage0_params=`` the detector is a TWO-STAGE WAKE
CASCADE (``_process_audio_chunk_cascade[_int]``): an always-on stage-0
micro-ΔGRU (``delta_gru_seq`` on the leading ``s0_channels`` features)
scores every frame, the wake head kernel (``wake_head``: stage 0's
posterior and the wake machine over the chunk, one launch; its plain
version is ``cascade_wake_scan``, in closed form) turns the scores into a
per-frame wake trace, and stage 1 runs only on its awake
frames (the masked ``delta_gru_seq`` instantiation: an asleep slot's
state stays bit-frozen and costs a store of h); the head still sees
every frame, and events on asleep frames are masked out.

With ``supervisor=SupervisorConfig(...)`` a host supervisor reads the
per-slot health mask every ``check_every`` chunks (a fetch that waits
for the step), quarantines the slots whose state cannot recover on its
own and resets them; ``set_threshold`` moves Δ_TH mid-stream, the lever
of ``launch.serve.AdmissionController``.

Scale-out (DESIGN.md §6): with ``mesh=`` (``launch.mesh.SlotMesh``) the
session is a sharded continuous-batching engine driven by one host
thread.  The slot axis is split into contiguous blocks, one per shard;
each shard's FEx, ΔGRU, VAD, detector, cascade and telemetry state lives
on its device, and its step (``kernels.platform.shard_map_kernels``) is
the unsharded step at batch B/n, launched on its own CUDA stream; the
weights are replicated once per device.  Results and health masks are
joined on the slot axis on the mesh's first device, whose stream waits
on each shard's stream through an event, so the host never waits; the
telemetry stays per shard and is summed on the host in ``summary()``.
Resets touch only the shards that own a reset slot.  Decisions, logits
and counters are those of the unsharded session bit for bit (the float
FC sums in a fixed order, ``_fc``, so the row count cannot move them).

Chunk boundaries are invisible: samples past the last whole 16 ms frame
are carried host-side and prepended to the next chunk.  Without
``device=`` the session runs on the GPU and raises when there is none.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import delta_gru as dg
from repro_torch.core import fixed_point as fp
from repro_torch.core.energy_model import (cascade_frame_cost, fex_energy_nj,
                                           frame_cost, vad_energy_nj)
from repro_torch.core.quantize import quantize_audio_12b
from repro_torch.frontend.fex import (FeatureExtractor, FExConfig, FExState,
                                      _pack_state, _unpack_state, fex_scan,
                                      init_fex_state)
from repro_torch.frontend.vad import (VADConfig, VADState, frame_energy,
                                      init_vad_state, vad_gate,
                                      vad_state_flags)
from repro_torch.kernels import autotune
from repro_torch.kernels.detect_head import detect_head
from repro_torch.kernels.platform import (join_slots, resolve_device,
                                          shard_map_kernels)
from repro_torch.kernels.wake_head import wake_head
from repro_torch.launch.mesh import SlotMesh
from repro_torch.models import kws
from repro_torch.models.detector import (NO_EVENT, DetectorConfig,
                                         DetectorState, band_inverted,
                                         detector_state_flags,
                                         init_detector_state)
from repro_torch.parallel import sharding as shp
from repro_torch.parallel.sharding import check_slot_partition


class ChunkResult(NamedTuple):
    """Device-side per-chunk outputs — nothing here has been synced."""

    logits: torch.Tensor   # (frames, batch, n_classes) per-frame logits
    votes: torch.Tensor    # (frames, batch) int32 per-frame argmax
    nz: torch.Tensor       # (frames, batch) transmitted deltas per frame


class DetectResult(NamedTuple):
    """Per-chunk outputs of the detection pipeline (``detector=`` mode),
    frame-major and on the device like ``ChunkResult``."""

    logits: torch.Tensor   # (frames, batch, n_classes) per-frame logits
    votes: torch.Tensor    # (frames, batch) int32 per-frame argmax
    nz: torch.Tensor       # (frames, batch) transmitted deltas per frame
    events: torch.Tensor   # (frames, batch) int32 fired class id, -1 = none
    gate: torch.Tensor     # (frames, batch) bool VAD gate (True = open)
    awake: Any = None      # (frames, batch) bool stage-1 wake trace
                           #   (cascade sessions only; None otherwise)


class StreamInputError(ValueError):
    """Typed rejection at the ``process_audio`` boundary: non-finite
    samples, un-decodable dtypes, or out-of-range integer codes.  Raised
    before anything reaches the device."""


# ------------------------------------------------- two-stage wake cascade --
class CascadeConfig(NamedTuple):
    """Policy of the stage-0 → stage-1 wake cascade (field names, order and
    defaults are the reference's).

    wake_threshold: stage-0 event posterior at or above which an asleep
      slot wakes stage 1 (this frame already runs awake).
    sleep_threshold: posterior at or above which an awake slot stays
      awake with its hangover refreshed; must be <= wake_threshold.
    hangover_frames: frames stage 1 stays powered after the score drops
      below sleep_threshold.
    s0_threshold: stage 0's own Δ_TH.
    s0_channels: leading FEx channels stage 0 reads (its input width).
    """

    wake_threshold: float = 0.5
    sleep_threshold: float = 0.25
    hangover_frames: int = 15
    s0_threshold: float = 0.0
    s0_channels: int = 4


class CascadeState(NamedTuple):
    """Per-slot cascade state on the device: the wake latch, the hangover
    countdown, and stage 0's own delta state (float or integer codes)."""

    awake: torch.Tensor     # (B,) bool — stage 1 powered
    hang: torch.Tensor      # (B,) int32 hangover countdown
    s0: dg.DeltaState       # stage-0 carried delta state


def init_cascade_state(batch: int, s0_gru, *, int8: bool) -> CascadeState:
    """Fresh cascade state on the stage-0 weights' device: every slot
    asleep, stage-0 state zeroed with M seeded at its bias."""
    I = s0_gru.w_x.shape[0]
    H = s0_gru.w_h.shape[0]
    s0 = (fp.init_int_delta_state(batch, I, H, s0_gru) if int8
          else dg.init_delta_state(batch, I, H, s0_gru))
    dev = s0.h.device
    return CascadeState(awake=torch.zeros((batch,), dtype=torch.bool,
                                          device=dev),
                        hang=torch.zeros((batch,), dtype=torch.int32,
                                         device=dev), s0=s0)


_NEVER = -(1 << 30)            # a frame index before every other


def cascade_wake_scan(cfg: CascadeConfig, awake, hang, score):
    """The wake/sleep machine over one chunk of stage-0 scores, in closed
    form: a fixed number of tensor ops whatever the frame count.

    score: (F, B) stage-0 event posteriors.  Per frame, as the reference's
    loop (``cascade_wake_scan_loop``): a score at or above
    ``wake_threshold`` wakes the slot; an awake slot whose score stays at
    or above ``sleep_threshold`` holds, its hangover refreshed to
    ``hangover_frames``; otherwise it stays awake while the hangover of
    the frame before is positive.

    Why the closed form holds (for the states the machine reaches, i.e.
    hang == 0 when asleep and hang <= hangover_frames; W >= S, which the
    session enforces, so every wake frame scores >= S).  Call a frame
    that scores >= S a keep frame and a frame that refreshes a refresh.
    Awake at t ⟺ t − (last refresh ≤ t) ≤ HF.  The carried (awake, hang)
    acts as a refresh-and-wake at the virtual frame hang − 1 − HF.  A
    keep frame refreshes iff it wakes or the frame before is awake.  Cut
    the keep frames into chains wherever two follow each other more than
    HF + 1 frames apart: inside a chain every keep frame from the chain's
    first wake on refreshes (the one before it was a refresh at most
    HF + 1 frames back), and none before it does (the last chain's
    refreshes lie more than HF + 1 frames back).  So with p_t the last
    keep frame ≤ t, c_t the start of its chain and w_t the last wake
    frame ≤ t (the virtual frame counting as all three):

        awake_t = (t − p_t ≤ HF) AND (w_t ≥ c_t)

    and the carried hang' is max(HF − (F − 1 − r), 0) for the last frame
    r that keeps and is awake (a refresh), else max(hang − F, 0).

    Returns ``(awake_trace (F, B) bool, awake' (B,), hang' (B,) int32)``.
    """
    F = score.shape[0]
    if F == 0:
        return (torch.zeros((0,) + tuple(awake.shape), dtype=torch.bool,
                            device=awake.device), awake, hang)
    HF = int(cfg.hangover_frames)
    t = torch.arange(F, dtype=torch.int32, device=score.device)[:, None]
    keep = score >= cfg.sleep_threshold               # NaN: neither
    wake = score >= cfg.wake_threshold
    virtual = torch.where(awake, hang.to(torch.int32) - (1 + HF), _NEVER)

    def last(mask):                # the last frame <= t in mask, or virtual
        return torch.maximum(
            torch.cummax(torch.where(mask, t, _NEVER), dim=0).values,
            virtual)

    p = last(keep)
    before = torch.cat([virtual[None], p[:-1]])      # the keep frame before
    start = keep & (t - before > HF + 1)
    trace = (t - p <= HF) & (last(wake) >= last(start))
    r = torch.where(keep & trace, t, _NEVER).amax(dim=0)
    hang = torch.where(r > _NEVER, (r + (HF + 1 - F)).clamp(min=0),
                       (hang.to(torch.int32) - F).clamp(min=0))
    return trace, trace[-1], hang.to(torch.int32)


def cascade_wake_scan_loop(cfg: CascadeConfig, awake, hang, score):
    """The reference's frame-by-frame wake machine (``repro/launch/
    streaming.py::cascade_wake_scan``'s ``lax.scan``), ~6 launches a
    frame; ``cascade_wake_scan`` must equal it bit for bit.  Same
    arguments and returns."""
    trace = []
    hang = hang.to(torch.int32)
    for s in score:
        wake = s >= cfg.wake_threshold
        hold = awake & (s >= cfg.sleep_threshold)
        awake = wake | hold | (awake & (hang > 0))
        hang = torch.where(wake | hold, cfg.hangover_frames,
                           (hang - 1).clamp(min=0)).to(torch.int32)
        trace.append(awake)
    if not trace:
        return (torch.zeros((0,) + tuple(awake.shape), dtype=torch.bool,
                            device=awake.device), awake, hang)
    return torch.stack(trace), awake, hang


# --------------------------------------------------------- health bitmask --
# Per-slot health flags computed inside the serving step (pure reads of
# the carried state).  The bits keep the reference's values.
HEALTH_INPUT = 1 << 0      # non-finite samples entered this chunk
HEALTH_FEX = 1 << 1        # biquad registers non-finite / blown up
HEALTH_GRU = 1 << 2        # ΔGRU x̂/ĥ/M/h non-finite / x̂ off-grid (int)
HEALTH_DET = 1 << 3        # detector EMA non-finite or outside [0, 1]
HEALTH_VAD = 1 << 4        # VAD hold register non-finite
HEALTH_SAT = 1 << 5        # int accumulator at the 24-bit saturation rail
HEALTH_REASONS = {
    HEALTH_INPUT: "input_nonfinite",
    HEALTH_FEX: "fex_state",
    HEALTH_GRU: "gru_state",
    HEALTH_DET: "detector_state",
    HEALTH_VAD: "vad_state",
    HEALTH_SAT: "accumulator_saturation",
}
# Default quarantine set: every unrecoverable-state bit.  HEALTH_SAT is
# left out: a saturating accumulator recovers once the input calms down,
# so it is counted (``StreamSummary.sat_events``), not healed.
QUARANTINE_DEFAULT = (HEALTH_INPUT | HEALTH_FEX | HEALTH_GRU
                      | HEALTH_DET | HEALTH_VAD)
_FEX_MAG_BOUND = 1e6       # float biquad register blow-up bound
_INT16_RAIL = 32767        # int16 register saturation rail
_FEAT_CODE_BOUND = 1 << 12  # 12-bit feature grid + 1 bit of slack
_ACC_RAIL = (1 << 23) - 1  # 24-bit saturating accumulator rail


def _slot_any(bad: torch.Tensor) -> torch.Tensor:
    """(B, ...) bool → per-slot (B,) any-reduction."""
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def _flag(bit: int, bad: torch.Tensor) -> torch.Tensor:
    return bad.to(torch.int32) * bit


def slot_health(input_bad, fex_state: FExState | None,
                gru_state: dg.DeltaState | None,
                vad_state: VADState | None = None,
                det_state: DetectorState | None = None) -> torch.Tensor:
    """Fuse the per-slot health predicates into one (B,) int32 bitmask:
    the pre-quantizer non-finite-input flag, then the state predicates.
    Float state: FEx registers non-finite or above ``_FEX_MAG_BOUND``,
    ΔGRU state non-finite.  Integer state cannot go non-finite, so the
    int8 engine checks rails instead: FEx registers at the int16 rail
    (``HEALTH_FEX``), x̂ off the 12-bit feature grid (``HEALTH_GRU``) and
    an accumulator at the 24-bit rail (``HEALTH_SAT``, telemetry: a
    saturating accumulator is the fixed-point design working).  Detect
    mode adds a non-finite float VAD hold (``HEALTH_VAD``) and a detector
    EMA that is non-finite or outside [0, 1] (``HEALTH_DET``)."""
    flags = _flag(HEALTH_INPUT, input_bad)
    if fex_state is not None:
        if fex_state.filt.is_floating_point():
            bad = _slot_any(~torch.isfinite(fex_state.filt)
                            | (torch.abs(fex_state.filt) > _FEX_MAG_BOUND))
            bad |= _slot_any(~torch.isfinite(fex_state.env))
        else:
            bad = _slot_any(torch.abs(fex_state.filt.to(torch.int32))
                            >= _INT16_RAIL)
            bad |= _slot_any(torch.abs(fex_state.env.to(torch.int32))
                             >= _INT16_RAIL)
        flags |= _flag(HEALTH_FEX, bad)
    if gru_state is not None:
        if gru_state.h.is_floating_point():
            bad = _slot_any(~torch.isfinite(gru_state.h))
            for leaf in (gru_state.x_hat, gru_state.h_hat, gru_state.m_x,
                         gru_state.m_h):
                bad |= _slot_any(~torch.isfinite(leaf))
            flags |= _flag(HEALTH_GRU, bad)
        else:
            x32 = gru_state.x_hat.to(torch.int32)
            flags |= _flag(HEALTH_GRU,
                           _slot_any(torch.abs(x32) > _FEAT_CODE_BOUND))
            sat = _slot_any(torch.abs(gru_state.m_x) >= _ACC_RAIL)
            sat |= _slot_any(torch.abs(gru_state.m_h) >= _ACC_RAIL)
            flags |= _flag(HEALTH_SAT, sat)
    if vad_state is not None:
        flags |= _flag(HEALTH_VAD, vad_state_flags(vad_state))
    if det_state is not None:
        flags |= _flag(HEALTH_DET, detector_state_flags(det_state))
    return flags


class SupervisorConfig(NamedTuple):
    """Host-side self-healing policy.

    check_every: chunks between health-mask fetches (each fetch is one
      (batch,) int32 copy that waits for its step; 1 checks after every
      chunk).
    quarantine_after: consecutive flagged checks before a slot is reset
      (1 = immediate; raise it to ride out transient flags).
    quarantine_mask: which HEALTH_* bits trigger a reset (default: every
      poisoned-state bit; saturation stays telemetry only).
    """

    check_every: int = 1
    quarantine_after: int = 1
    quarantine_mask: int = QUARANTINE_DEFAULT


# ------------------------------------------------------ host → device --
def _upload(arr: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """``arr`` as a tensor on ``device``.

    A copy from pageable memory, or with non_blocking=False, makes
    PyTorch wait for every earlier operation of the stream: the host
    could never run ahead of the card.  On CUDA the array is therefore
    copied once into pinned memory from PyTorch's caching host allocator
    and sent with ``non_blocking=True``; the allocator reuses that block
    only after the copies recorded on it have completed, so the host
    never waits for the stream.  On the CPU it is a plain copy.
    """
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, order="C"))       # a copy
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    np.copyto(host.numpy(), arr)          # one copy, from a strided view too
    return host.to(device, non_blocking=True)


# ------------------------------------------------------ exact telemetry --
# Counters are int64 scalars on the device.  They saturate at the
# capacity of the reference's split int32 counters (hi < 2^31 - 8 carries
# of 2^30), so ``overflowed`` keeps its meaning: a counter hit its rail.
_COUNT_SAT = ((1 << 31) - 8) << 30


class _Accum(NamedTuple):
    """Device-resident telemetry accumulated across chunks, summed over
    all streams of the batch."""

    macs: torch.Tensor         # ΔGRU MACs actually executed
    macs_dense: torch.Tensor   # dense-equivalent MACs
    frames: torch.Tensor       # decisions made
    fex_samples: torch.Tensor  # raw audio samples through the FEx
    vad_open: torch.Tensor     # frame-slots the VAD gate was open
                               #   (== frames when no VAD is gating)
    s0_macs: torch.Tensor      # stage-0 ΔGRU MACs executed (cascade)
    awake: torch.Tensor        # frame-slots stage 1 ran (cascade;
                               #   == frames without a cascade)


def _zero_accum(device) -> _Accum:
    return _Accum(*[torch.zeros((), dtype=torch.int64, device=device)
                    for _ in _Accum._fields])


def _count_add(c: torch.Tensor, d) -> torch.Tensor:
    return torch.clamp(c + d, max=_COUNT_SAT)


@dataclasses.dataclass
class StreamSummary:
    frames: int            # decisions made = frames × streams
    chunks: int
    sparsity: float
    energy_nj_per_decision: float
    latency_ms: float
    dense_energy_nj: float
    fex_samples: int = 0
    fex_energy_nj_per_decision: float = 0.0
    vad_duty: float = 1.0                  # gate-open fraction of frames
    vad_energy_nj_per_decision: float = 0.0
    stage1_duty: float = 1.0               # stage-1 awake fraction (cascade)
    s0_energy_nj_per_decision: float = 0.0  # always-on stage-0 cost
    frames_entered_stage1: int = 0         # frame-slots stage 1 executed
    overflowed: bool = False               # any telemetry counter saturated
    recoveries: int = 0                    # slots auto-reset by supervisor
    recovery_reasons: dict = dataclasses.field(default_factory=dict)
    sat_events: int = 0                    # HEALTH_SAT slot-checks observed
    # Serve-loop timing attached by the serve loops (``launch.engine``).
    slo: dict = dataclasses.field(default_factory=dict)


def _fc(hs, w, b):
    """``hs @ w + b`` summed in one fixed order per output, whatever the
    number of rows: the products, then a pairwise tree over the hidden
    axis (elementwise adds), then the bias.  cuBLAS picks its algorithm,
    and with it the order of a dot product's sum, by the row count
    (frames × streams), so a product over one shard's streams rounded
    otherwise than the same rows of the whole batch (H100, float32,
    ``chip_smoke.py`` phase 12); an elementwise op rounds each output on
    its own, on the card and on the CPU alike."""
    p = hs.unsqueeze(-1) * w                      # (..., H, K)
    while p.shape[-2] > 1:
        half = p.shape[-2] // 2
        top = p[..., :half, :] + p[..., half:2 * half, :]
        p = (top if p.shape[-2] % 2 == 0
             else torch.cat([top, p[..., 2 * half:, :]], dim=-2))
    return p.squeeze(-2) + b


def _classify(w_fc, b_fc, hs, stats):
    logits = _fc(hs, w_fc, b_fc)                  # (F, B, K)
    votes = torch.argmax(logits, -1).to(torch.int32)
    return ChunkResult(logits=logits, votes=votes,
                       nz=stats.nz_dx + stats.nz_dh)


def _bump(acc: _Accum, stats, n_frames: int, n_samples: int,
          vad_open=None, awake=None, s0_macs=0) -> _Accum:
    """Accumulate one chunk's telemetry (int64 sums, no host sync).
    ``vad_open`` is the device count of gate-open frame-slots (detect
    mode); ungated paths count every frame as open (duty 1.0).
    ``awake`` / ``s0_macs`` are the cascade's stage-1 frame-slots and
    stage-0 MACs; without a cascade every frame counts as awake (duty
    1.0) and stage 0 as idle."""
    return _Accum(
        macs=_count_add(acc.macs, stats.macs.sum(dtype=torch.int64)),
        macs_dense=_count_add(acc.macs_dense,
                              stats.macs_dense.sum(dtype=torch.int64)),
        frames=_count_add(acc.frames, n_frames),
        fex_samples=_count_add(acc.fex_samples, n_samples),
        vad_open=_count_add(acc.vad_open,
                            n_frames if vad_open is None else vad_open),
        s0_macs=_count_add(acc.s0_macs, s0_macs),
        awake=_count_add(acc.awake, n_frames if awake is None else awake),
    )


def _feats_bad(feats) -> torch.Tensor:
    """(F, B, C) frame-major features → per-slot (B,) non-finite flag."""
    return (~torch.isfinite(feats)).any(dim=2).any(dim=0)


def _process_chunk(gru: dg.DeltaGRUParams, w_fc, b_fc, state: dg.DeltaState,
                   acc: _Accum, feats, *, threshold: float,
                   gru_knobs: dict | None = None):
    """Chunk step on features:
    (state, acc, feats (F,B,C)) -> (state', acc', out, health).
    ``gru_knobs``: the ΔGRU kernel's launch knobs (the session's tuned
    configuration; the default launch without it, no cache read)."""
    in_bad = _feats_bad(feats)
    hs, state, stats = dg.delta_gru_scan(gru, feats.contiguous(), threshold,
                                         state, backend="pallas",
                                         consult_cache=False,
                                         **(gru_knobs or {}))
    out = _classify(w_fc, b_fc, hs, stats)
    health = slot_health(in_bad, None, state)
    return (state, _bump(acc, stats, feats.shape[0] * feats.shape[1], 0),
            out, health)


def _process_audio_chunk(gru: dg.DeltaGRUParams, w_fc, b_fc, coef,
                         fex_state: FExState, state: dg.DeltaState,
                         acc: _Accum, audio, *, threshold: float,
                         frame_shift: int, env_alpha: float, log_eps: float,
                         fex_knobs: dict | None = None,
                         gru_knobs: dict | None = None):
    """Audio→decision step: FEx kernel → ΔGRU kernel → FC.

    audio: (B, S) raw samples on the device, S a multiple of frame_shift.
    ``fex_knobs`` / ``gru_knobs``: the kernels' launch knobs (the
    session's tuned configurations; the default launches without them,
    and no step reads the autotune cache).  Returns (fex_state', state',
    acc', ChunkResult, health), all on the device.
    """
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    feats, fex_state = fex_scan(
        audio, coef, fex_state, frame_shift=frame_shift,
        env_alpha=env_alpha, log_eps=log_eps, compress=True,
        backend="pallas", consult_cache=False, **(fex_knobs or {}))
    xs = feats.movedim(1, 0).contiguous()            # (F, B, C)
    hs, state, stats = dg.delta_gru_scan(gru, xs, threshold, state,
                                         backend="pallas",
                                         consult_cache=False,
                                         **(gru_knobs or {}))
    out = _classify(w_fc, b_fc, hs, stats)
    decisions = xs.shape[0] * xs.shape[1]            # frames × streams
    acc = _bump(acc, stats, decisions, decisions * frame_shift)
    health = slot_health(in_bad, fex_state, state)
    return fex_state, state, acc, out, health


def _classify_int(w_fc, b_fc, hs_codes, stats, logit_frac: int):
    """FC + argmax on integer codes: the decision is the argmax over the
    int32 logit codes (bit-true); the dequantized logits fill the
    float-typed ``ChunkResult.logits``."""
    codes = fp.int_fc(hs_codes, w_fc, b_fc)           # (F, B, K) int32
    votes = torch.argmax(codes, -1).to(torch.int32)
    return ChunkResult(logits=fp.from_code(codes, logit_frac), votes=votes,
                       nz=stats.nz_dx + stats.nz_dh)


def _process_chunk_int(gru: fp.IntGruWeights, w_fc, b_fc,
                       state: dg.DeltaState, acc: _Accum, feats, *,
                       threshold: float, gfmt: fp.GruFormats,
                       gru_knobs: dict | None = None):
    """Integer mirror of ``_process_chunk``: feats (F, B, C) floats on the
    12-bit grid → codes → int ΔGRU kernel → int FC.  ``state`` carries
    int16/int32 codes."""
    in_bad = _feats_bad(feats)
    xs = fp.to_code(feats, gfmt.feat_frac, 16, torch.int16).contiguous()
    hs, state, nz_dx, nz_dh = fp.int_gru_scan(gru, gfmt, xs, threshold,
                                              state, backend="pallas",
                                              consult_cache=False,
                                              **(gru_knobs or {}))
    stats = dg._stats_from_counts(nz_dx, nz_dh, xs.shape[-1],
                                  gru.w_h.shape[0])
    out = _classify_int(w_fc, b_fc, hs, stats, gfmt.logit_frac)
    health = slot_health(in_bad, None, state)
    return (state, _bump(acc, stats, feats.shape[0] * feats.shape[1], 0),
            out, health)


def _process_audio_chunk_int(gru: fp.IntGruWeights, w_fc, b_fc, coef,
                             fex_state: FExState, state: dg.DeltaState,
                             acc: _Accum, audio, *, threshold: float,
                             frame_shift: int, gfmt: fp.GruFormats,
                             ffmt: fp.FexFormats,
                             fex_knobs: dict | None = None,
                             gru_knobs: dict | None = None):
    """The deployed INTEGER audio→decision step: 12-bit ADC codes → int
    FEx kernel → int ΔGRU kernel → int FC.  ``fex_state`` holds int16
    register codes, ``state`` int16/int32 ΔGRU codes; the knobs as in
    ``_process_audio_chunk``.  Returns (fex_state', state', acc',
    ChunkResult, health), all on the device.
    """
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    audio_codes = fp.to_code(audio, ffmt.feat_frac, 16, torch.int16)
    feats, fex_buf = fp.int_fex_scan(
        audio_codes.contiguous(), coef, _pack_state(fex_state), ffmt,
        frame_shift=frame_shift, backend="pallas", consult_cache=False,
        **(fex_knobs or {}))
    xs = feats.movedim(1, 0).contiguous()            # (F, B, C) codes
    hs, state, nz_dx, nz_dh = fp.int_gru_scan(gru, gfmt, xs, threshold,
                                              state, backend="pallas",
                                              consult_cache=False,
                                              **(gru_knobs or {}))
    stats = dg._stats_from_counts(nz_dx, nz_dh, xs.shape[-1],
                                  gru.w_h.shape[0])
    out = _classify_int(w_fc, b_fc, hs, stats, gfmt.logit_frac)
    decisions = xs.shape[0] * xs.shape[1]            # frames × streams
    acc = _bump(acc, stats, decisions, decisions * frame_shift)
    fex_state = _unpack_state(fex_buf)
    health = slot_health(in_bad, fex_state, state)
    return fex_state, state, acc, out, health


def _detect_tail(w_fc, b_fc, hs, stats, gate, *, logit_frac=None,
                 det_cfg: DetectorConfig, det_state: DetectorState,
                 awake=None):
    """Shared back half of the detect steps: FC → the detection head
    kernel (softmax → EMA → hysteresis events, one launch).
    ``logit_frac`` set = integer FC on hidden codes (the head consumes the
    dequantized, grid-exact logits).  ``awake`` (cascade sessions) masks
    events on asleep frames to -1 after the head, which still runs on
    every frame: a frozen stage 1 keeps emitting its held logits, and no
    keyword may fire while stage 0 says nothing is happening."""
    if logit_frac is None:
        cls = _classify(w_fc, b_fc, hs, stats)
    else:
        cls = _classify_int(w_fc, b_fc, hs, stats, logit_frac)
    det_state, events = detect_head(cls.logits, det_state, det_cfg)
    if awake is not None:
        events = torch.where(awake, events, NO_EVENT)
    return det_state, DetectResult(logits=cls.logits, votes=cls.votes,
                                   nz=cls.nz, events=events, gate=gate,
                                   awake=awake)


def _process_audio_chunk_detect(gru: dg.DeltaGRUParams, w_fc, b_fc, coef,
                                fex_state: FExState, state: dg.DeltaState,
                                vad_state: VADState,
                                det_state: DetectorState, acc: _Accum,
                                audio, *, threshold: float, frame_shift: int,
                                env_alpha: float, log_eps: float,
                                vad_cfg: VADConfig, det_cfg: DetectorConfig,
                                fex_knobs: dict | None = None,
                                gru_knobs: dict | None = None):
    """Always-on detection step: audio → FEx kernel → VAD gate → ΔGRU
    kernel → FC → detection head kernel.  The VAD clamps the delta path
    by sample-and-holding the features during silence (Δx = 0 exactly).
    Returns (fex_state', state', vad_state', det_state', acc',
    DetectResult, health), all on the device."""
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    energy = frame_energy(audio, frame_shift)        # (F, B)
    feats, fex_state = fex_scan(
        audio, coef, fex_state, frame_shift=frame_shift,
        env_alpha=env_alpha, log_eps=log_eps, compress=True,
        backend="pallas", consult_cache=False, **(fex_knobs or {}))
    xs = feats.movedim(1, 0)                         # (F, B, C)
    xs, gate, vad_state = vad_gate(xs, energy, vad_state, vad_cfg)
    hs, state, stats = dg.delta_gru_scan(gru, xs.contiguous(), threshold,
                                         state, backend="pallas",
                                         consult_cache=False,
                                         **(gru_knobs or {}))
    det_state, out = _detect_tail(w_fc, b_fc, hs, stats, gate,
                                  det_cfg=det_cfg, det_state=det_state)
    decisions = xs.shape[0] * xs.shape[1]
    acc = _bump(acc, stats, decisions, decisions * frame_shift,
                vad_open=gate.sum(dtype=torch.int64))
    health = slot_health(in_bad, fex_state, state, vad_state, det_state)
    return fex_state, state, vad_state, det_state, acc, out, health


def _process_audio_chunk_detect_int(gru: fp.IntGruWeights, w_fc, b_fc, coef,
                                    fex_state: FExState,
                                    state: dg.DeltaState,
                                    vad_state: VADState,
                                    det_state: DetectorState, acc: _Accum,
                                    audio, *, threshold: float,
                                    frame_shift: int, gfmt: fp.GruFormats,
                                    ffmt: fp.FexFormats, vad_cfg: VADConfig,
                                    det_cfg: DetectorConfig,
                                    fex_knobs: dict | None = None,
                                    gru_knobs: dict | None = None):
    """Integer mirror of ``_process_audio_chunk_detect``: the VAD holds
    int16 feature codes (a held code stream is a zero integer delta) and
    gates on the energy of the float 12-bit audio, before the codes; the
    head smooths posteriors of the dequantized int32 logit codes."""
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    energy = frame_energy(audio, frame_shift)        # float, pre-codes
    audio_codes = fp.to_code(audio, ffmt.feat_frac, 16, torch.int16)
    feats, fex_buf = fp.int_fex_scan(
        audio_codes.contiguous(), coef, _pack_state(fex_state), ffmt,
        frame_shift=frame_shift, backend="pallas", consult_cache=False,
        **(fex_knobs or {}))
    xs = feats.movedim(1, 0)                         # (F, B, C) codes
    xs, gate, vad_state = vad_gate(xs, energy, vad_state, vad_cfg)
    hs, state, nz_dx, nz_dh = fp.int_gru_scan(gru, gfmt, xs.contiguous(),
                                              threshold, state,
                                              backend="pallas",
                                              consult_cache=False,
                                              **(gru_knobs or {}))
    stats = dg._stats_from_counts(nz_dx, nz_dh, xs.shape[-1],
                                  gru.w_h.shape[0])
    det_state, out = _detect_tail(w_fc, b_fc, hs, stats, gate,
                                  logit_frac=gfmt.logit_frac,
                                  det_cfg=det_cfg, det_state=det_state)
    decisions = xs.shape[0] * xs.shape[1]
    acc = _bump(acc, stats, decisions, decisions * frame_shift,
                vad_open=gate.sum(dtype=torch.int64))
    fex_state = _unpack_state(fex_buf)
    health = slot_health(in_bad, fex_state, state, vad_state, det_state)
    return fex_state, state, vad_state, det_state, acc, out, health


def _process_audio_chunk_cascade(gru: dg.DeltaGRUParams, w_fc, b_fc,
                                 gru0: dg.DeltaGRUParams, w_fc0, b_fc0,
                                 coef, fex_state: FExState,
                                 state: dg.DeltaState,
                                 cas_state: CascadeState,
                                 vad_state: VADState,
                                 det_state: DetectorState, acc: _Accum,
                                 audio, *, threshold: float,
                                 frame_shift: int, env_alpha: float,
                                 log_eps: float, vad_cfg: VADConfig,
                                 det_cfg: DetectorConfig,
                                 cas_cfg: CascadeConfig,
                                 fex_knobs: dict | None = None,
                                 gru0_knobs: dict | None = None):
    """Two-stage cascade step: audio → FEx kernel → VAD gate → stage-0
    micro-ΔGRU (``delta_gru_seq`` on the leading channels) → FC → the
    wake head kernel (stage 0's posterior → wake machine) → stage-1 ΔGRU
    on the awake frames only (the masked ``delta_gru_seq``)
    → FC → detection head kernel, events masked on asleep frames.
    Returns (fex_state', state', cas_state', vad_state', det_state',
    acc', DetectResult, health), all on the device."""
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    energy = frame_energy(audio, frame_shift)        # (F, B)
    feats, fex_state = fex_scan(
        audio, coef, fex_state, frame_shift=frame_shift,
        env_alpha=env_alpha, log_eps=log_eps, compress=True,
        backend="pallas", consult_cache=False, **(fex_knobs or {}))
    xs = feats.movedim(1, 0)                         # (F, B, C)
    xs, gate, vad_state = vad_gate(xs, energy, vad_state, vad_cfg)
    # Stage 0: always on, the leading channels, its own Δ_TH.  (Stage 1
    # runs the masked instantiation, which takes no knob.)
    xs0 = xs[..., :cas_cfg.s0_channels].contiguous()
    hs0, s0_state, stats0 = dg.delta_gru_scan(
        gru0, xs0, cas_cfg.s0_threshold, cas_state.s0, backend="pallas",
        consult_cache=False, **(gru0_knobs or {}))
    awake_t, awake, hang = wake_head(_fc(hs0, w_fc0, b_fc0), cas_state.awake,
                                     cas_state.hang, cas_cfg)
    hs, state, stats = dg.masked_delta_gru_scan(gru, xs.contiguous(),
                                                threshold, state, awake_t)
    det_state, out = _detect_tail(w_fc, b_fc, hs, stats, gate,
                                  det_cfg=det_cfg, det_state=det_state,
                                  awake=awake_t)
    decisions = xs.shape[0] * xs.shape[1]
    acc = _bump(acc, stats, decisions, decisions * frame_shift,
                vad_open=gate.sum(dtype=torch.int64),
                awake=awake_t.sum(dtype=torch.int64),
                s0_macs=stats0.macs.sum(dtype=torch.int64))
    health = slot_health(in_bad, fex_state, state, vad_state, det_state)
    health |= slot_health(torch.zeros_like(in_bad), None, s0_state)
    return (fex_state, state, CascadeState(awake, hang, s0_state),
            vad_state, det_state, acc, out, health)


def _process_audio_chunk_cascade_int(gru: fp.IntGruWeights, w_fc, b_fc,
                                     gru0: fp.IntGruWeights, w_fc0, b_fc0,
                                     coef, fex_state: FExState,
                                     state: dg.DeltaState,
                                     cas_state: CascadeState,
                                     vad_state: VADState,
                                     det_state: DetectorState, acc: _Accum,
                                     audio, *, threshold: float,
                                     frame_shift: int, gfmt: fp.GruFormats,
                                     ffmt: fp.FexFormats,
                                     gfmt0: fp.GruFormats,
                                     vad_cfg: VADConfig,
                                     det_cfg: DetectorConfig,
                                     cas_cfg: CascadeConfig,
                                     fex_knobs: dict | None = None,
                                     gru0_knobs: dict | None = None):
    """Integer mirror of ``_process_audio_chunk_cascade``: both stages on
    the deployed code-domain datapath (stage 0 through its own promoted
    formats ``gfmt0``), the wake head on stage 0's dequantized
    (grid-exact) logits, and asleep slots' integer stage-1
    state frozen bit for bit (the masked ``delta_gru_seq_int``)."""
    in_bad = ~torch.isfinite(audio).all(dim=1)       # pre-quantizer
    audio = quantize_audio_12b(audio.float())
    energy = frame_energy(audio, frame_shift)        # float, pre-codes
    audio_codes = fp.to_code(audio, ffmt.feat_frac, 16, torch.int16)
    feats, fex_buf = fp.int_fex_scan(
        audio_codes.contiguous(), coef, _pack_state(fex_state), ffmt,
        frame_shift=frame_shift, backend="pallas", consult_cache=False,
        **(fex_knobs or {}))
    xs = feats.movedim(1, 0)                         # (F, B, C) codes
    xs, gate, vad_state = vad_gate(xs, energy, vad_state, vad_cfg)
    xs0 = xs[..., :cas_cfg.s0_channels].contiguous()
    hs0, s0_state, nzx0, nzh0 = fp.int_gru_scan(
        gru0, gfmt0, xs0, cas_cfg.s0_threshold, cas_state.s0,
        backend="pallas", consult_cache=False, **(gru0_knobs or {}))
    logits0 = fp.from_code(fp.int_fc(hs0, w_fc0, b_fc0), gfmt0.logit_frac)
    awake_t, awake, hang = wake_head(logits0, cas_state.awake,
                                     cas_state.hang, cas_cfg)
    hs, state, nz_dx, nz_dh = fp.masked_int_gru_scan(
        gru, gfmt, xs.contiguous(), threshold, state, awake_t)
    stats = dg._stats_from_counts(nz_dx, nz_dh, xs.shape[-1],
                                  gru.w_h.shape[0])
    stats0 = dg._stats_from_counts(nzx0, nzh0, xs0.shape[-1],
                                   gru0.w_h.shape[0])
    det_state, out = _detect_tail(w_fc, b_fc, hs, stats, gate,
                                  logit_frac=gfmt.logit_frac,
                                  det_cfg=det_cfg, det_state=det_state,
                                  awake=awake_t)
    decisions = xs.shape[0] * xs.shape[1]
    acc = _bump(acc, stats, decisions, decisions * frame_shift,
                vad_open=gate.sum(dtype=torch.int64),
                awake=awake_t.sum(dtype=torch.int64),
                s0_macs=stats0.macs.sum(dtype=torch.int64))
    fex_state = _unpack_state(fex_buf)
    health = slot_health(in_bad, fex_state, state, vad_state, det_state)
    health |= slot_health(torch.zeros_like(in_bad), None, s0_state)
    return (fex_state, state, CascadeState(awake, hang, s0_state),
            vad_state, det_state, acc, out, health)


def _reset_gru_slots(state: dg.DeltaState, bias, mask) -> dg.DeltaState:
    """Fresh-stream ΔGRU state for every slot where ``mask`` is True: one
    mask-select per field resets a whole admission wave.  Dtype-
    preserving: float state, or the int8 engine's int16/int32 codes."""
    m = mask[:, None]

    def zero(t):
        return torch.where(m, torch.zeros((), dtype=t.dtype,
                                          device=t.device), t)

    return dg.DeltaState(
        h=zero(state.h), x_hat=zero(state.x_hat), h_hat=zero(state.h_hat),
        m_x=torch.where(m, bias.to(state.m_x.dtype), state.m_x),
        m_h=zero(state.m_h))


def _reset_fex_slots(state: FExState, mask) -> FExState:
    """Quiescent filters for every slot where ``mask`` is True (dtype-
    preserving: float registers or int16 codes)."""
    zero = torch.zeros((), dtype=state.filt.dtype, device=state.filt.device)
    return FExState(filt=torch.where(mask[:, None, None], zero, state.filt),
                    env=torch.where(mask[:, None], zero, state.env))


def _reset_vad_slots(state: VADState, mask) -> VADState:
    """Fresh-stream VAD state for masked slots: zero hold (matches
    x̂ = 0), no hangover.  Dtype-preserving (int16 code hold in the int8
    engine)."""
    zero = torch.zeros((), dtype=state.hold.dtype, device=state.hold.device)
    return VADState(hold=torch.where(mask[:, None], zero, state.hold),
                    hang=torch.where(mask, torch.zeros_like(state.hang),
                                     state.hang))


def _reset_det_slots(state: DetectorState, mask) -> DetectorState:
    """Idle detector for masked slots: zero smoothed posteriors, no open
    event, no refractory — a fresh stream's head."""
    return DetectorState(
        smooth=torch.where(mask[:, None], torch.zeros_like(state.smooth),
                           state.smooth),
        active=torch.where(mask, torch.full_like(state.active, NO_EVENT),
                           state.active),
        refract=torch.where(mask, torch.zeros_like(state.refract),
                            state.refract))


def _reset_cascade_slots(state: CascadeState, bias0, mask) -> CascadeState:
    """Fresh cascade state for masked slots: asleep, no hangover, stage-0
    state zeroed with its M seeded at the stage-0 bias."""
    return CascadeState(
        awake=torch.where(mask, False, state.awake),
        hang=torch.where(mask, torch.zeros_like(state.hang), state.hang),
        s0=_reset_gru_slots(state.s0, bias0, mask))


class StreamingKwsSession:
    """Carries FEx + ΔGRU state and telemetry on the device across chunks.

    Args:
      params: the KWS parameter dict (``models.kws.init_kws`` or
        ``models.kws.params_from_numpy``).
      cfg: an ``ArchConfig`` (``d_model`` = GRU width).
      threshold: Δ_TH override (default ``cfg.delta_threshold``).
      batch: number of parallel streams (slots) sharing the session.
      input_dim: feature channels per frame (default: from the FEx, or
        from the first feature chunk).
      fex: a ``FeatureExtractor`` (or ``FExConfig``) for raw-audio chunks;
        default-constructed on first use.
      device: where the session runs.  ``None`` = CUDA; raises when CUDA
        is missing.  ``"cpu"`` runs the kernels' plain versions.
      numerics: "float32" (default) or "int8" — the deployed integer
        datapath: 12-bit ADC → integer FEx → int8-weight/int16-state ΔGRU
        → integer FC, bit-true against the golden fixed-point model
        (``core.fixed_point``).  All stream state is carried as integer
        codes; decisions are argmaxes over int32 logit codes.
      bundle: a promoted ``IntKwsBundle`` (``train.promote``; a bundle
        the JAX package saved loads with ``load_bundle``) to serve.  With
        a bundle, ``params`` may be None and the bundle's Δ_TH is
        authoritative; without one (numerics="int8"), ``params`` is
        promoted at session creation.
      detector: a ``models.detector.DetectorConfig`` switching the
        session into always-on DETECTION mode: ``process_audio`` runs
        audio → FEx → VAD gate → ΔGRU → FC → the detection head kernel and
        returns ``DetectResult`` (per-frame fired events and the gate
        trace).  Detector state is per slot, on the device, and reset by
        ``reset_streams`` like every other stream state.
      vad: a ``frontend.vad.VADConfig`` for the energy gate that clamps
        the ΔGRU's delta path during silence (detect mode only; default
        ``VADConfig()``; ``vad=VAD_OFF`` disables gating and keeps the
        head).
      cascade: a ``CascadeConfig`` turning the detector into the two-stage
        wake cascade: an always-on stage-0 micro-ΔGRU on the leading
        ``cascade.s0_channels`` features scores every frame, and stage 1
        runs only on the frames the wake machine keeps awake (asleep
        slots keep their whole stage-1 state bit-frozen and execute no
        stage-1 MAC).  Needs ``detector`` and ``stage0_params``.  Per-stage
        energy is priced by ``core.energy_model.cascade_frame_cost`` in
        ``summary()``.
      stage0_params: the stage-0 model's parameter dict (``init_kws`` with
        ``vocab_size=2`` and the reduced width and input); under
        ``numerics="int8"`` it gets its own promotion at session creation.
      mesh: a ``launch.mesh.SlotMesh`` (``make_slot_mesh(n)`` over n cards,
        or ``SlotMesh.on(device, n)``) turning the session into a sharded
        engine: shard i owns the contiguous block of slots
        [i·B/n, (i+1)·B/n), all its per-stream state lives on its device,
        its step runs there on its own CUDA stream, the weights are
        replicated once per device, the results are joined on the slot
        axis on the mesh's first device (the session's ``device``), and
        telemetry is summed on the host only in ``summary()``.  ``batch``
        must divide by the mesh size; a one-shard mesh is the unsharded
        session.  Every output bit equals the unsharded session's.
      supervisor: a ``SupervisorConfig`` enabling the self-healing
        supervisor: the per-slot health mask the step emits is fetched
        every ``check_every`` chunks, and slots whose quarantine-mask bits
        stay set for ``quarantine_after`` consecutive checks are reset to
        fresh-stream state (``reset_streams``); recoveries and their
        reasons surface in ``StreamSummary``.  ``None`` (default): the
        flags are still computed, nobody reads them, and ``process_audio``
        never waits for the card.
      input_policy: what ``process_audio`` does with hostile samples —
        "reject" (default) raises ``StreamInputError`` on non-finite
        samples, "sanitize" squashes NaN to silence and clamps ±Inf to
        the 12-bit rails, "trust" forwards them untouched.  Un-decodable
        dtypes and out-of-range integer codes always reject.
    """

    def __init__(self, params, cfg, *, threshold: float | None = None,
                 batch: int = 1, input_dim: int | None = None,
                 fex: FeatureExtractor | FExConfig | None = None,
                 device=None, mesh=None, numerics: str = "float32",
                 bundle: fp.IntKwsBundle | None = None,
                 detector: DetectorConfig | None = None,
                 vad: VADConfig | None = None,
                 cascade: CascadeConfig | None = None, stage0_params=None,
                 supervisor=None, input_policy: str = "reject"):
        if mesh is not None and not isinstance(mesh, SlotMesh):
            raise TypeError(f"mesh must be a launch.mesh.SlotMesh "
                            f"(make_slot_mesh or SlotMesh.on), got "
                            f"{type(mesh).__name__}")
        if numerics not in ("float32", "int8"):
            raise ValueError(f"unknown numerics: {numerics!r}")
        if vad is not None and detector is None:
            raise ValueError("vad gating is part of detection mode: pass "
                             "a DetectorConfig alongside the VADConfig")
        if detector is not None and band_inverted(detector):
            raise ValueError(
                f"inverted hysteresis band: release_threshold "
                f"({detector.release_threshold}) must be <= fire_threshold "
                f"({detector.fire_threshold}) elementwise — an inverted "
                f"band degrades the head into a refractory-paced pulse "
                f"generator")
        if cascade is not None:
            if detector is None:
                raise ValueError("the wake cascade gates the always-on "
                                 "pipeline: pass a DetectorConfig "
                                 "alongside the CascadeConfig")
            if stage0_params is None:
                raise ValueError("cascade mode needs the stage-0 micro "
                                 "model: pass stage0_params")
            if cascade.sleep_threshold > cascade.wake_threshold:
                raise ValueError(
                    f"inverted wake hysteresis: sleep_threshold "
                    f"({cascade.sleep_threshold}) must be <= "
                    f"wake_threshold ({cascade.wake_threshold})")
            if cascade.hangover_frames < 0:
                raise ValueError("hangover_frames must be >= 0")
            s0_in = int(stage0_params["w_x"].shape[0])
            if s0_in != cascade.s0_channels:
                raise ValueError(
                    f"stage-0 model consumes {s0_in} channels but "
                    f"cascade.s0_channels={cascade.s0_channels}")
        if input_policy not in ("reject", "sanitize", "trust"):
            raise ValueError(f"unknown input_policy: {input_policy!r} "
                             f"(choose reject / sanitize / trust)")
        self.n_shards = check_slot_partition(mesh, batch)
        self.mesh = mesh if self.n_shards > 1 else None
        if mesh is not None:
            devs = [resolve_device(d) for d in mesh.devices]
            if device is not None and resolve_device(device) != devs[0]:
                raise ValueError(f"device={device} is not the mesh's first "
                                 f"device {devs[0]}: a sharded session "
                                 f"joins its results there")
            self.device = devs[0]
        else:
            self.device = resolve_device(device)
        self._detector = detector
        self._vad = ((vad if vad is not None else VADConfig())
                     if detector is not None else None)
        self.cfg = cfg
        self.batch = batch
        self._reps: list[dict] | None = (
            None if self.mesh is None else [{} for _ in range(self.n_shards)])
        self.threshold = float(cfg.delta_threshold if threshold is None
                               else threshold)
        self.input_policy = input_policy
        self._fex = (FeatureExtractor(fex) if isinstance(fex, FExConfig)
                     else fex)
        self.numerics = numerics
        self._bundle = bundle
        if numerics == "int8":
            if bundle is None:
                self._bundle = fp.promote_kws(params, self.threshold,
                                              fex=self._fex)
            self.threshold = float(self._bundle.threshold)
            self._replicate(("gru", "w_fc", "b_fc"),
                            self._bundle_weights(self._bundle))
        else:
            params = {k: v.to(self.device, torch.float32)
                      for k, v in params.items()}
            self._replicate(("gru", "w_fc", "b_fc"),
                            kws.serving_weights(params, mesh=self.mesh))
        self.n_classes = int(self._b_fc.shape[-1])
        self._cascade = cascade
        self._bundle0 = None
        if cascade is not None:
            if numerics == "int8":
                # Stage 0 gets its own promotion: its own formats from its
                # own weights' range (gfmt0 differs from gfmt).
                self._bundle0 = fp.promote_kws(stage0_params,
                                               cascade.s0_threshold)
                self._replicate(("gru0", "w_fc0", "b_fc0"),
                                self._bundle_weights(self._bundle0))
            else:
                self._replicate(
                    ("gru0", "w_fc0", "b_fc0"), kws.serving_weights(
                        {k: v.to(self.device, torch.float32)
                         for k, v in stage0_params.items()}, mesh=self.mesh))
            self._s0_hidden = int(self._gru0.w_h.shape[0])
            self._s0_classes = int(self._b_fc0.shape[-1])
        self._cas_state: CascadeState | None = None
        self._state: dg.DeltaState | None = None
        self._coef = None
        self._fex_state: FExState | None = None
        self._vad_state: VADState | None = None
        self._det_state: DetectorState | None = None
        self._audio_rem: np.ndarray | None = None   # carried tail samples
        self._acc = self._each(lambda i: _zero_accum(self._dev(i)))
        self._chunks = 0
        self._input_dim = input_dim
        self._last_health: torch.Tensor | None = None
        self.supervisor = supervisor
        self._strikes = np.zeros((batch,), np.int64)
        self._recoveries = 0
        self._recovery_reasons: dict[str, int] = {}
        self._sat_events = 0
        self._flagged: frozenset[int] = frozenset()
        self._slo: dict = {}
        self._tuning: dict = {}
        if input_dim is not None:
            self._init_state(input_dim)
        self._resolve_tuning()

    # ------------------------------------------------------ the slot mesh
    def _each(self, fn):
        """``fn(i)`` for every shard ``i`` on its device and stream, as a
        list with one entry per shard; ``fn(0)`` itself without a mesh."""
        if self.mesh is None:
            return fn(0)
        out = []
        for i in range(self.n_shards):
            with self.mesh.shard(i):
                out.append(fn(i))
        return out

    def _dev(self, i: int) -> torch.device:
        return self.device if self.mesh is None else self.mesh.device(i)

    def _w(self, i: int, name: str):
        """Shard ``i``'s replica of the weight ``name`` ("gru", "w_fc",
        "coef", ...)."""
        if self.mesh is None:
            return getattr(self, "_" + name)
        return self._reps[i][name]

    def _weights(self, *names) -> list:
        """The step's weight arguments: the tensors without a mesh, else
        one per-shard list per name."""
        if self.mesh is None:
            return [getattr(self, "_" + n) for n in names]
        return [[rep[n] for rep in self._reps] for n in names]

    def _replicate(self, names, weights):
        """Keep ``weights`` (a tuple of ``names``, or a per-shard list of
        such tuples on a mesh) as the session's attributes (the first
        shard's copy, read for shapes) and per-shard replicas."""
        if self.mesh is None:
            for n, w in zip(names, weights):
                setattr(self, "_" + n, w)
            return
        for rep, ws in zip(self._reps, weights):
            rep.update(zip(names, ws))
        for n in names:
            setattr(self, "_" + n, self._reps[0][n])

    def _bundle_weights(self, bundle):
        """An int8 bundle's ΔGRU and FC codes on the session's device, one
        copy per device of the mesh (``fp.bundle_to``)."""
        def codes(device):
            on_dev = fp.bundle_to(bundle, device)
            return on_dev.gru, on_dev.w_fc, on_dev.b_fc

        if self.mesh is None:
            return codes(self.device)
        return shp.replicate(codes, self.mesh)

    def _shard_ctx(self, i: int):
        return (contextlib.nullcontext() if self.mesh is None
                else self.mesh.shard(i))

    def _get(self, name: str, i: int):
        value = getattr(self, name)
        return value if self.mesh is None else value[i]

    def _put(self, name: str, i: int, value) -> None:
        if self.mesh is None:
            setattr(self, name, value)
        else:
            getattr(self, name)[i] = value

    def _joined(self, value):
        """A per-stream state as one tree of all slots: the value itself
        without a mesh, else the shards' blocks joined on the first
        device (``join_slots``; its stream waits on the shards' events)."""
        if self.mesh is None or value is None:
            return value
        return join_slots(self.mesh, value, axis=0)

    def shard_of_slot(self, i: int) -> int:
        """Which mesh shard owns global slot ``i`` (block partitioning)."""
        return i // (self.batch // self.n_shards)

    def _init_state(self, input_dim: int):
        self._input_dim = input_dim
        self._resolve_tuning()
        b = self.batch // self.n_shards
        if self.numerics == "int8":
            self._state = self._each(lambda i: fp.init_int_delta_state(
                b, input_dim, self.cfg.d_model, self._w(i, "gru")))
        else:
            self._state = self._each(lambda i: dg.init_delta_state(
                b, input_dim, self.cfg.d_model, self._w(i, "gru")))

    def _fresh_fex_state(self, n_channels: int) -> FExState:
        dtype = torch.int16 if self.numerics == "int8" else torch.float32
        b = self.batch // self.n_shards
        return self._each(lambda i: init_fex_state(b, n_channels,
                                                   self._dev(i), dtype))

    def _require_fex(self) -> FeatureExtractor:
        if self._fex is None:
            self._fex = FeatureExtractor()
        fcfg = self._fex.cfg
        if self._input_dim is None:
            self._init_state(fcfg.n_active)
        elif self._input_dim != fcfg.n_active:
            raise ValueError(f"FEx emits {fcfg.n_active} channels, session "
                             f"state is {self._input_dim}-wide")
        if self._fex_state is None:
            if self.numerics == "int8":
                # Fold the FEx bank into the bundle if the promotion had
                # none (fold_fex copies: a shared bundle is untouched).
                self._bundle = fp.fold_fex(self._bundle, self._fex)
                coef = self._bundle.coef.to(self.device)
            else:
                coef = self._fex.coef.to(self.device)
            self._replicate(("coef",), shp.put_replicated(
                (coef,), self.mesh))
            self._fex_state = self._fresh_fex_state(fcfg.n_active)
            self._audio_rem = np.zeros((self.batch, 0), np.float32)
            if self._detector is not None:
                self._vad_state = self._fresh_vad_state(fcfg.n_active)
                self._det_state = self._fresh_det_state()
            if self._cascade is not None:
                self._cas_state = self._fresh_cascade_state()
            self._resolve_tuning()
        return self._fex

    # ----------------------------------------------------- kernel tuning
    def _tuning_entries(self) -> list[tuple]:
        """(role, kernel, shape, dtype, Δ_TH) of each tunable kernel launch
        this session's steps make, as far as the session knows them: the
        ΔGRU (once its input width is known; stage 1 of a cascade runs
        the masked instantiation, which takes no knob, but is listed as
        the reference lists it), the FEx (once there is one) and the
        cascade's stage 0, at the shapes one shard's launch serves (B/n
        streams on a mesh of n shards)."""
        int8 = self.numerics == "int8"
        gru, gdt = (("delta_gru_seq_int", "int8") if int8
                    else ("delta_gru_seq", "float32"))
        b = self.batch // self.n_shards
        out = []
        if self._input_dim is not None:
            out.append(("gru", gru, (b, int(self._input_dim),
                                     int(self._gru.w_h.shape[0])), gdt,
                        self.threshold))
        if self._fex is not None:
            fcfg = self._fex.cfg
            out.append(("fex", "batched_iir_fex_int" if int8
                        else "batched_iir_fex",
                        (b, int(fcfg.n_active), int(fcfg.frame_shift)),
                        "int16" if int8 else "float32", 0.0))
        if self._cascade is not None:
            out.append(("gru0", gru, (b, int(self._cascade.s0_channels),
                                      self._s0_hidden), gdt,
                        self._cascade.s0_threshold))
        return out

    def _tuned(self, kernel: str, shape: tuple, dtype: str,
               threshold) -> dict:
        """The cached configuration of one launch shape, looked up once per
        (kernel, shape, dtype, Δ_TH bucket) and kept: the serving step
        never reads the cache file.  {} when autotuning is disabled or
        the cache has no entry (the default launch)."""
        key = (kernel, shape, dtype, autotune.threshold_bucket(threshold))
        if key not in self._tuning:
            cfg = (autotune.lookup(kernel, shape, dtype, threshold,
                                   self.device)
                   if autotune.autotune_enabled() else None)
            self._tuning[key] = cfg or {}
        return self._tuning[key]

    def _resolve_tuning(self) -> None:
        """Look up every configuration the steps will use (at creation,
        when the input width or the FEx appears, after ``set_threshold``)."""
        for _, *entry in self._tuning_entries():
            self._tuned(*entry)

    def _step_knobs(self, n_frames: int) -> dict:
        """Each kernel's launch knobs for a step of ``n_frames`` frames:
        its looked-up configuration with every knob illegal for this
        chunk dropped (``autotune.sanitize``; pure, no file access)."""
        shift = self._fex.cfg.frame_shift if self._fex is not None else None
        knobs = {}
        for role, kernel, shape, dtype, th in self._tuning_entries():
            cfg = self._tuned(kernel, shape, dtype, th)
            knobs[f"{role}_knobs"] = (
                autotune.sanitize(kernel, cfg, B=shape[0],
                                  frame_shift=shift) if role == "fex"
                else autotune.sanitize(kernel, cfg, B=shape[0],
                                       T=n_frames))
        return knobs

    def kernel_tuning_report(self) -> dict:
        """Which autotuned kernel configurations THIS session's steps use.

        The session looks each configuration up in the ``kernels.autotune``
        cache once — when it is built, when its input width or FEx first
        appears, after ``set_threshold`` — and passes it to the scans
        explicitly; this reports the RAW configuration under each key
        (ΔGRU and FEx, with the shapes one launch plan serves) as the
        session looked it up (``enabled`` is the environment's switch
        now; a session built with it off looked nothing up).  The step
        still drops a knob that is illegal for a chunk (a ``block_t``
        that does not divide its frame count), so a listed knob may fall
        back to its default for such a chunk.  An empty config means a
        cold cache: the default launch.  Never raises (a broken cache
        reads as empty); purely observational.
        """
        enabled = autotune.autotune_enabled()
        report: dict = {"platform": autotune.platform_tag(self.device),
                        "cache": str(autotune.cache_path()),
                        "enabled": enabled, "kernels": {}}
        for role, kernel, shape, dtype, th in self._tuning_entries():
            if role == "gru0":          # the reference reports stage 1
                continue
            report["kernels"][kernel] = {
                "shape": list(shape),
                "config": dict(self._tuned(kernel, shape, dtype, th))}
        return report

    def _fresh_cascade_state(self) -> CascadeState:
        b = self.batch // self.n_shards
        return self._each(lambda i: init_cascade_state(
            b, self._w(i, "gru0"), int8=self.numerics == "int8"))

    def _fresh_vad_state(self, n_channels: int) -> VADState:
        # The VAD holds what the ΔGRU eats: float features, or int16
        # feature codes in the int8 engine.
        dtype = torch.int16 if self.numerics == "int8" else torch.float32
        b = self.batch // self.n_shards
        return self._each(lambda i: init_vad_state(b, n_channels, dtype,
                                                   self._dev(i)))

    def _fresh_det_state(self) -> DetectorState:
        b = self.batch // self.n_shards
        return self._each(lambda i: init_detector_state(b, self.n_classes,
                                                        self._dev(i)))

    def _coerce_audio(self, audio) -> np.ndarray:
        """Decode + police one raw-audio chunk per ``input_policy``.

        Integer arrays are ADC codes: range-checked against int16 and
        decoded to float.  Float arrays are policed for non-finite samples
        according to the policy; any other dtype raises
        ``StreamInputError``.
        """
        arr = np.asarray(audio)
        if arr.dtype.kind in "iu":
            if arr.size and (int(arr.min()) < -32768
                             or int(arr.max()) > 32767):
                raise StreamInputError(
                    f"integer audio must be int16-range ADC codes in "
                    f"[-32768, 32767]; got values in "
                    f"[{int(arr.min())}, {int(arr.max())}]")
            return arr.astype(np.float32) / 32768.0
        if arr.dtype.kind != "f":
            raise StreamInputError(
                f"audio dtype {arr.dtype} is not decodable: pass float "
                f"samples in [-1, 1) or int16-range integer codes")
        arr = arr.astype(np.float32)
        if self.input_policy == "trust":
            return arr
        n_bad = int(np.count_nonzero(~np.isfinite(arr)))
        if n_bad:
            if self.input_policy == "reject":
                raise StreamInputError(
                    f"{n_bad} non-finite samples in audio chunk "
                    f"(input_policy='reject'; use 'sanitize' to squash "
                    f"them instead)")
            arr = np.nan_to_num(arr, nan=0.0, posinf=1.0 - 2.0 ** -11,
                                neginf=-1.0)
        return arr

    def process_audio(self, audio) -> ChunkResult | DetectResult:
        """Run a chunk of RAW audio through FEx → ΔGRU → FC (detect mode:
        FEx → VAD → ΔGRU → FC → detection head, a ``DetectResult``).

        ``audio``: (samples,) for a single stream, or (batch, samples)
        float in [-1, 1) — or int16-range integer ADC codes, which are
        decoded.  Hostile inputs are policed per ``input_policy``.
        Samples past the last whole 16 ms frame are buffered host-side
        and prepended to the next chunk, so chunk boundaries are
        invisible.  Returns DEVICE tensors with one row per completed
        frame (possibly zero rows).
        """
        fex = self._require_fex()
        audio = self._coerce_audio(audio)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] != self.batch:
            raise ValueError(f"audio carries {audio.shape[0]} streams, "
                             f"session was created with batch={self.batch}")
        if self._audio_rem.shape[1]:
            audio = np.concatenate([self._audio_rem, audio], axis=1)
        shift = fex.cfg.frame_shift
        n_frames = audio.shape[1] // shift
        self._audio_rem = audio[:, n_frames * shift:]
        if n_frames == 0:
            z = torch.zeros((0, self.batch), dtype=torch.int32,
                            device=self.device)
            logits = torch.zeros((0, self.batch, self.n_classes),
                                 device=self.device)
            if self._detector is not None:
                none = torch.zeros((0, self.batch), dtype=torch.bool,
                                   device=self.device)
                return DetectResult(
                    logits=logits, votes=z, nz=z, events=z, gate=none,
                    awake=none if self._cascade is not None else None)
            return ChunkResult(logits=logits, votes=z, nz=z)
        b = self.batch // self.n_shards
        block = self._each(lambda i: _upload(
            audio[i * b:(i + 1) * b, :n_frames * shift], self._dev(i),
            torch.float32))
        fcfg = fex.cfg
        if self.numerics == "int8":
            kw = dict(gfmt=self._bundle.gfmt, ffmt=self._bundle.ffmt)
        else:
            kw = dict(env_alpha=fcfg.env_alpha, log_eps=fcfg.log_eps)
        weights = self._weights("gru", "w_fc", "b_fc", "coef")
        knobs = self._step_knobs(n_frames)
        if self._cascade is not None:
            kw.update(fex_knobs=knobs["fex_knobs"],
                      gru0_knobs=knobs["gru0_knobs"])
        else:
            kw.update(fex_knobs=knobs["fex_knobs"],
                      gru_knobs=knobs["gru_knobs"])
        if self._cascade is not None:
            step = _process_audio_chunk_cascade
            if self.numerics == "int8":
                step = _process_audio_chunk_cascade_int
                kw["gfmt0"] = self._bundle0.gfmt
            # (gru, w_fc, b_fc, gru0, w_fc0, b_fc0, coef, fex_state, state,
            # cas_state, vad_state, det_state, acc, audio): both stages'
            # weights replicated, the rest slot-major.
            step = shard_map_kernels(step, self.mesh,
                                     slot_major=range(7, 14), time_major=(),
                                     n_state_out=6)
            (self._fex_state, self._state, self._cas_state, self._vad_state,
             self._det_state, self._acc, out, self._last_health) = step(
                *self._weights("gru", "w_fc", "b_fc", "gru0", "w_fc0",
                               "b_fc0", "coef"), self._fex_state, self._state,
                self._cas_state, self._vad_state, self._det_state, self._acc,
                block, threshold=self.threshold, frame_shift=shift,
                vad_cfg=self._vad, det_cfg=self._detector,
                cas_cfg=self._cascade, **kw)
        elif self._detector is not None:
            step = (_process_audio_chunk_detect_int
                    if self.numerics == "int8"
                    else _process_audio_chunk_detect)
            # (gru, w_fc, b_fc, coef, fex_state, state, vad_state,
            # det_state, acc, audio)
            step = shard_map_kernels(step, self.mesh,
                                     slot_major=range(4, 10), time_major=(),
                                     n_state_out=5)
            (self._fex_state, self._state, self._vad_state, self._det_state,
             self._acc, out, self._last_health) = step(
                *weights, self._fex_state, self._state, self._vad_state,
                self._det_state, self._acc, block, threshold=self.threshold,
                frame_shift=shift, vad_cfg=self._vad,
                det_cfg=self._detector, **kw)
        else:
            step = (_process_audio_chunk_int if self.numerics == "int8"
                    else _process_audio_chunk)
            # (gru, w_fc, b_fc, coef, fex_state, state, acc, audio)
            step = shard_map_kernels(step, self.mesh,
                                     slot_major=range(4, 8), time_major=(),
                                     n_state_out=3)
            (self._fex_state, self._state, self._acc, out,
             self._last_health) = step(
                *weights, self._fex_state, self._state, self._acc, block,
                threshold=self.threshold, frame_shift=shift, **kw)
        self._chunks += 1
        self._maybe_heal()
        return out

    def process_chunk(self, feats) -> ChunkResult:
        """Run one chunk of pre-computed FRAMES through the ΔGRU.

        ``feats``: (frames, channels) for a single stream, or
        (frames, batch, channels).  Returns DEVICE tensors.  Detect mode
        needs raw audio (the VAD gates on sample energy) and raises.
        """
        if self._detector is not None:
            raise ValueError("detection mode needs raw audio (the VAD "
                             "gates on sample energy): use process_audio")
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[:, None, :]                 # (F, 1, C)
        if feats.shape[0] == 0:
            raise ValueError("empty chunk: need at least one frame")
        if feats.shape[1] != self.batch:
            raise ValueError(f"chunk carries {feats.shape[1]} streams, "
                             f"session was created with batch={self.batch}")
        if self._state is None:
            self._init_state(feats.shape[-1])
        elif feats.shape[-1] != self._input_dim:
            raise ValueError(f"chunk has {feats.shape[-1]} feature channels,"
                             f" session state is {self._input_dim}-wide")
        b = self.batch // self.n_shards
        block = self._each(lambda i: _upload(
            feats[:, i * b:(i + 1) * b], self._dev(i), torch.float32))
        step, kw = ((_process_chunk_int, {"gfmt": self._bundle.gfmt})
                    if self.numerics == "int8" else (_process_chunk, {}))
        kw["gru_knobs"] = self._step_knobs(feats.shape[0])["gru_knobs"]
        # (gru, w_fc, b_fc, state, acc, feats): feats time-major
        step = shard_map_kernels(step, self.mesh, slot_major=(3, 4),
                                 time_major=(5,), n_state_out=2)
        self._state, self._acc, out, self._last_health = step(
            *self._weights("gru", "w_fc", "b_fc"), self._state, self._acc,
            block, threshold=self.threshold, **kw)
        self._chunks += 1
        self._maybe_heal()
        return out

    @property
    def state(self) -> dg.DeltaState | None:
        return self._joined(self._state)

    @property
    def fex_state(self) -> FExState | None:
        return self._joined(self._fex_state)

    @property
    def vad_state(self) -> VADState | None:
        return self._joined(self._vad_state)

    @property
    def det_state(self) -> DetectorState | None:
        return self._joined(self._det_state)

    @property
    def cas_state(self) -> CascadeState | None:
        return self._joined(self._cas_state)

    def reset(self):
        """Forget stream state + telemetry (keeps weights)."""
        if self._input_dim is not None:
            self._init_state(self._input_dim)
        if self._fex_state is not None:
            self._fex_state = self._fresh_fex_state(self._input_dim)
            self._audio_rem = np.zeros((self.batch, 0), np.float32)
        if self._vad_state is not None:
            self._vad_state = self._fresh_vad_state(self._input_dim)
        if self._det_state is not None:
            self._det_state = self._fresh_det_state()
        if self._cas_state is not None:
            self._cas_state = self._fresh_cascade_state()
        self._acc = self._each(lambda i: _zero_accum(self._dev(i)))
        self._chunks = 0
        self._last_health = None
        self._strikes = np.zeros((self.batch,), np.int64)
        self._recoveries = 0
        self._recovery_reasons = {}
        self._sat_events = 0
        self._flagged = frozenset()
        self._slo = {}

    def reset_stream(self, i: int):
        """Reset ONE stream slot to fresh-stream state (see
        ``reset_streams``)."""
        self.reset_streams([i])

    def reset_streams(self, slots):
        """Reset a wave of stream slots to fresh-stream state: one
        mask-select per state field, on the device, no sync.

        Caveat: the carried sample remainder's LENGTH is shared across
        streams, so the reset zeroes a slot's buffered samples but cannot
        drop them.  Feed frame-aligned chunks (the serve launcher's
        default) to keep resets exactly fresh."""
        slots = list(slots)
        for i in slots:
            if not (0 <= i < self.batch):
                raise ValueError(f"stream {i} out of range [0, {self.batch})")
        if not slots:
            return
        mask = np.zeros((self.batch,), bool)
        mask[slots] = True
        b = self.batch // self.n_shards
        for i in range(self.n_shards):
            block = mask[i * b:(i + 1) * b]
            if block.any():               # a shard without a reset idles
                with self._shard_ctx(i):
                    self._reset_shard(i, _upload(block, self._dev(i),
                                                 torch.bool))
        if self._audio_rem is not None and self._audio_rem.shape[1]:
            self._audio_rem[slots] = 0.0
        self._strikes[slots] = 0          # a reset slot restarts clean
        if self._flagged:
            self._flagged = self._flagged - set(slots)

    def _reset_shard(self, i: int, mask):
        """The reset wave's mask-selects on shard ``i``'s state (``mask``:
        its block of the wave, on its device)."""
        for name, reset, extra in (
                ("_state", _reset_gru_slots, (self._w(i, "gru").b,)),
                ("_fex_state", _reset_fex_slots, ()),
                ("_vad_state", _reset_vad_slots, ()),
                ("_det_state", _reset_det_slots, ()),
                ("_cas_state", _reset_cascade_slots,
                 (self._w(i, "gru0").b,) if self._cascade else ())):
            if getattr(self, name) is not None:
                self._put(name, i, reset(self._get(name, i), *extra, mask))

    # ------------------------------------------------ self-healing --

    def set_threshold(self, threshold: float):
        """Move the serving step to another Δ_TH mid-stream: the
        graceful-degradation lever the admission controller pulls.

        Carried stream state is untouched; the next chunk runs with the
        new delta deadband (int8: its codes through ``gfmt.th_codes`` at
        step time).  A cascade session moves stage 1 only; stage 0 keeps
        ``cascade.s0_threshold``.  Raises ``ValueError`` for a non-finite
        or negative threshold; a no-op at the current one.
        """
        threshold = float(threshold)
        if not np.isfinite(threshold) or threshold < 0.0:
            raise ValueError(f"delta threshold must be finite and >= 0, "
                             f"got {threshold}")
        self.threshold = threshold
        self._resolve_tuning()

    def _health_flags(self) -> np.ndarray:
        """The last step's (batch,) health mask on the host (waits for
        that step)."""
        return self._last_health.cpu().numpy()

    def _count_reasons(self, flags: np.ndarray, victims, mask: int):
        for s in victims:
            for bit, reason in HEALTH_REASONS.items():
                if flags[s] & bit & mask:
                    self._recovery_reasons[reason] = \
                        self._recovery_reasons.get(reason, 0) + 1
        self._recoveries += len(victims)

    def _quarantine(self, flags: np.ndarray, mask: int) -> list[int]:
        """Reset every slot whose strike count cleared the bar; returns
        the slots reset.  ``flags`` is the fetched (batch,) health mask,
        ``mask`` the quarantine bit set."""
        bad = (flags & mask) != 0
        self._strikes = np.where(bad, self._strikes + 1, 0)
        after = (self.supervisor.quarantine_after
                 if self.supervisor is not None else 1)
        victims = [int(s) for s in np.flatnonzero(self._strikes >= after)]
        if victims:
            self._count_reasons(flags, victims, mask)
            self.reset_streams(victims)
        return victims

    def _maybe_heal(self):
        """One supervisor tick (called after every processed chunk)."""
        sup = self.supervisor
        if sup is None or self._last_health is None:
            return
        if self._chunks % sup.check_every:
            return
        flags = self._health_flags()
        self._sat_events += int(np.count_nonzero(flags & HEALTH_SAT))
        healed = self._quarantine(flags, sup.quarantine_mask)
        # Host cache of who is STILL flagged (below the strike bar, not
        # yet quarantined): the scheduler reads it at admit() without a
        # fetch of its own.
        bad = (flags & sup.quarantine_mask) != 0
        bad[healed] = False               # quarantined slots restart clean
        self._flagged = frozenset(int(s) for s in np.flatnonzero(bad))

    def heal(self, mask: int | None = None) -> list[int]:
        """Force one supervisor pass now, ignoring ``check_every`` and
        the strike bar: every slot the last chunk flagged in ``mask``
        (default: the supervisor's quarantine mask, or
        ``QUARANTINE_DEFAULT`` without one) is reset at once.  Returns
        the slots reset.  Safe without a supervisor."""
        if self._last_health is None:
            return []
        if mask is None:
            mask = (self.supervisor.quarantine_mask
                    if self.supervisor is not None else QUARANTINE_DEFAULT)
        flags = self._health_flags()
        victims = [int(s) for s in np.flatnonzero((flags & mask) != 0)]
        if victims:
            self._count_reasons(flags, victims, mask)
            self.reset_streams(victims)
        return victims

    def unhealthy_slots(self) -> dict[int, int]:
        """Slots flagged by the LAST processed chunk: {slot: HEALTH_*
        bitmask}, empty when everything is healthy (one host fetch)."""
        if self._last_health is None:
            return {}
        flags = self._health_flags()
        return {int(i): int(flags[i]) for i in np.flatnonzero(flags)}

    def flagged_slots(self) -> frozenset:
        """Slots the supervisor holds under suspicion: flagged by the
        last health check but still below the strike bar.  Host-cached by
        ``_maybe_heal``, so reading it never waits for the card; always
        empty without a supervisor.  ``SlotScheduler.admit`` skips them:
        a stream admitted into a still-poisoned slot would inherit its
        corrupted state."""
        return self._flagged

    def attach_slo(self, report: dict):
        """Attach a serve-loop timing block; ``summary().slo`` carries it.
        Cleared by ``reset``."""
        self._slo = dict(report)

    def summary(self) -> StreamSummary:
        """Fetch the device telemetry ONCE and price it with the IC model.

        The fetch is the engine's only reduction across shards: each
        shard's partial sums come back to the host and are summed there."""
        per_shard = []
        for i in range(self.n_shards):
            with self._shard_ctx(i):          # the fetch waits on its stream
                per_shard.append(torch.stack(list(self._get("_acc", i)))
                                 .cpu().tolist())
        totals = dict(zip(_Accum._fields,
                          [sum(v) for v in zip(*per_shard)]))
        overflow = any(v >= _COUNT_SAT for row in per_shard for v in row)
        robust = dict(overflowed=overflow, recoveries=self._recoveries,
                      recovery_reasons=dict(self._recovery_reasons),
                      sat_events=self._sat_events, slo=dict(self._slo))
        if totals["frames"] == 0:
            return StreamSummary(frames=0, chunks=0, sparsity=0.0,
                                 energy_nj_per_decision=0.0, latency_ms=0.0,
                                 dense_energy_nj=0.0, **robust)
        frames = totals["frames"]
        n_ch = self._fex.cfg.n_active if self._fex is not None else 10
        c = frame_cost(totals["macs"] / frames, n_channels=n_ch)
        # The energy detector is powered only when the gate is configured
        # (detect mode, a non-negative threshold; VAD_OFF is unpowered).
        vad_nj = (vad_energy_nj(float(totals["fex_samples"])) / frames
                  if self._vad is not None
                  and self._vad.energy_threshold >= 0 else 0.0)
        energy_nj, latency_ms = c.energy_nj_per_decision, c.latency_ms
        cascade_kw: dict = {}
        if self._cascade is not None:
            # Two-stage pricing: stage 0 always on, stage 1's FC and SRAM
            # words weighted by the awake fraction; ``macs`` counts only
            # the awake stage-1 frames already.
            duty = totals["awake"] / frames
            cc = cascade_frame_cost(
                totals["s0_macs"] / frames, totals["macs"] / frames, duty,
                s0_hidden=self._s0_hidden, s0_classes=self._s0_classes,
                s1_hidden=int(self._gru.w_h.shape[0]),
                s1_classes=self.n_classes, n_channels=n_ch)
            energy_nj, latency_ms = cc.energy_nj_per_decision, cc.latency_ms
            cascade_kw = dict(stage1_duty=duty,
                              s0_energy_nj_per_decision=cc.s0_energy_nj,
                              frames_entered_stage1=totals["awake"])
        return StreamSummary(
            frames=frames, chunks=self._chunks,
            sparsity=1.0 - totals["macs"] / max(totals["macs_dense"], 1),
            energy_nj_per_decision=energy_nj + vad_nj,
            latency_ms=latency_ms,
            dense_energy_nj=frame_cost(totals["macs_dense"] / frames,
                                       n_channels=n_ch).energy_nj_per_decision,
            fex_samples=totals["fex_samples"],
            fex_energy_nj_per_decision=fex_energy_nj(
                float(totals["fex_samples"]), n_ch) / frames,
            vad_duty=totals["vad_open"] / frames,
            vad_energy_nj_per_decision=vad_nj, **cascade_kw, **robust)


class SlotScheduler:
    """Admission/eviction queue mapping live streams onto the session's
    slots (host-side bookkeeping; the only device work is the batched
    ``reset_streams`` of each admission wave).  Under a sharded session
    the free list is kept per shard and admissions go to the least-loaded
    shard: the step runs at the speed of its busiest shard, so balance is
    throughput.

    Usage::

        sched = SlotScheduler(sess)
        sched.submit(request_id)          # any payload
        for slot, req in sched.admit():   # fills free slots, resets them
            ...
        sched.evict(slot)                 # stream finished; slot is free
    """

    def __init__(self, session: StreamingKwsSession):
        self._sess = session
        self.n_slots = session.batch
        self.n_shards = session.n_shards
        self._queue: collections.deque = collections.deque()
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        for s in range(self.n_slots - 1, -1, -1):    # pop() yields low first
            self._free[session.shard_of_slot(s)].append(s)
        self.live: dict[int, Any] = {}               # slot -> payload

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self.live and not self._queue

    def submit(self, payload: Any):
        """Enqueue one stream request (admitted at the next ``admit()``)."""
        self._queue.append(payload)

    def occupancy(self) -> list[int]:
        """Live streams per shard (the balance ``admit`` keeps)."""
        counts = [0] * self.n_shards
        for slot in self.live:
            counts[self._sess.shard_of_slot(slot)] += 1
        return counts

    def admit(self) -> list[tuple[int, Any]]:
        """Map queued requests onto free slots, least-loaded shard first
        (in a shard, the most recently freed slot first, like the
        reference), and reset the whole wave with ONE batched
        ``reset_streams``.  Slots the supervisor flags
        (``session.flagged_slots()``) are skipped and stay on the free
        list until it heals or clears them.  Returns the (slot, payload)
        pairs."""
        flagged = self._sess.flagged_slots()
        admitted = []
        while self._queue:
            usable = [s for s in range(self.n_shards)
                      if any(sl not in flagged for sl in self._free[s])]
            if not usable:
                break                     # full, or only unhealthy slots
            free = self._free[min(usable, key=self._shard_load)]
            idx = next(i for i in range(len(free) - 1, -1, -1)
                       if free[i] not in flagged)
            slot = free.pop(idx)
            payload = self._queue.popleft()
            self.live[slot] = payload
            admitted.append((slot, payload))
        if admitted:
            self._sess.reset_streams([slot for slot, _ in admitted])
        return admitted

    def _shard_load(self, shard: int) -> int:
        return self.n_slots // self.n_shards - len(self._free[shard])

    def evict(self, slot: int) -> Any:
        """Free a finished stream's slot; returns its payload.  Evicting a
        slot that is not live raises ``ValueError`` naming its state."""
        if slot not in self.live:
            if not 0 <= slot < self.n_slots:
                state = f"out of range [0, {self.n_slots})"
            elif slot in self._free[self._sess.shard_of_slot(slot)]:
                state = "already free (double evict?)"
            else:
                state = "never admitted"
            raise ValueError(f"cannot evict slot {slot}: {state}")
        payload = self.live.pop(slot)
        self._free[self._sess.shard_of_slot(slot)].append(slot)
        return payload
