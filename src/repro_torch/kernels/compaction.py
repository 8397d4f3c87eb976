"""Event-driven active-slot compaction for the sequence ΔGRU kernels.

PyTorch port of ``repro/kernels/compaction.py`` (which works in numpy):
per chunk, the slots that provably do nothing are skipped, the remaining
active slots are gathered into a compacted batch, the dense executor runs
on that batch only, and the results are scattered back — bit for bit the
dense run.  Here the tensors stay on their device: rows are gathered with
``index_select`` and scattered with ``index_copy_``, and states are
compared by their bit patterns (``view`` as an integer type, so -0.0 and
NaN payloads compare exactly).

Why it is exact.  A frame with a zero input delta still moves h through
the gates, so "Δx = 0" alone licenses nothing.  Two conditions do:

  1. held input: every frame of the chunk lies inside the Δ dead zone of
     the slot's carried x̂ (max_t |x_t − x̂₀| ≤ Δ_TH), so x̂ never moves
     and the chunk depends on the carried state alone;
  2. probe fixed point: one frame of the real executor from the carried
     state returns the state bit-unchanged.  Then every frame does, and
     the slot's outputs are hs[t] = h₀, zero counts, the state unchanged.

A slot failing either runs through the executor, so a converging stream
is merely not sped up, never wrong.  The compacted batch is padded to a
power of two by repeating its first row, as the reference pads it.

Host-level by nature (the compacted batch's size is dynamic): a call
reads the candidate set and the probe's verdict back to the host, two
syncs.  The entry points are ``core.delta_gru.delta_gru_scan(...,
event_driven=True)`` and ``core.fixed_point.int_gru_scan(...,
event_driven=True)``; the serving step does not use it (its in-step
counterpart is the wake cascade).

Telemetry: module-level counters (``reset_counters`` / ``counters``) of
frames served against frames that entered the executor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

_INT_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


class CompactionReport(NamedTuple):
    """What one event-driven chunk executed."""

    n_slots: int          # batch rows served
    n_skipped: int        # rows proven quiescent and skipped
    frames_total: int     # frames × slots the caller asked for
    frames_entered: int   # frames × rows that entered the executor
    probe_frames: int     # one-frame probe rows spent proving skips


_COUNTERS = {"chunks": 0, "slots_total": 0, "slots_skipped": 0,
             "frames_total": 0, "frames_entered": 0, "probe_frames": 0}


def reset_counters() -> None:
    """Zero the cumulative event-driven telemetry counters."""
    for k in _COUNTERS:
        _COUNTERS[k] = 0


def counters() -> dict:
    """Cumulative telemetry since the last ``reset_counters()``: chunks,
    slots_total / slots_skipped, frames_total / frames_entered and
    probe_frames (probe rows count in frames_entered too)."""
    return dict(_COUNTERS)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Bit-pattern view: floats as integers of their width."""
    if t.is_floating_point():
        return t.contiguous().view(_INT_VIEW[t.element_size()])
    return t


def _rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, ...) × (B, ...) → (B,) bool, bitwise per-row equality."""
    eq = _bits(a) == _bits(b)
    return eq.reshape(eq.shape[0], -1).all(dim=1)


def held_slots(xs: torch.Tensor, x_hat: torch.Tensor,
               threshold) -> torch.Tensor:
    """Condition 1, per slot: (T, B, I) × (B, I) → (B,) bool on the device.

    True where every frame of every channel lies inside the Δ dead zone of
    the carried x̂: |x_t − x̂₀| ≤ Δ_TH, the kernels' transmit predicate
    (transmit iff |diff| > th) negated, in their arithmetic: float32 for
    the float path, exact integer differences for codes.  A NaN input is
    never held."""
    T, B = xs.shape[0], xs.shape[1]
    if xs.is_floating_point():
        diff = (xs.float() - x_hat.float()[None]).abs()
        inside = diff <= torch.tensor(float(threshold), dtype=torch.float32,
                                      device=xs.device)
    else:
        diff = (xs.to(torch.int64) - x_hat.to(torch.int64)[None]).abs()
        inside = diff <= int(threshold)
    return inside.reshape(T, B, -1).all(dim=2).all(dim=0)


def _pad_count(k: int, cap: int) -> int:
    """The next power of two from k, at most cap."""
    n = 1
    while n < k:
        n *= 2
    return min(n, cap)


def _padded_index(rows: torch.Tensor, pad_to: int) -> torch.Tensor:
    """``rows`` padded to ``pad_to`` entries by repeating its first."""
    if len(rows) < pad_to:
        rows = torch.cat([rows, rows[:1].expand(pad_to - len(rows))])
    return rows


def event_driven_seq(run: Callable, xs: torch.Tensor, state: Sequence,
                     held: torch.Tensor):
    """Run one chunk event-driven: skip the proven-quiescent slots,
    compact the rest, scatter — bit for bit ``run`` on the full batch.

    Args:
      run: the dense executor, ``run(xs (T, k, I), state 5-tuple of (k,
        ...) tensors) -> (hs (T, k, H), state', nz_dx (T, k), nz_dh (T,
        k))`` for any k and any T >= 1 (the probe and the compacted run
        use it alike).
      xs: (T, B, I) chunk inputs (float values or integer codes).
      state: the carried (h, x̂, ĥ, m_x, m_h), batch-leading.
      held: (B,) bool from ``held_slots`` (candidates; the probe decides).

    Returns ``(hs, state', nz_dx, nz_dh, CompactionReport)``, tensors on
    the inputs' device.  The module counters accumulate the report.
    """
    T, B = xs.shape[0], xs.shape[1]
    dev = xs.device
    state = list(state)
    skip = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_skipped = probe = 0
    cand = torch.nonzero(held.to(dev)).flatten()          # host sync 1
    if T > 0 and len(cand):
        pad = _pad_count(len(cand), B)
        idx = _padded_index(cand, pad)
        probe_state = [s.index_select(0, idx) for s in state]
        _, p_state, _, _ = run(xs[:1].index_select(1, idx).contiguous(),
                               tuple(probe_state))
        fixed = torch.ones((pad,), dtype=torch.bool, device=dev)
        for before, after in zip(probe_state, p_state):
            fixed &= _rows_equal(after, before)
        skip[cand] = fixed[:len(cand)]
        probe = pad
    active = torch.nonzero(~skip).flatten()                # host sync 2
    n_skipped = B - len(active)
    H = state[0].shape[1]
    hs = state[0][None].expand(T, B, H).clone()
    nz_dx = torch.zeros((T, B), dtype=torch.int32, device=dev)
    nz_dh = torch.zeros((T, B), dtype=torch.int32, device=dev)
    out_state = [s.clone() for s in state]
    entered = 0
    if T > 0 and len(active):
        k = len(active)
        pad = _pad_count(k, B)
        idx = _padded_index(active, pad)
        a_hs, a_state, a_nzx, a_nzh = run(
            xs.index_select(1, idx).contiguous(),
            tuple(s.index_select(0, idx) for s in state))
        hs.index_copy_(1, active, a_hs[:, :k])
        nz_dx.index_copy_(1, active, a_nzx[:, :k].to(torch.int32))
        nz_dh.index_copy_(1, active, a_nzh[:, :k].to(torch.int32))
        for dst, src in zip(out_state, a_state):
            dst.index_copy_(0, active, src[:k])
        entered = T * pad
    rep = CompactionReport(n_slots=B, n_skipped=n_skipped,
                           frames_total=T * B,
                           frames_entered=entered + probe,
                           probe_frames=probe)
    _COUNTERS["chunks"] += 1
    _COUNTERS["slots_total"] += B
    _COUNTERS["slots_skipped"] += rep.n_skipped
    _COUNTERS["frames_total"] += rep.frames_total
    _COUNTERS["frames_entered"] += rep.frames_entered
    _COUNTERS["probe_frames"] += rep.probe_frames
    return hs, out_state, nz_dx, nz_dh, rep
