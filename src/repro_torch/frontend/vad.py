"""Energy-based voice-activity gate for the always-on delta path.

PyTorch port of ``repro/frontend/vad.py``.  The ΔGRU's energy is
proportional to transmitted deltas, and an always-on stream is mostly
silence.  This gate computes a per-frame energy (mean |sample|) from the
12-bit audio and, while the stream is judged silent, sample-and-holds the
feature vector fed to the ΔGRU:

    speech_t = frame_energy_t > energy_threshold
    gate_t   = speech_t  OR  hangover counter > 0
    x_out_t  = x_t        if gate_t else  x_held   (last gated-through x)

A held (constant) input produces Δx = 0 exactly: the Δ-encoder's own
deadband does the skipping.  ``hangover_frames`` keeps the gate open
across short intra-word dips.  ``energy_threshold < 0`` disables the gate
(energy is non-negative, so every frame passes).

The reference scans the frames one by one (``lax.scan``); JAX fuses that
loop into its step, but as eager PyTorch a per-frame loop costs a
handful of launches per frame.  The gate only selects and counts, so
``vad_gate`` computes it in closed form, in a fixed number of operations
whatever the chunk length:

* the countdown after frame t is ``hangover_frames - (t - last)`` from
  the last speech frame at or before t, or, with no speech yet in the
  chunk, the carried ``hang`` minus the frames since; the gate at t is
  speech, or a positive countdown after frame t - 1;
* the held vector at frame t is the features of the last gated frame at
  or before t, or the carried ``hold`` when there is none;

both "last" indices are running maxima (``cummax``) over frame indices:
about twenty launches for a chunk, whatever its length.
``vad_gate_loop`` is the frame-by-frame loop, kept for the tests, which
hold the two equal bit for bit.

State (``VADState``) is per stream slot, carried on the device across
chunks, elementwise along the slot axis, so chunk boundaries are
invisible.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VADConfig(NamedTuple):
    """Static VAD configuration.

    energy_threshold: mean-|sample| level (on the 12-bit audio grid,
      full scale 1.0) above which a frame counts as speech.  Negative
      disables the gate entirely (always open, bit-identical features).
    hangover_frames: frames the gate stays open after the energy drops
      below threshold (~16 ms each).
    """

    energy_threshold: float = 0.01
    hangover_frames: int = 12


# The all-pass configuration: energy >= 0 always beats a negative
# threshold, so the gate is open every frame and the features pass
# through unchanged.
VAD_OFF = VADConfig(energy_threshold=-1.0, hangover_frames=0)


class VADState(NamedTuple):
    """Per-slot carried VAD state (device-resident).

    hold: (B, C) — last feature vector that passed the gate (float32 in
      the float engine, int16 codes in the int8 engine).
    hang: (B,) int32 — hangover countdown.
    """

    hold: torch.Tensor
    hang: torch.Tensor


def init_vad_state(batch: int, n_channels: int, dtype=torch.float32,
                   device="cpu") -> VADState:
    """Fresh-stream VAD state: zero hold (matching the ΔGRU's x̂ = 0) and
    no hangover.  ``dtype`` is the hold's: float32 or int16 codes."""
    return VADState(
        hold=torch.zeros((batch, n_channels), dtype=dtype, device=device),
        hang=torch.zeros((batch,), dtype=torch.int32, device=device))


def vad_state_flags(state: VADState) -> torch.Tensor:
    """(B,) bool, True where the float hold register is non-finite (a NaN
    hold feeds the ΔGRU NaNs for as long as the stream stays silent).
    Integer-code holds cannot be non-finite and always read healthy."""
    if not state.hold.is_floating_point():
        return torch.zeros(state.hold.shape[:1], dtype=torch.bool,
                           device=state.hold.device)
    return (~torch.isfinite(state.hold)).any(dim=-1)


def frame_energy(audio: torch.Tensor, frame_shift: int) -> torch.Tensor:
    """Per-frame mean |sample|: audio (B, S) → energy (F, B) float32,
    F = S // frame_shift (whole frames only).

    The session passes 12-bit audio (``quantize_audio_12b``): every sample
    is a multiple of 2^-11 with |x| <= 1, so a frame's sum of 128 |x| is at
    most 2^18 units of 2^-11 and exact in float32 in any order, and the
    division by 128 is exact too.  So ``torch.mean`` equals the
    reference's reduction bit for bit without repeating its order.
    """
    B, S = audio.shape
    n_frames = S // frame_shift
    frames = audio[:, :n_frames * frame_shift].float()
    frames = frames.reshape(B, n_frames, frame_shift)
    return frames.abs().mean(dim=-1).movedim(0, 1)


def vad_gate(feats: torch.Tensor, energy: torch.Tensor, state: VADState,
             cfg: VADConfig) -> tuple[torch.Tensor, torch.Tensor, VADState]:
    """Gate a chunk of frames through the energy VAD (closed form).

    Args:
      feats: (F, B, C) frame-major feature vectors (float features or
        int16 codes — the hold keeps their dtype).
      energy: (F, B) per-frame energies from ``frame_energy``.
      state: carried ``VADState`` (``init_vad_state`` for a fresh stream).
      cfg: ``VADConfig``; ``VAD_OFF`` makes this an identity gate.

    Returns:
      (gated feats (F, B, C), gate mask (F, B) bool, carried state).

    Equal bit for bit to ``vad_gate_loop``, the reference's frame loop,
    for every carried ``hang`` above ``INT32_MIN`` (the loop's countdown
    wraps there).
    """
    n_frames = feats.shape[0]
    if n_frames == 0:
        return feats, torch.zeros(energy.shape, dtype=torch.bool,
                                  device=feats.device), state
    H = cfg.hangover_frames
    t = torch.arange(1, n_frames + 1, device=feats.device)[:, None]
    speech = energy > cfg.energy_threshold                     # (F, B)
    # The countdown after frame t (1-based): H − (t − s) from the last
    # speech frame s <= t, else the carried hang − t (int64: no wrap).
    last = torch.cummax(torch.where(speech, t, 0), dim=0).values
    count = torch.where(last > 0, last + H, state.hang.to(torch.int64)) - t
    # The gate: speech, or a countdown left from the frame before.
    gate = speech | torch.cat([state.hang[None] > 0, count[:-1] > 0])
    hang = count[-1].clamp(min=0)
    if H < 0:                      # a speech frame sets it unfloored
        hang = torch.where(speech[-1], H, hang)
    # Features of the last gated frame at or before t; frame 0 is the
    # carried hold.
    src = torch.cummax(torch.where(gate, t, 0), dim=0).values
    held = torch.cat([state.hold[None], feats])
    out = held.gather(0, src[..., None].expand(-1, -1, feats.shape[-1]))
    return out, gate, VADState(hold=out[-1], hang=hang.to(torch.int32))


def vad_gate_loop(feats: torch.Tensor, energy: torch.Tensor, state: VADState,
                  cfg: VADConfig) -> tuple[torch.Tensor, torch.Tensor,
                                           VADState]:
    """The reference's frame-by-frame gate (``repro/frontend/vad.py``'s
    scan body), same arguments and returns as ``vad_gate``."""
    hold, hang = state.hold, state.hang
    outs, gates = [], []
    for x, e in zip(feats, energy):
        speech = e > cfg.energy_threshold                      # (B,)
        gate = speech | (hang > 0)
        hang = torch.where(speech, torch.full_like(hang, cfg.hangover_frames),
                           torch.clamp(hang - 1, min=0))
        hold = torch.where(gate[:, None], x, hold)
        outs.append(hold)
        gates.append(gate)
    if not outs:
        return feats, torch.zeros(energy.shape, dtype=torch.bool,
                                  device=feats.device), state
    return (torch.stack(outs), torch.stack(gates),
            VADState(hold=hold, hang=hang))
