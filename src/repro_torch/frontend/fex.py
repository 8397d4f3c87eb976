"""Serial IIR BPF-based feature extractor (FEx) — PyTorch port.

Pipeline (paper Fig. 4):  12-bit audio @ 8 kHz
  → bank of 4th-order IIR BPFs (two cascaded biquads per channel)
  → envelope detector (full-wave rectify + one-pole low-pass)
  → frame decimation (16 ms shift)
  → log₂ compression, normalization
  → 12-bit feature vectors (C channels per 16 ms frame).

Two float paths, the same arithmetic in the same order (the reference's
``repro/frontend/fex.py`` op order), and the integer datapath:

  * ``backend="xla"``    — the plain loop (``batched_iir_fex_ref``):
    frames outer, samples inner, one ``fex_sample_step`` per sample.  The
    name follows the reference so call sites read alike.
  * ``backend="pallas"`` — ``batched_iir_fex``: on a CUDA tensor ONE
    launch of the hand-written kernel per chunk; on a CPU tensor the
    plain loop.
  * ``backend="pallas-int"`` — the integer-code kernel
    (``batched_iir_fex_int``) on quantized coefficients, audio and state;
    returns grid-exact floats.

Both carry an explicit ``FExState`` so audio can be streamed in chunks
with invisible boundaries.  The channel geometry and coefficient
quantization follow the reference (see its faithfulness notes): 16
Mel-spaced channels, 100 Hz – 3.95 kHz, channels 4..13 selected; b
coefficients on 12 bits, a on 8.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.quantize import qformat_for, quantize_audio_12b
from repro_torch.frontend import filters
from repro_torch.kernels.iir_fex import (STATE_ROWS, batched_iir_fex,
                                         batched_iir_fex_ref,
                                         pack_coefficients)

FRAME_SHIFT = 128          # samples @ 8 kHz = 16 ms
SELECT_10 = tuple(range(4, 14))


@dataclasses.dataclass(frozen=True)
class FExConfig:
    fs: float = 8000.0
    n_channels: int = 16
    fmin: float = 100.0
    fmax: float = 3950.0
    selection: tuple[int, ...] = SELECT_10
    frame_shift: int = FRAME_SHIFT
    env_tau_s: float = 0.020          # envelope LP time constant
    log_eps: float = 2.0 ** -11       # one 12-bit LSB
    b_bits: int = 12                  # mixed-precision coefficient widths
    a_bits: int = 8
    quantize_coeffs: bool = True

    @property
    def n_active(self) -> int:
        return len(self.selection)

    @property
    def env_alpha(self) -> float:
        return float(1.0 - np.exp(-1.0 / (self.fs * self.env_tau_s)))


class FExState(NamedTuple):
    """Carried FEx state: all on-chip registers of the filter datapath.

    ``filt``: (B, 4, C) DF2T registers (2 sections × 2 per channel);
    ``env``:  (B, C) envelope-detector output.
    Packed to the kernel's (B, 5, C) layout at the call boundary.
    """

    filt: torch.Tensor
    env: torch.Tensor


def init_fex_state(batch: int, n_channels: int, device="cpu",
                   dtype=torch.float32) -> FExState:
    """Quiescent filters, zero envelope: float32 registers on the float
    path, int16 codes in the int8 serving engine."""
    return FExState(
        filt=torch.zeros((batch, 4, n_channels), dtype=dtype, device=device),
        env=torch.zeros((batch, n_channels), dtype=dtype, device=device))


def _pack_state(state: FExState) -> torch.Tensor:
    """FExState → the kernels' contiguous (B, 5, C) buffer layout
    (dtype-preserving)."""
    return torch.cat([state.filt, state.env[:, None, :]], dim=1)


def _unpack_state(buf: torch.Tensor) -> FExState:
    return FExState(filt=buf[:, :STATE_ROWS - 1], env=buf[:, STATE_ROWS - 1])


def fex_scan(audio, coef, state: FExState | None = None, *,
             frame_shift: int = FRAME_SHIFT, env_alpha: float = 0.0606,
             log_eps: float = 2.0 ** -11, compress: bool = True,
             backend: str = "xla", block_b: int | None = None,
             unroll: int | None = None, b_bits: int = 12, a_bits: int = 8,
             coef_formats=None, consult_cache: bool = True
             ) -> tuple[torch.Tensor, FExState]:
    """Run the FEx over a chunk of audio, carrying explicit state.

    Args:
      audio: (B, T) float samples in [-1, 1) (callers quantize to the
        12-bit grid; trailing ``T % frame_shift`` samples are ignored —
        carry them to the next chunk).
      coef: (6, C) packed coefficient rows (``pack_coefficients``), on
        the audio's device.
      state: a carried ``FExState`` (None = quiescent filters).
      frame_shift: samples per decision frame (128 = 16 ms @ 8 kHz).
      env_alpha: envelope one-pole low-pass coefficient.
      log_eps: log₂-compression epsilon (one 12-bit LSB).
      compress: log₂ + normalize + 12-bit quantization (the serving
        output format); False returns raw envelopes.
      backend: "xla" (the plain loop), "pallas" (the kernel wrapper) or
        "pallas-int" (the integer-code kernel wrapper: 12-bit audio,
        16-bit registers, mixed-precision coefficient codes; returns
        grid-exact floats, bit-true against ``core.fixed_point.
        int_fex_scan``).
      block_b: streams per kernel launch (the kernels' batch tile).
      unroll: the kernels' per-sample loop unroll factor (must divide
        ``frame_shift``; bit-exact at any legal value).  Like
        ``block_b``, ``None`` consults the ``kernels.autotune`` cache and
        otherwise keeps the default launch; "xla" ignores both.
      b_bits / a_bits: coefficient word widths for the "pallas-int"
        format derivation when ``coef_formats`` is not given.
      coef_formats: the ``sos_formats`` pair (what ``FeatureExtractor``
        passes); without it "pallas-int" derives the formats from the
        packed rows (equivalent for symmetric-form banks).
      consult_cache: False leaves a ``None`` knob at the default launch
        without reading the cache (a session passes the configuration it
        looked up once).

    Returns:
      (features (B, T // frame_shift, C), new ``FExState``).  Processing
      [a|b] with the state carried equals the concatenation in one call.
    """
    B = audio.shape[0]
    C = coef.shape[1]
    if state is None:
        state = init_fex_state(B, C, audio.device)
    kw = dict(frame_shift=frame_shift, env_alpha=env_alpha, log_eps=log_eps,
              compress=compress)
    if backend == "pallas":
        if consult_cache and (block_b is None or unroll is None):
            from repro_torch.kernels import autotune
            tuned = autotune.resolve(
                "batched_iir_fex", (B, C, frame_shift), "float32", 0.0,
                device=audio.device, B=B, frame_shift=frame_shift)
            block_b = block_b if block_b is not None else tuned.get("block_b")
            unroll = unroll if unroll is not None else tuned.get("unroll")
        feats, buf = batched_iir_fex(audio.float().contiguous(), coef,
                                     _pack_state(state), block_b=block_b,
                                     unroll=unroll, **kw)
    elif backend == "pallas-int":
        feats, buf = _fex_scan_int(audio, coef, _pack_state(state),
                                   frame_shift=frame_shift,
                                   env_alpha=env_alpha, log_eps=log_eps,
                                   compress=compress, b_bits=b_bits,
                                   a_bits=a_bits, coef_formats=coef_formats,
                                   block_b=block_b, unroll=unroll,
                                   consult_cache=consult_cache)
    elif backend == "xla":
        feats, buf = batched_iir_fex_ref(audio, coef, _pack_state(state),
                                         **kw)
    else:
        raise ValueError(f"unknown FEx backend: {backend!r}")
    return feats, _unpack_state(buf)


def _fex_scan_int(audio, coef, buf, *, frame_shift, env_alpha, log_eps,
                  compress, b_bits, a_bits, coef_formats, block_b, unroll,
                  consult_cache):
    """``fex_scan(backend="pallas-int")``: quantize the coefficient bank
    onto its mixed-precision grids, run the integer kernel wrapper on
    codes, and hand back grid-exact floats so the float state carry
    round-trips bit-true."""
    from repro_torch.core import fixed_point as fp
    if not compress:
        raise ValueError("pallas-int FEx always compresses (the 12-bit "
                         "feature grid IS its output format)")
    coef_np = coef.detach().cpu().numpy().astype(np.float64)
    if coef_formats is not None:
        b_fmt, a_fmt = coef_formats
    else:
        # Rows [0, 3] are the b family (b1 = 0, b2 = −b0, so max |b| is
        # the bank's), [1, 2, 4, 5] the a family.
        b_fmt = qformat_for(float(np.max(np.abs(coef_np[[0, 3]]))), b_bits)
        a_fmt = qformat_for(float(np.max(np.abs(coef_np[[1, 2, 4, 5]]))),
                            a_bits)
    coef_codes, ffmt = fp.quantize_fex(coef_np, env_alpha, b_fmt.frac_bits,
                                       a_fmt.frac_bits, log_eps=log_eps)
    audio_codes = fp.to_code(audio.float(), ffmt.feat_frac, 16, torch.int16)
    feats_c, codes = fp.int_fex_scan(
        audio_codes.contiguous(), coef_codes.to(audio.device),
        fp.fex_state_to_codes(buf.float(), ffmt).contiguous(), ffmt,
        frame_shift=frame_shift, backend="pallas", block_b=block_b,
        unroll=unroll, consult_cache=consult_cache)
    return (fp.from_code(feats_c, ffmt.feat_frac),
            fp.fex_state_from_codes(codes, ffmt))


def frames_per_second(cfg: FExConfig) -> float:
    """Decision frames per second of audio (62.5 at 8 kHz, 128 samples)."""
    return cfg.fs / cfg.frame_shift


def build_sos_bank(cfg: FExConfig) -> np.ndarray:
    """(C_active, 2, 6) SOS bank for the selected channels."""
    bank = filters.make_filterbank(cfg.n_channels, cfg.fmin, cfg.fmax, cfg.fs)
    bank = bank[list(cfg.selection)]
    if cfg.quantize_coeffs:
        bank = quantize_sos(bank, cfg.b_bits, cfg.a_bits)
    return bank


def quantize_sos(bank: np.ndarray, b_bits: int, a_bits: int) -> np.ndarray:
    """Mixed-precision coefficient quantization (paper §II-C3).

    Integer bits per family from the dynamic range across the whole bank,
    remaining bits to the fraction.  b and a are quantized independently.
    """
    bank = np.asarray(bank, dtype=np.float64).copy()
    b_fmt, a_fmt = sos_formats(bank, b_bits, a_bits)
    bank[..., :3] = b_fmt.quantize(bank[..., :3])
    bank[..., 4:] = a_fmt.quantize(bank[..., 4:])
    return bank


def sos_formats(bank: np.ndarray, b_bits: int, a_bits: int):
    b_fmt = qformat_for(float(np.max(np.abs(bank[..., :3]))), b_bits)
    a_fmt = qformat_for(float(np.max(np.abs(bank[..., 4:]))), a_bits)
    return b_fmt, a_fmt


class FeatureExtractor:
    """Callable FEx: audio (B, T) float in [-1,1) → 12-bit features (B, F, C)
    through the kernel wrapper (``batched_iir_fex``).  The coefficients are
    kept on the CPU and moved to the audio's device per call; a serving
    session keeps its own device copy.  ``coef_formats`` are the
    mixed-precision coefficient formats of the float32 bank, as the
    reference derives them.
    """

    def __init__(self, cfg: FExConfig | None = None):
        self.cfg = cfg or FExConfig()
        self.sos = build_sos_bank(self.cfg).astype(np.float32)
        self.coef = pack_coefficients(self.sos)
        self.coef_formats = sos_formats(self.sos, self.cfg.b_bits,
                                        self.cfg.a_bits)

    def __call__(self, audio) -> torch.Tensor:
        feats, _ = self.scan(audio, None)
        return feats

    def scan(self, audio, state: FExState | None
             ) -> tuple[torch.Tensor, FExState]:
        """Streaming entry point: 12-bit-quantize a chunk of raw audio and
        run it through the bank, carrying ``state`` across chunks."""
        cfg = self.cfg
        audio = quantize_audio_12b(audio.float())
        return fex_scan(
            audio, self.coef.to(audio.device), state,
            frame_shift=cfg.frame_shift, env_alpha=cfg.env_alpha,
            log_eps=cfg.log_eps, compress=True, backend="pallas")
