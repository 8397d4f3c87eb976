"""Fixed-point quantization utilities (Qm.n) with straight-through estimators.

Mirrors ``repro/core/quantize.py``: symmetric two's-complement fixed
point, value ∈ [-2^(int_bits), 2^(int_bits) - 2^-frac_bits], step
2^-frac_bits, total width = 1 (sign) + int_bits + frac_bits; ``WEIGHT_Q``
is the ΔRNN's 8-bit weight code.  ``ste_quantize`` is the QAT quantizer:
quantized forward, identity backward.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Two's-complement fixed-point format Q(int_bits).(frac_bits)."""

    int_bits: int
    frac_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def step(self) -> float:
        return float(2.0 ** -self.frac_bits)

    @property
    def max_val(self) -> float:
        return float(2.0 ** self.int_bits - 2.0 ** -self.frac_bits)

    @property
    def min_val(self) -> float:
        return float(-(2.0 ** self.int_bits))

    def quantize(self, x):
        """Round-to-nearest (half to even) + saturate; torch or numpy."""
        xp = torch if isinstance(x, torch.Tensor) else np
        q = xp.round(x / self.step) * self.step
        return xp.clip(q, self.min_val, self.max_val)

    def to_int(self, x):
        """Integer code, rounded half to even and saturated to the word:
        int32 for a tensor, int64 for a numpy array (as the reference)."""
        xp = torch if isinstance(x, torch.Tensor) else np
        lim = 2 ** (self.total_bits - 1)
        c = xp.clip(xp.round(x / self.step), -lim, lim - 1)
        return c.to(torch.int32) if xp is torch else c.astype(np.int64)

    def from_int(self, code):
        return code * self.step


def qformat_for(max_abs: float, total_bits: int) -> QFormat:
    """Pick integer bits from the dynamic range, give the rest to fraction
    (the paper's procedure: integer bits for a and b from their maximum
    values, then the fraction bits from the remaining budget)."""
    int_bits = max(0, int(np.ceil(np.log2(max(max_abs, 1e-12) + 1e-12))))
    frac_bits = max(0, total_bits - 1 - int_bits)
    return QFormat(int_bits=int_bits, frac_bits=frac_bits)


def ste_quantize(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Quantize with a straight-through gradient (identity backward): the
    reference's ``x + stop_gradient(q(x) - x)``, the same float ops."""
    return x + (fmt.quantize(x) - x).detach()


def quantize_audio_12b(x: torch.Tensor) -> torch.Tensor:
    """12-bit ADC model: x in [-1, 1) → Q0.11."""
    return QFormat(0, 11).quantize(torch.clip(x, -1.0, 1.0 - 2.0 ** -11))


# 8-bit weight format of the ΔRNN accelerator (two weights per 16-bit word).
WEIGHT_Q = QFormat(int_bits=0, frac_bits=7)           # Q0.7 ∈ [-1, 1)


def quantize_weights_8b(w: torch.Tensor, scale: float | None = None):
    """Per-tensor scaled 8-bit weights.  Returns (w_q, scale).

    The IC stores 8-bit weights; training uses a per-tensor power-of-two
    scale so the stored code is Q0.7.  The scale is found on the host in
    float64, as the reference finds it.
    """
    if scale is None:
        max_abs = float(w.detach().abs().max())
        scale = float(2.0 ** np.ceil(np.log2(max(max_abs, 1e-12))))
    return WEIGHT_Q.quantize(w / scale) * scale, scale
