"""Golden fixed-point model of the ASIC datapath — PyTorch port of
``repro/core/fixed_point.py``.

The DeltaKWS IC is not a float machine: 12-bit audio and features, 8-bit
weights (two per 16-bit SRAM word), 16-bit filter/state registers and a
24-bit ΔRNN accumulator.  This module is that integer datapath as torch
ops on integer CODE tensors.  The same functions are the plain versions
of the two integer kernels (``kernels.iir_fex.batched_iir_fex_int_ref``
and ``kernels.delta_gru_seq.delta_gru_seq_int_ref`` loop over
``int_fex_sample_step`` and ``gru_frame_step``), and the CUDA kernels
``csrc/iir_fex_int.cu`` and ``csrc/delta_gru_seq_int.cu`` repeat their
arithmetic in the same order.

Conventions (as the reference):
  * A value ``v`` in format Q(i).(f) is stored as the integer CODE
    ``round(v * 2**f)``, saturated to its word width.  Arithmetic is
    int32 (it wraps like XLA's); narrower storage (int16 state, int8
    weights) is widened at the point of use.
  * Shifts round half up (``rshift_round``); a float intermediate is
    requantized with ``torch.round`` (half to even).
  * σ/tanh are the "ideal LUT": the float function of the dequantized,
    saturated pre-activation, requantized to the hidden grid.  They and
    the FEx's one log2 are the only float steps, and they are XLA's own
    expansions (``kernels.xla_math``), so every code equals the
    reference's (``tests/test_torch_fixed_point.py``).
  * PyTorch has no integer matrix product on CUDA.  ``_int_dot`` forms
    the exact product in float64: every term is an integer of at most
    2^16 · 2^7 = 2^23 and every partial sum at most K · 2^23 < 2^53 for
    any K below 2^30, so each float64 addition is exact in any order;
    the sum then wraps to int32 as XLA's int32 dot does.

Formats (the per-tensor QFormat table — DESIGN.md §9):

  tensor                format       storage   grid step
  audio sample          Q0.11        int16     2^-11
  FEx signal/registers  Q2.13        int16     2^-13
  FEx envelope          Q0.15        int16     2^-15
  FEx coeff b / a       Q*.{12,8}b   int32     from dynamic range
  feature / x̂           Q0.11        int16     2^-11
  hidden h / ĥ / gates  Q0.15        int16     2^-15
  ΔGRU weight           Q0.7 × 2^e   int8      per-tensor pow-2 e
  accumulator M, bias   Q5.18        int32     24-bit saturating
  FC logits             Q*.{22-e}    int32     —
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.delta_gru import DeltaGRUParams, DeltaState
from repro_torch.core.quantize import WEIGHT_Q
from repro_torch.kernels import delta_gru_seq as dgs
from repro_torch.kernels.gru_math import delta_branch, gru_gates
from repro_torch.kernels.platform import refuse_grad
from repro_torch.kernels.xla_math import (INV_LN2, fma, xla_log, xla_sigmoid,
                                          xla_tanh)

_NP_DTYPE = {torch.int8: np.int8, torch.int16: np.int16,
             torch.int32: np.int32, torch.int64: np.int64}


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like → numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------- primitives
def rshift_round(x, s: int):
    """Arithmetic right shift by ``s`` ≥ 1 with round-half-up."""
    return (x + (1 << (s - 1))) >> s


def align(x, shift: int):
    """Move between grids: ``shift`` ≥ 0 is an exact left shift, < 0 a
    rounded right shift (the only place precision can be dropped)."""
    if shift >= 0:
        return x << shift
    return rshift_round(x, -shift)


def align_pair(p, shift_x: int, shift_h: int):
    """``align`` across a fused ``[x-half | h-half]`` block whose halves
    sit on different grids: each half moves by its own shift."""
    if shift_x == shift_h:
        return align(p, shift_x)
    n = p.shape[-1] // 2
    return torch.cat([align(p[..., :n], shift_x),
                      align(p[..., n:], shift_h)], dim=-1)


def sat(x, bits: int):
    """Two's-complement saturation to a ``bits``-wide word."""
    lim = 1 << (bits - 1)
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, -lim, lim - 1)
    return np.clip(x, -lim, lim - 1)


def to_code(x, frac: int, bits: int, dtype=torch.int32):
    """Float value(s) → integer code on the 2^-frac grid, saturated.
    A tensor gives a tensor of ``dtype``, a numpy array a numpy array."""
    lim = 1 << (bits - 1)
    if isinstance(x, torch.Tensor):
        c = torch.clamp(torch.round(x * float(1 << frac)), -lim, lim - 1)
        return c.to(dtype)
    c = np.clip(np.round(np.asarray(x) * float(1 << frac)), -lim, lim - 1)
    return c.astype(_NP_DTYPE[dtype])


def from_code(c, frac: int):
    """Integer code → float32 value.  Exact for codes within 24 bits."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.float32) * float(2.0 ** -frac)
    return np.asarray(c).astype(np.float32) * float(2.0 ** -frac)


def _weight_exp(w) -> int:
    """Per-tensor power-of-two exponent: scale = 2^e covers max |w|."""
    max_abs = float(np.max(np.abs(_np(w))))
    return int(np.ceil(np.log2(max(max_abs, 1e-12))))


def _int_dot(a, b):
    """Exact integer ``a @ b`` as int32 on any device (see the module
    docstring: float64 holds every partial sum exactly)."""
    out = a.to(torch.float64) @ b.to(torch.float64)
    return out.to(torch.int64).to(torch.int32)


# ------------------------------------------------------------- ΔGRU formats
@dataclasses.dataclass(frozen=True)
class GruFormats:
    """Static format metadata of a promoted ΔGRU (+FC).  Field order and
    names are the reference's (the bundle's JSON record)."""

    feat_frac: int = 11      # x / x̂ grid (the 12-bit feature grid)
    hid_frac: int = 15       # h / ĥ / gate grid
    acc_frac: int = 18       # M accumulator grid
    acc_bits: int = 24       # accumulator word width (saturating)
    e_x: int = 0             # w_x scale exponent (w = code · 2^(e-7))
    e_h: int = 0             # w_h scale exponent
    e_fc: int = 0            # FC weight scale exponent

    @property
    def shift_x(self) -> int:
        """Δx·W_x product grid → accumulator grid."""
        return self.acc_frac - (self.feat_frac + 7 - self.e_x)

    @property
    def shift_h(self) -> int:
        """Δh·W_h product grid → accumulator grid."""
        return self.acc_frac - (self.hid_frac + 7 - self.e_h)

    @property
    def logit_frac(self) -> int:
        """FC output grid: h (Q0.hid) × w_fc (Q0.7 · 2^e_fc)."""
        return self.hid_frac + 7 - self.e_fc

    def th_codes(self, threshold: float) -> tuple[int, int]:
        """Δ_TH on the x- and h-comparison grids.  FLOOR, not round: for
        on-grid values k·2^-f the float gate ``|Δ| > th`` is exactly
        ``k > floor(th·2^f)``."""
        return (int(np.floor(threshold * (1 << self.feat_frac))),
                int(np.floor(threshold * (1 << self.hid_frac))))


class IntGruWeights(NamedTuple):
    """Promoted ΔGRU weights: int8 codes + bias on the accumulator grid."""

    w_x: torch.Tensor   # (I, 3H) int8, value = code · 2^(e_x - 7)
    w_h: torch.Tensor   # (H, 3H) int8, value = code · 2^(e_h - 7)
    b: torch.Tensor     # (3H,)  int32 on the accumulator grid


def quantize_gru(params, fmt: GruFormats | None = None
                 ) -> tuple[IntGruWeights, GruFormats]:
    """Fold float ``DeltaGRUParams`` (tensors or arrays) into the integer
    weight set, on the CPU.  Exponents per tensor from the trained
    dynamic range; the same numpy rounding as the reference, so the
    codes are identical."""
    fmt = fmt or GruFormats()
    e_x, e_h = _weight_exp(params.w_x), _weight_exp(params.w_h)
    fmt = dataclasses.replace(fmt, e_x=e_x, e_h=e_h)
    w_x = WEIGHT_Q.to_int(_np(params.w_x) / 2.0 ** e_x)
    w_h = WEIGHT_Q.to_int(_np(params.w_h) / 2.0 ** e_h)
    b = to_code(_np(params.b), fmt.acc_frac, fmt.acc_bits)
    return IntGruWeights(
        w_x=torch.from_numpy(w_x.astype(np.int8)),
        w_h=torch.from_numpy(w_h.astype(np.int8)),
        b=torch.from_numpy(b.astype(np.int32))), fmt


def init_int_delta_state(batch: int, input_dim: int, hidden_dim: int,
                         w: IntGruWeights) -> DeltaState:
    """Fresh-stream state in code domain, on the weights' device: int16
    h/x̂/ĥ, int32 m; m_x seeds at the bias codes so M == W x̂ + W ĥ + b
    holds on the accumulator grid."""
    dev = w.b.device
    z16 = lambda d: torch.zeros((batch, d), dtype=torch.int16, device=dev)
    return DeltaState(
        h=z16(hidden_dim), x_hat=z16(input_dim), h_hat=z16(hidden_dim),
        m_x=w.b.to(torch.int32).expand(batch, 3 * hidden_dim).contiguous(),
        m_h=torch.zeros((batch, 3 * hidden_dim), dtype=torch.int32,
                        device=dev))


# ------------------------------------------------------------ ΔGRU datapath
def int_delta_branch(v, v_hat, th_code):
    """The Δ encoder on integer codes (transmit iff |v − v̂| > Δ_TH)."""
    diff = v - v_hat
    mask = torch.abs(diff) > th_code
    delta = torch.where(mask, diff, torch.zeros_like(diff))
    new_v_hat = torch.where(mask, v, v_hat)
    return delta, new_v_hat, mask


def int_gru_gates(m, h, fmt: GruFormats):
    """Type-2 GRU nonlinearity in code domain (ideal-LUT σ/tanh).

    ``m`` is the FUSED ``[m_x | m_h]`` accumulator block, (B, 6H) int32;
    ``h`` (B, H) int32.  The op order is the reference's: the r/u gates
    share one dequant → σ → requant pass, and the candidate's r·m_hc
    product is formed in float32 (int32 would overflow), the power-of-
    two grid factors applied after it.
    """
    H = h.shape[-1]
    one = 1 << fmt.hid_frac
    step = float(2.0 ** -fmt.acc_frac)
    ru_f = xla_sigmoid((m[:, :2 * H] + m[:, 3 * H:5 * H]
                        ).to(torch.float32) * step)
    ru = torch.round(ru_f * one).to(torch.int32)
    r, u = ru[:, :H], ru[:, H:]
    c_pre = (m[:, 2 * H:3 * H].to(torch.float32)
             + r.to(torch.float32) * m[:, 5 * H:].to(torch.float32)
             * float(1.0 / one)) * step
    c = torch.round(xla_tanh(c_pre) * one).to(torch.int32)
    h_new = rshift_round(u * h + (one - u) * c, fmt.hid_frac)
    return sat(h_new, 16)


# Byte-plane packed dot: exact for contraction dims up to 2^9.
PACKED_DOT_MAX_K = 512


def packed_int8_dot(d, w_f32):
    """Exact Δ·W as ONE float32 matmul via byte-plane packing of the
    deltas (the reference's way round XLA's slow integer dot; the port's
    kernel accumulates int32 directly and does not use it).

    ``d = (d >> 8)·2^8 + (d & 0xFF)``; with |d| ≤ 2^16 both planes are
    within 2^8, every partial product within 2^15, and a K-term sum
    within 2^24 for K ≤ 2^9 — exact in float32.  ``w_f32`` (K, N) holds
    exact int8 code values.  Returns the (B, N) int32 product.
    """
    rows = d.shape[0]
    planes = torch.cat([d & 0xFF, d >> 8], dim=0).to(torch.float32)
    prod = (planes @ w_f32).to(torch.int32)
    return (prod[rows:] << 8) + prod[:rows]


def packed_int8_dot_pair(dx, dh, wx_f32, wh_f32):
    """Both ΔGRU contractions through the packed path, recombined once:
    the fused (B, 6H) ``[Δx·Wx | Δh·Wh]`` block."""
    rows = dx.shape[0]
    px = torch.cat([dx & 0xFF, dx >> 8], dim=0).to(torch.float32) @ wx_f32
    ph = torch.cat([dh & 0xFF, dh >> 8], dim=0).to(torch.float32) @ wh_f32
    prod = torch.cat([px, ph], dim=-1).to(torch.int32)
    return (prod[rows:] << 8) + prod[:rows]


def gru_frame_step(fmt: GruFormats | None, x, h, x_hat, h_hat, m,
                   w_x, w_h, th_x, th_h):
    """ONE ΔGRU frame on the fused ``[m_x | m_h]`` accumulator block.

    ``fmt=None`` is the identity-quant mode: float operands in the float
    ΔGRU's op order.  With a ``GruFormats`` everything is integer-code
    arithmetic: Δ-encode x and h, the exact int32 products, align each
    half to the accumulator grid, saturate once to ``acc_bits``, then the
    gates.

    Returns ``(h', x̂', ĥ', m', mask_x, mask_h)`` (int32 in int mode).
    """
    if fmt is None:
        n = m.shape[-1] // 2
        dx, x_hat, mask_x = delta_branch(x, x_hat, th_x)
        dh, h_hat, mask_h = delta_branch(h, h_hat, th_h)
        m = m + torch.cat([dx @ w_x, dh @ w_h], dim=-1)
        h = gru_gates(m[:, :n], m[:, n:], h, h.shape[-1])
        return h, x_hat, h_hat, m, mask_x, mask_h

    x = x.to(torch.int32)
    h32 = h.to(torch.int32)
    dx, x_hat, mask_x = int_delta_branch(x, x_hat.to(torch.int32), th_x)
    dh, h_hat, mask_h = int_delta_branch(h32, h_hat.to(torch.int32), th_h)
    p = torch.cat([_int_dot(dx, w_x), _int_dot(dh, w_h)], dim=-1)
    m = sat(m + align_pair(p, fmt.shift_x, fmt.shift_h), fmt.acc_bits)
    h_new = int_gru_gates(m, h32, fmt)
    return h_new, x_hat, h_hat, m, mask_x, mask_h


def int_gru_scan(w: IntGruWeights, fmt: GruFormats, xs_codes,
                 threshold: float, state: DeltaState | None = None, *,
                 backend: str = "xla", block_b: int | None = None,
                 block_t: int | None = None, packed: bool | None = None,
                 event_driven: bool = False, consult_cache: bool = True):
    """Run the integer ΔGRU over codes ``xs_codes`` (T, B, I) int16.

    ``backend="xla"`` is the plain loop (``delta_gru_seq_int_ref``, the
    name of the reference's golden scan); ``"pallas"`` the kernel wrapper
    ``delta_gru_seq_int`` — one launch of ``csrc/delta_gru_seq_int.cu``
    per call on a CUDA tensor, the plain loop on a CPU tensor.  Both are
    exact against each other on the card.  ``packed`` is the reference's
    numerics-invariant dot choice; it is checked, never used.
    Returns ``(hs_codes (T,B,H) int16, final DeltaState, nz_dx, nz_dh)``.

    ``block_b`` / ``block_t`` are the kernel's numerics-invariant launch
    knobs (``kernels.autotune``); left ``None``, "pallas" consults the
    autotune cache for this (shape, dtype, threshold bucket, device) and
    falls back to the default launch on a cold cache (``consult_cache``
    False: the default launch, no cache read).

    The kernel keeps its int8 weights in one thread block's shared
    memory; weights above that are REFUSED (``NotImplementedError``), as
    the reference refuses weights above its VMEM budget — there is no
    blocked integer fallback.

    ``event_driven`` enables active-slot compaction on the integer
    datapath (``kernels.compaction``): slots whose whole chunk of codes
    lies inside the integer Δ dead zone (|x − x̂| ≤ th_x) and whose
    carried state a one-frame probe proves a bitwise fixed point are
    skipped; the rest run gathered through ``backend``.  Bit for bit the
    dense scan; host-level (two host syncs per call), outputs on the
    device.
    """
    T, B, I = xs_codes.shape
    H = w.w_h.shape[0]
    if state is None:
        state = init_int_delta_state(B, I, H, w)
    th = fmt.th_codes(threshold)
    if event_driven:
        from repro_torch.kernels import compaction

        def run(xs_c, st):
            return int_gru_scan(w, fmt, xs_c, threshold, DeltaState(*st),
                                backend=backend, packed=packed)

        held = compaction.held_slots(xs_codes, state.x_hat, th[0])
        hs, st, nz_dx, nz_dh, _ = compaction.event_driven_seq(
            run, xs_codes, tuple(state), held)
        return hs, DeltaState(*st), nz_dx, nz_dh
    if backend == "pallas":
        _check_int_kernel_budget(I, H)
        if consult_cache and (block_b is None or block_t is None):
            from repro_torch.kernels import autotune
            tuned = autotune.resolve("delta_gru_seq_int", (B, I, H), "int8",
                                     threshold, device=xs_codes.device, B=B,
                                     T=T)
            block_b = block_b if block_b is not None else tuned.get("block_b")
            block_t = block_t if block_t is not None else tuned.get("block_t")
        fn = functools.partial(dgs.delta_gru_seq_int, packed=packed,
                               block_b=block_b, block_t=block_t)
    elif backend == "xla":
        fn = dgs.delta_gru_seq_int_ref
    else:
        raise ValueError(f"unknown int ΔGRU backend: {backend!r}")
    hs, final, nz_dx, nz_dh = fn(xs_codes, *state, w.w_x, w.w_h, th,
                                 fmt=fmt)
    return hs, DeltaState(*final), nz_dx, nz_dh


def _check_int_kernel_budget(I: int, H: int) -> None:
    """Refuse an int8 ΔGRU whose weights the kernel cannot hold."""
    need = dgs.int_seq_kernel_smem_bytes(I, H)
    if need > dgs.MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"int8 ΔGRU I={I}, H={H} needs {need} B of shared memory; "
            f"the delta_gru_seq_int kernel holds at most "
            f"{dgs.MAX_SMEM_BYTES} B (227 KB on Hopper) and the blocked "
            f"int fallback does not exist — use backend='xla'")


def masked_int_gru_scan(w: IntGruWeights, fmt: GruFormats, xs_codes,
                        threshold: float, state: DeltaState, awake):
    """Wake-gated integer scan: the stage-1 half of the cascade on the
    deployed datapath.  ``awake`` is a (T, B) bool trace from the stage-0
    wake machine; on the frames where a slot sleeps its whole integer
    state (h, x̂, ĥ, the fused M) stays bit-frozen, hs repeats the frozen
    h codes and both transmit counts are zero.  One launch of the masked
    ``delta_gru_seq_int`` instantiation on a CUDA tensor, its plain
    version on a CPU tensor; weights above the kernel's shared memory are
    refused, as ``int_gru_scan`` refuses them.  Awake everywhere it is
    ``int_gru_scan`` bit for bit.  Returns ``(hs, final state, nz_dx,
    nz_dh)``."""
    T, B, I = xs_codes.shape
    H = w.w_h.shape[0]
    _check_int_kernel_budget(I, H)
    hs, final, nz_dx, nz_dh = dgs.delta_gru_seq_int(
        xs_codes, *state, w.w_x, w.w_h, fmt.th_codes(threshold), fmt=fmt,
        awake=awake)
    return hs, DeltaState(*final), nz_dx, nz_dh


# ----------------------------------------------------------------- FC head
def int_fc(h_codes, w_fc, b_fc):
    """FC on hidden codes: int8 weights, exact int32 accumulate; ``b_fc``
    is pre-shifted onto the logit grid.  |h| ≤ 2^15 and |w| ≤ 2^7, so
    the float64 product of ``_int_dot`` is exact."""
    return _int_dot(h_codes, w_fc) + b_fc.to(torch.int32)


def quantize_fc(w_fc, b_fc, fmt: GruFormats):
    """Fold the FC head: int8 weight codes + bias on the logit grid."""
    e_fc = _weight_exp(w_fc)
    fmt = dataclasses.replace(fmt, e_fc=e_fc)
    w = WEIGHT_Q.to_int(_np(w_fc) / 2.0 ** e_fc).astype(np.int8)
    b = to_code(_np(b_fc), fmt.logit_frac, 32)
    return torch.from_numpy(w), torch.from_numpy(b.astype(np.int32)), fmt


# ------------------------------------------------------------- FEx formats
@dataclasses.dataclass(frozen=True)
class FexFormats:
    """Static formats of the integer FEx datapath (field order and names
    are the reference's)."""

    sig_frac: int = 13       # Q2.13 signal / biquad registers
    env_frac: int = 15       # Q0.15 envelope
    feat_frac: int = 11      # Q0.11 features
    alpha_frac: int = 15     # envelope LP coefficient grid
    b_frac: int = 11         # biquad b-coefficient fraction bits
    a_frac: int = 6          # biquad a-coefficient fraction bits
    alpha_code: int = 1986   # round(env_alpha · 2^alpha_frac)
    log_range: float = 11.0  # log2 compression range (12-bit features)
    eps_code: int = 16       # log_eps on the envelope grid


STATE_ROWS = 5               # [s0_1, s0_2, s1_1, s1_2, env] — kernel layout


def quantize_fex(coef, env_alpha: float, b_frac: int, a_frac: int,
                 log_eps: float = 2.0 ** -11
                 ) -> tuple[torch.Tensor, FexFormats]:
    """Packed (6, C) float coefficients → (6, C) int32 codes (on the CPU)
    + formats.  ``b_frac``/``a_frac`` are the fraction bits of the
    mixed-precision coefficient formats (``frontend.fex.sos_formats``)."""
    coef = _np(coef).astype(np.float64)
    codes = np.empty_like(coef)
    codes[[0, 3]] = np.round(coef[[0, 3]] * (1 << b_frac))   # b0 rows
    codes[[1, 2, 4, 5]] = np.round(coef[[1, 2, 4, 5]] * (1 << a_frac))
    base = FexFormats(b_frac=b_frac, a_frac=a_frac)
    fmt = dataclasses.replace(
        base,
        alpha_code=int(round(env_alpha * (1 << base.alpha_frac))),
        eps_code=int(round(log_eps * (1 << base.env_frac))))
    return torch.from_numpy(codes.astype(np.int32)), fmt


def int_fex_sample_step(x_code, s, coef, fmt: FexFormats):
    """Advance every (stream, channel) cascade by ONE audio sample in code
    domain: each product requantized (round half up) and saturated to
    the 16-bit register grid, the serial MAC datapath's order.

    x_code: (B,) int32 Q0.11 audio codes; s: (B, 5, C) int32 register
    codes; coef: (6, C) int32.  Returns the new (B, 5, C) int32 state.
    """
    b0_0, a1_0, a2_0 = coef[0], coef[1], coef[2]
    b0_1, a1_1, a2_1 = coef[3], coef[4], coef[5]
    x = (x_code << (fmt.sig_frac - fmt.feat_frac))[:, None]  # → Q2.13
    # section 0 (DF2T, symmetric numerator)
    y0 = sat(rshift_round(b0_0 * x, fmt.b_frac) + s[:, 0], 16)
    ns0_1 = sat(rshift_round(-a1_0 * y0, fmt.a_frac) + s[:, 1], 16)
    ns0_2 = sat(rshift_round(-b0_0 * x, fmt.b_frac)
                + rshift_round(-a2_0 * y0, fmt.a_frac), 16)
    # section 1
    y1 = sat(rshift_round(b0_1 * y0, fmt.b_frac) + s[:, 2], 16)
    ns1_1 = sat(rshift_round(-a1_1 * y1, fmt.a_frac) + s[:, 3], 16)
    ns1_2 = sat(rshift_round(-b0_1 * y0, fmt.b_frac)
                + rshift_round(-a2_1 * y1, fmt.a_frac), 16)
    # envelope: full-wave rectify on the Q0.15 grid + one-pole low-pass
    y_env = sat(torch.abs(y1) << (fmt.env_frac - fmt.sig_frac), 16)
    one = 1 << fmt.alpha_frac
    env = rshift_round((one - fmt.alpha_code) * s[:, 4]
                       + fmt.alpha_code * y_env, fmt.alpha_frac)
    return torch.stack([ns0_1, ns0_2, ns1_1, ns1_2, env], dim=1)


def int_compress_env(env_code, fmt: FexFormats):
    """log₂ + normalize + quantize onto the 12-bit feature grid (the
    ideal-LUT log on the exact envelope code), as XLA compiles the
    reference: its log₂, the scale by 1/ln 2 fused with the
    ``+ log_range``, and the division by the constant ``log_range``
    rewritten into a multiplication by its float32 reciprocal."""
    inv_range = float(np.float32(1.0) / np.float32(fmt.log_range))
    x = (env_code + fmt.eps_code).to(torch.float32) * float(
        2.0 ** -fmt.env_frac)
    v = fma(xla_log(x), INV_LN2, fmt.log_range) * inv_range
    v = torch.clip(v, -1.0, 1.0 - 2.0 ** -fmt.feat_frac)
    # A negative envelope code (only a carried state can hold one) logs to
    # NaN; XLA, like the CUDA kernel's conversion, turns it into 0, where a
    # CPU cast would give -2^31.
    v = torch.nan_to_num(torch.round(v * (1 << fmt.feat_frac)), nan=0.0)
    return sat(v.to(torch.int32), 16)


def init_int_fex_state(batch: int, n_channels: int,
                       device="cpu") -> torch.Tensor:
    """Zero (B, 5, C) int16 carry — quiescent filters, zero envelope."""
    return torch.zeros((batch, STATE_ROWS, n_channels), dtype=torch.int16,
                       device=device)


def fex_state_to_codes(buf, fmt: FexFormats):
    """(B, 5, C) float state buffer → int16 codes (rows 0–3 on the signal
    grid, row 4 on the envelope grid).  Exact for on-grid floats."""
    filt = to_code(buf[:, :STATE_ROWS - 1], fmt.sig_frac, 16, torch.int16)
    env = to_code(buf[:, STATE_ROWS - 1:], fmt.env_frac, 16, torch.int16)
    return torch.cat([filt, env], dim=1)


def fex_state_from_codes(codes, fmt: FexFormats):
    """Inverse of ``fex_state_to_codes`` — always exact."""
    filt = from_code(codes[:, :STATE_ROWS - 1], fmt.sig_frac)
    env = from_code(codes[:, STATE_ROWS - 1:], fmt.env_frac)
    return torch.cat([filt, env], dim=1)


def int_fex_scan(audio_codes, coef_codes, state_codes, fmt: FexFormats, *,
                 frame_shift: int = 128, backend: str = "xla",
                 block_b: int | None = None, unroll: int | None = None,
                 consult_cache: bool = True):
    """Integer FEx over a chunk of audio codes (B, T) int16 Q0.11.

    ``backend="xla"`` is the plain loop (``batched_iir_fex_int_ref``);
    ``"pallas"`` the kernel wrapper ``batched_iir_fex_int`` (one launch
    of ``csrc/iir_fex_int.cu`` on a CUDA tensor).  Returns (feature
    codes (B, F, C) int16, new state codes (B, 5, C) int16).
    ``block_b`` / ``unroll`` are the kernel's numerics-invariant launch
    knobs; left ``None``, "pallas" consults the ``kernels.autotune``
    cache (the default launch on a cold cache; ``consult_cache`` False:
    the default launch, no cache read).
    """
    from repro_torch.kernels import iir_fex
    if backend == "pallas":
        if consult_cache and (block_b is None or unroll is None):
            from repro_torch.kernels import autotune
            B = audio_codes.shape[0]
            C = coef_codes.shape[1]
            tuned = autotune.resolve("batched_iir_fex_int",
                                     (B, C, frame_shift), "int16", 0.0,
                                     device=audio_codes.device, B=B,
                                     frame_shift=frame_shift)
            block_b = block_b if block_b is not None else tuned.get("block_b")
            unroll = unroll if unroll is not None else tuned.get("unroll")
        return iir_fex.batched_iir_fex_int(
            audio_codes, coef_codes, state_codes, fmt=fmt,
            frame_shift=frame_shift, block_b=block_b, unroll=unroll)
    if backend != "xla":
        raise ValueError(f"unknown int FEx backend: {backend!r}")
    return iir_fex.batched_iir_fex_int_ref(audio_codes, coef_codes,
                                           state_codes, fmt=fmt,
                                           frame_shift=frame_shift)


# ----------------------------------------------------- promotion + forward
@dataclasses.dataclass
class IntKwsBundle:
    """Everything the integer serving path consumes: the promoted weight
    codes (CPU tensors), the static formats, and the deployment Δ_TH.
    ``coef``/``ffmt`` are None until a FEx is folded in."""

    gru: IntGruWeights
    w_fc: torch.Tensor                  # (H, K) int8
    b_fc: torch.Tensor                  # (K,)  int32 on the logit grid
    gfmt: GruFormats
    threshold: float
    coef: torch.Tensor | None = None    # (6, C) int32
    ffmt: FexFormats | None = None


def bundle_to(bundle: IntKwsBundle, device) -> IntKwsBundle:
    """A copy of ``bundle`` with every code tensor on ``device``."""
    mv = lambda t: None if t is None else t.to(device)
    return dataclasses.replace(
        bundle, gru=IntGruWeights(*(mv(t) for t in bundle.gru)),
        w_fc=mv(bundle.w_fc), b_fc=mv(bundle.b_fc), coef=mv(bundle.coef))


def promote_kws(params, threshold: float, fex=None) -> IntKwsBundle:
    """Fold a float KWS parameter dict (w_x/w_h/b/w_fc/b_fc) into the
    integer bundle: int8 Q0.7×2^e weight codes, bias codes on the Q5.18
    accumulator grid, the static formats and Δ_TH.  ``fex`` (a
    ``frontend.fex.FeatureExtractor``) folds its coefficient bank in.
    Pure fold: the same numpy rounding as the reference's, so the codes
    are identical for the same float weights."""
    gru_p = DeltaGRUParams(params["w_x"], params["w_h"], params["b"])
    gru, gfmt = quantize_gru(gru_p)
    w_fc, b_fc, gfmt = quantize_fc(params["w_fc"], params["b_fc"], gfmt)
    bundle = IntKwsBundle(gru=gru, w_fc=w_fc, b_fc=b_fc, gfmt=gfmt,
                          threshold=float(threshold))
    return bundle if fex is None else fold_fex(bundle, fex)


def fold_fex(bundle: IntKwsBundle, fex) -> IntKwsBundle:
    """A COPY of ``bundle`` with ``fex``'s coefficient bank folded in
    (mixed-precision formats of the float64 bank, as the reference
    derives them).  No-op if a bank is already folded."""
    if bundle.ffmt is not None:
        return bundle
    from repro_torch.frontend.fex import build_sos_bank, sos_formats
    cfg = fex.cfg
    bank = build_sos_bank(cfg)
    b_fmt, a_fmt = sos_formats(bank, cfg.b_bits, cfg.a_bits)
    coef, ffmt = quantize_fex(fex.coef, cfg.env_alpha, b_fmt.frac_bits,
                              a_fmt.frac_bits, log_eps=cfg.log_eps)
    return dataclasses.replace(bundle, coef=coef, ffmt=ffmt)


def int_forward(bundle: IntKwsBundle, feats, *, backend: str = "xla"):
    """Integer mirror of ``models.kws.forward``: features (B, F, C) —
    float values on the 12-bit grid or int16 codes, on the bundle's
    device — to ``(logit_codes (B, K) int32, nz_dx, nz_dh)``.  The mean
    pool is an integer rounded division (the deploy-time head).  Integer
    codes carry no gradient: features that need one are refused."""
    refuse_grad("the integer datapath (int_forward)", feats)
    bundle = bundle_to(bundle, feats.device)
    fmt = bundle.gfmt
    if feats.is_floating_point():
        feats = to_code(feats, fmt.feat_frac, 16, torch.int16)
    xs = feats.movedim(1, 0).contiguous()              # (F, B, C)
    hs, _, nz_dx, nz_dh = int_gru_scan(bundle.gru, fmt, xs,
                                       bundle.threshold, backend=backend)
    F = hs.shape[0]
    h_sum = hs.to(torch.int32).sum(0, dtype=torch.int32)   # exact ≤ 2^21
    # Divide by a tensor: a Python divisor becomes a reciprocal multiply
    # on CUDA (see int_compress_env).
    n = torch.full((), F, dtype=torch.float32, device=hs.device)
    h_mean = torch.round(h_sum.to(torch.float32) / n).to(torch.int32)
    logits = int_fc(h_mean, bundle.w_fc, bundle.b_fc)
    return logits, nz_dx, nz_dh
