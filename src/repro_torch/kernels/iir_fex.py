"""Batched IIR band-pass feature extractor: audio in, 12-bit features out.

``batched_iir_fex`` is the wrapper of the CUDA kernel ``csrc/iir_fex.cu``
(the port of the Pallas kernel ``repro/kernels/iir_fex.py::
batched_iir_fex``).  ``batched_iir_fex_ref`` is its plain PyTorch version:
a Python loop over samples calling ``fex_sample_step``, frames outer and
samples inner, exactly like the JAX package's ``_fex_scan_xla``.

``batched_iir_fex_int`` is the integer-code variant, the wrapper of
``csrc/iir_fex_int.cu`` (the port of ``batched_iir_fex_int``); its plain
version ``batched_iir_fex_int_ref`` loops over
``core.fixed_point.int_fex_sample_step`` and ``int_compress_env`` in the
order of the reference's ``_int_fex_scan_xla``.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.

Both take the reference's launch knobs (``kernels/autotune.py``):
``block_b`` (streams per launch: ``B / block_b`` launches over
consecutive slices of streams; the plain version runs the slices and
stitches the state back together) and ``unroll`` (the unroll factor of
the kernel's per-sample loop: the library built for it,
``build.variant(..., FEX_UNROLL=unroll)``; the plain version validates
it).  ``None`` is the default launch; every value is bit for bit the
default's.  ``iir_fex`` is the reference's single-stream wrapper.

State layout (B, 5, C) float32, rows = [s0_1, s0_2, s1_1, s1_2, env]
(section-0 DF2T registers, section-1 DF2T registers, envelope).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.autotune import validate_block_b, validate_divisor
from repro_torch.kernels.xla_math import INV_LN2, fma, ftz, xla_log

STATE_ROWS = 5      # [s0_1, s0_2, s1_1, s1_2, env]

# The feature grid is fixed by the IC: 12-bit features, log2 range
# [-11, 0] mapped to [0, 1] (one 12-bit LSB of headroom below 1.0).
_FEAT_STEP = 2.0 ** -11
_LOG_RANGE = 11.0
_INV_LOG_RANGE = float(np.float32(1.0) / np.float32(_LOG_RANGE))


def fex_sample_step(x_col, s, coef, env_alpha):
    """Advance every (stream, channel) cascade by ONE audio sample.

    x_col: (B,) sample per stream; s: (B, 5, C) state; coef: (6, C) rows
    [b0_0, a1_0, a2_0, b0_1, a1_1, a2_1] in the symmetric form (b1 = 0,
    b2 = −b0).  Returns the new (B, 5, C) state.

    The reference's op order, rounded where XLA on the CPU rounds: its
    scan body contracts the products marked ``fma`` into one fused
    multiply-add each (of a difference of two products, the first), and
    it flushes denormal results to zero, so registers that decay in
    silence reach exactly 0 at the same sample (see ``xla_math``).
    """
    b0_0, a2_0, b0_1, a2_1 = coef[0], coef[2], coef[3], coef[5]
    x = x_col[:, None]                          # (B, 1) → broadcast lanes
    # The seven multiply-adds, as XLA forms them, in three dependent
    # levels of one batched ``fma`` each (the plain loop pays per op):
    #   y0    = b0_0·x + s0_1
    #   ns0_1 = −a1_0·y0 + s0_2      ns0_2 = −b0_0·x − (a2_0·y0)
    #   y1    = b0_1·y0 + s1_1
    #   ns1_1 = −a1_1·y1 + s1_2      ns1_2 = −b0_1·y0 − (a2_1·y1)
    #   env   = (1−α)·env + (α·|y1|)
    # (parenthesised products round, and flush, on their own).
    y0 = fma(b0_0, x, s[:, 0])
    ns0_1, ns0_2, y1 = fma(
        torch.stack([-coef[1], -b0_0, b0_1]),
        torch.stack([y0, x.expand_as(y0), y0], dim=1),
        torch.stack([s[:, 1], -ftz(a2_0 * y0), s[:, 2]], dim=1)).unbind(1)
    one_minus_alpha = torch.full_like(b0_0, 1.0 - env_alpha)
    level3 = fma(
        torch.stack([-coef[4], -b0_1, one_minus_alpha]),
        torch.stack([y1, y0, s[:, 4]], dim=1),
        torch.stack([s[:, 3], -ftz(a2_1 * y1),
                     ftz(env_alpha * torch.abs(y1))], dim=1))
    return torch.cat([torch.stack([ns0_1, ns0_2], dim=1), level3], dim=1)


def compress_env(env, log_eps):
    """In-datapath feature compression: log₂ + normalize + 12-bit quantize.

    env (..., C) → features on the 12-bit Q0.11 grid in [-1, 1-2^-11].
    As XLA compiles the reference: its log₂ (``xla_math``), the scale by
    1/ln 2 fused with the ``+ 11``, and the division by 11 rewritten into
    a multiplication by ``float32(1/11)``.
    """
    v = fma(xla_log(env + log_eps), INV_LN2, _LOG_RANGE) * _INV_LOG_RANGE
    v = torch.clip(v, -1.0, 1.0 - _FEAT_STEP)
    return torch.clip(torch.round(v / _FEAT_STEP) * _FEAT_STEP,
                      -1.0, 1.0 - _FEAT_STEP)


def _check_args(x, coef, state):
    if x.dim() != 2 or coef.dim() != 2 or coef.shape[0] != 6:
        raise ValueError(f"expected x (B, T) and coef (6, C), got "
                         f"{tuple(x.shape)} and {tuple(coef.shape)}")
    B, C = x.shape[0], coef.shape[1]
    if tuple(state.shape) != (B, STATE_ROWS, C):
        raise ValueError(f"state shape {tuple(state.shape)} != "
                         f"{(B, STATE_ROWS, C)}")
    if not (x.device == coef.device == state.device):
        raise ValueError(f"x, coef and state must share one device, got "
                         f"{x.device}, {coef.device}, {state.device}")


def _knobs(kernel: str, B: int, frame_shift: int, block_b, unroll):
    """The reference's knob checks: (block_b or B, unroll or None)."""
    bb = validate_block_b(kernel, B, block_b)
    validate_divisor(kernel, "unroll", unroll, "frame_shift", frame_shift)
    return bb, unroll


def _by_slices(fn, bb: int, x, state):
    """``fn(x, state)`` over consecutive slices of ``bb`` streams, the
    features and states concatenated back (one call when bb == B)."""
    B = x.shape[0]
    if bb == B:
        return fn(x, state)
    outs = [fn(x[b0:b0 + bb], state[b0:b0 + bb]) for b0 in range(0, B, bb)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def batched_iir_fex_ref(x, coef, state, *, frame_shift: int = 128,
                        env_alpha: float = 0.0606,
                        log_eps: float = 2.0 ** -11, compress: bool = True,
                        block_b: int | None = None,
                        unroll: int | None = None):
    """Plain PyTorch version of ``batched_iir_fex`` (same arguments and
    returns): a loop over samples calling ``fex_sample_step``, frames
    outer, in the reference's op order; ``block_b`` slices of streams."""
    _check_args(x, coef, state)
    bb, _ = _knobs("batched_iir_fex", x.shape[0], frame_shift, block_b,
                   unroll)
    return _by_slices(
        lambda xs, st: _fex_ref(xs, coef, st, frame_shift=frame_shift,
                                env_alpha=env_alpha, log_eps=log_eps,
                                compress=compress), bb, x, state)


def _fex_ref(x, coef, state, *, frame_shift, env_alpha, log_eps, compress):
    B, T = x.shape
    C = coef.shape[1]
    n_frames = T // frame_shift
    x = x[:, :n_frames * frame_shift].float()
    coef = coef.float()
    s = state.float()
    if n_frames:
        s = ftz(s)                   # XLA reads denormals as zero
    feats = []
    for f in range(n_frames):
        for k in range(f * frame_shift, (f + 1) * frame_shift):
            s = fex_sample_step(x[:, k], s, coef, env_alpha)
        env = s[:, STATE_ROWS - 1]
        feats.append(compress_env(env, log_eps) if compress else env)
    if not feats:
        return x.new_zeros((B, 0, C)), s
    return torch.stack(feats, dim=1), s


# The float kernel's pipeline (csrc/iir_fex.cu): a CTA serves FEX_LANES
# (stream, channel) pairs with four warps (feed, section 0, section 1,
# envelope), which hand tiles of FEX_TILE samples on through rings of
# FEX_X_STAGES (audio) and FEX_STAGES (y0, y1) slots, each lane's row
# padded by 4 floats.  The kernel launches with the plan below and
# refuses one it cannot run.
FEX_LANES, FEX_TILE, FEX_X_STAGES, FEX_STAGES, FEX_THREADS = 32, 64, 4, 2, 128


def fex_launch_plan(B: int, C: int) -> dict:
    """The float FEx kernel's launch for B streams of C channels (one
    launch; ``block_b`` launches take the plan of ``block_b`` streams):
    ``ctas`` (one per FEX_LANES pairs), ``threads`` and dynamic
    ``smem_bytes`` (the audio, y0 and y1 rings, float32)."""
    if B < 1 or C < 1:
        raise ValueError(f"batched_iir_fex: needs B >= 1 and C >= 1, "
                         f"got B={B}, C={C}")
    slots = FEX_X_STAGES + 2 * FEX_STAGES
    return {"ctas": -(-B * C // FEX_LANES), "threads": FEX_THREADS,
            "smem_bytes": 4 * slots * FEX_LANES * (FEX_TILE + 4)}


def library(name: str, unroll: int | None):
    """The build key of a FEx kernel's library for ``unroll`` (None: the
    default instance).  Both kernels run their per-sample loop over tiles
    of 64 samples, so every unroll of 64 or more is the fully unrolled
    tile: one library."""
    if unroll is None:
        return name
    return build.variant(name, FEX_UNROLL=min(unroll, FEX_TILE))


def _launcher(unroll: int | None = None):
    lib = build.load(library("iir_fex", unroll))
    fn = lib.iir_fex_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 5 + [i] * 5 + [f] * 3 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def batched_iir_fex(x, coef, state, *, frame_shift: int = 128,
                    env_alpha: float = 0.0606, log_eps: float = 2.0 ** -11,
                    compress: bool = True, block_b: int | None = None,
                    unroll: int | None = None):
    """Run the full FEx over a chunk of raw audio in ONE kernel launch.

    Args:
      x:     (B, T) float32 audio (T need not be frame-aligned; the
             trailing ``T % frame_shift`` samples are ignored — callers
             carry them to the next chunk).
      coef:  (6, C) float32 symmetric-form rows (``pack_coefficients``).
      state: (B, 5, C) float32 carried filter/envelope state.
      compress: in-kernel log₂ + 12-bit quantization (the deployed
             datapath); False emits raw pre-log envelopes.
      block_b: streams per launch (must divide B; default B, one launch).
      unroll: the per-sample loop's unroll factor (must divide
             ``frame_shift``; default the kernel's own tile loop).

    Returns (features (B, T // frame_shift, C), new state (B, 5, C)).
    Feeding ``[a | b]`` through two calls with the state carried equals
    one call on the concatenation.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/iir_fex.cu`` (contiguous float32 only),
    ``B / block_b`` times.
    """
    _check_args(x, coef, state)
    bb, unroll = _knobs("batched_iir_fex", x.shape[0], frame_shift,
                        block_b, unroll)
    if x.device.type == "cpu":
        return batched_iir_fex_ref(x, coef, state, frame_shift=frame_shift,
                                   env_alpha=env_alpha, log_eps=log_eps,
                                   compress=compress, block_b=block_b,
                                   unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"batched_iir_fex runs on cuda or cpu, not "
                         f"{x.device}")
    for name, t in (("x", x), ("coef", coef), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"batched_iir_fex: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"batched_iir_fex: {name} must be contiguous")
    B, T = x.shape
    C = coef.shape[1]
    n_frames = T // frame_shift
    feats = torch.empty((B, n_frames, C), dtype=torch.float32,
                        device=x.device)
    if n_frames == 0 or B == 0 or C == 0:
        return feats, state
    state_out = torch.empty_like(state)
    plan = fex_launch_plan(bb, C)
    lib, fn = _launcher(unroll)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for b0 in range(0, B, bb):
            # 1 - env_alpha is formed in double and rounded to float once,
            # by the c_float argument, as the reference folds its
            # constants.
            err = fn(x.data_ptr(), coef.data_ptr(), state.data_ptr(),
                     feats.data_ptr(), state_out.data_ptr(), bb, T,
                     n_frames, C, frame_shift, env_alpha, 1.0 - env_alpha,
                     log_eps, int(compress), plan["ctas"], plan["threads"],
                     plan["smem_bytes"], b0, stream)
            build.check(lib, err, "iir_fex kernel launch")
            batched_iir_fex.launches += 1
    return feats, state_out


batched_iir_fex.launches = 0


# --------------------------------------------------------------- int variant
def batched_iir_fex_int_ref(x, coef, state, *, fmt, frame_shift: int = 128,
                            block_b: int | None = None,
                            unroll: int | None = None):
    """Plain PyTorch version of ``batched_iir_fex_int`` (same arguments
    and returns): frames outer, one ``int_fex_sample_step`` per sample,
    ``int_compress_env`` after each frame, int32 arithmetic;
    ``block_b`` slices of streams."""
    _check_args(x, coef, state)
    bb, _ = _knobs("batched_iir_fex_int", x.shape[0], frame_shift, block_b,
                   unroll)
    return _by_slices(
        lambda xs, st: _fex_int_ref(xs, coef, st, fmt=fmt,
                                    frame_shift=frame_shift), bb, x, state)


def _fex_int_ref(x, coef, state, *, fmt, frame_shift):
    from repro_torch.core.fixed_point import (int_compress_env,
                                              int_fex_sample_step)
    B, T = x.shape
    C = coef.shape[1]
    n_frames = T // frame_shift
    if n_frames == 0:
        return (torch.zeros((B, 0, C), dtype=torch.int16, device=x.device),
                state.to(torch.int16))
    xi = x[:, :n_frames * frame_shift].to(torch.int32)
    coef = coef.to(torch.int32)
    s = state.to(torch.int32)
    feats = []
    for f in range(n_frames):
        for k in range(f * frame_shift, (f + 1) * frame_shift):
            s = int_fex_sample_step(xi[:, k], s, coef, fmt)
        feats.append(int_compress_env(s[:, STATE_ROWS - 1], fmt))
    return torch.stack(feats, dim=1).to(torch.int16), s.to(torch.int16)


# The integer kernel's pipeline (csrc/iir_fex_int.cu): a CTA serves
# FEX_INT_LANES (stream, channel) pairs with five warps (feed, section 0,
# mid, section 1, envelope), which hand tiles of FEX_INT_TILE samples on
# through FEX_INT_STAGES ring slots each.  The kernel launches with the
# plan below and refuses one it cannot run.
FEX_INT_LANES, FEX_INT_TILE, FEX_INT_STAGES, FEX_INT_THREADS = 32, 64, 2, 160


def fex_int_launch_plan(B: int, C: int) -> dict:
    """The integer FEx kernel's launch for B streams of C channels (one
    launch; ``block_b`` launches take the plan of ``block_b`` streams):
    ``ctas`` (one per FEX_INT_LANES pairs), ``threads`` and dynamic
    ``smem_bytes`` (the (P0, Q0), y0, (P1, Q1) and y1 rings)."""
    if B < 1 or C < 1:
        raise ValueError(f"batched_iir_fex_int: needs B >= 1 and C >= 1, "
                         f"got B={B}, C={C}")
    ring = FEX_INT_STAGES * FEX_INT_TILE * FEX_INT_LANES
    return {"ctas": -(-B * C // FEX_INT_LANES), "threads": FEX_INT_THREADS,
            "smem_bytes": ring * (8 + 4 + 8 + 4)}


def _int_launcher(unroll: int | None = None):
    lib = build.load(library("iir_fex_int", unroll))
    fn = lib.iir_fex_int_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 5 + [i] * 12 + [f] * 4 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_int_formats(fmt) -> None:
    for name in ("b_frac", "a_frac", "alpha_frac"):
        if not 1 <= getattr(fmt, name) <= 30:
            raise ValueError(f"batched_iir_fex_int: fmt.{name} must lie in "
                             f"[1, 30], got {getattr(fmt, name)}")
    for lo, hi in (("feat_frac", "sig_frac"), ("sig_frac", "env_frac")):
        if not 0 <= getattr(fmt, hi) - getattr(fmt, lo) <= 15:
            raise ValueError(f"batched_iir_fex_int: fmt.{hi} - fmt.{lo} "
                             f"must lie in [0, 15]")


def batched_iir_fex_int(x, coef, state, *, fmt, frame_shift: int = 128,
                        block_b: int | None = None,
                        unroll: int | None = None):
    """The integer FEx over a chunk of audio codes in ONE kernel launch
    (``B / block_b`` with ``block_b``).

    x: (B, T) int16 Q0.11 audio codes (trailing ``T % frame_shift``
    samples ignored); coef: (6, C) int32 coefficient codes
    (``core.fixed_point.quantize_fex``); state: (B, 5, C) int16 register
    codes; ``fmt``: the ``FexFormats``; ``block_b`` / ``unroll`` as in
    ``batched_iir_fex``.  Returns (feature codes (B, T // frame_shift, C)
    int16, new state (B, 5, C) int16).  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/iir_fex_int.cu`` (contiguous,
    exact dtypes only).
    """
    _check_args(x, coef, state)
    bb, unroll = _knobs("batched_iir_fex_int", x.shape[0], frame_shift,
                        block_b, unroll)
    if x.device.type == "cpu":
        return batched_iir_fex_int_ref(x, coef, state, fmt=fmt,
                                       frame_shift=frame_shift,
                                       block_b=block_b, unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"batched_iir_fex_int runs on cuda or cpu, not "
                         f"{x.device}")
    for name, t, dt in (("x", x, torch.int16), ("coef", coef, torch.int32),
                        ("state", state, torch.int16)):
        if t.dtype != dt:
            raise TypeError(f"batched_iir_fex_int: {name} must be {dt}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"batched_iir_fex_int: {name} must be "
                             f"contiguous")
    _check_int_formats(fmt)
    B, T = x.shape
    C = coef.shape[1]
    n_frames = T // frame_shift
    feats = torch.empty((B, n_frames, C), dtype=torch.int16, device=x.device)
    if n_frames == 0 or B == 0 or C == 0:
        return feats, state
    state_out = torch.empty_like(state)
    plan = fex_int_launch_plan(bb, C)
    lib, fn = _int_launcher(unroll)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for b0 in range(0, B, bb):
            # The float constants are powers of two (exact in float32) and
            # log_range, rounded to float32 once, as the plain version's
            # float32 tensor holds it.
            err = fn(x.data_ptr(), coef.data_ptr(), state.data_ptr(),
                     feats.data_ptr(), state_out.data_ptr(), bb, T,
                     n_frames, C, frame_shift, fmt.sig_frac - fmt.feat_frac,
                     fmt.b_frac, fmt.a_frac, fmt.env_frac - fmt.sig_frac,
                     fmt.alpha_frac, fmt.alpha_code, fmt.eps_code,
                     2.0 ** -fmt.env_frac, fmt.log_range,
                     float(1 << fmt.feat_frac), 1.0 - 2.0 ** -fmt.feat_frac,
                     plan["ctas"], plan["threads"], plan["smem_bytes"], b0,
                     stream)
            build.check(lib, err, "iir_fex_int kernel launch")
            batched_iir_fex_int.launches += 1
    return feats, state_out


batched_iir_fex_int.launches = 0


def init_fex_kernel_state(batch: int, n_channels: int,
                          device="cpu") -> torch.Tensor:
    """Zero (B, 5, C) carry — quiescent filters, zero envelope."""
    return torch.zeros((batch, STATE_ROWS, n_channels), dtype=torch.float32,
                       device=device)


def iir_fex(x, coef, *, frame_shift: int = 128,
            env_alpha: float = 0.0606) -> torch.Tensor:
    """Single-stream compatibility wrapper: (T,) audio → (F, C) raw
    (pre-log) envelope features, zero initial state; one launch of
    ``batched_iir_fex`` on a CUDA tensor, its plain version on a CPU one."""
    C = coef.shape[1]
    feats, _ = batched_iir_fex(
        x[None].float().contiguous(), coef,
        init_fex_kernel_state(1, C, x.device), frame_shift=frame_shift,
        env_alpha=env_alpha, compress=False)
    return feats[0]


def pack_coefficients(sos) -> torch.Tensor:
    """(C, 2, 6) SOS bank → (6, C) float32 symmetric-form coefficient rows
    (on the CPU; move it to the device it will run on)."""
    sos = np.asarray(sos)
    return torch.from_numpy(np.stack([
        sos[:, 0, 0], sos[:, 0, 4], sos[:, 0, 5],
        sos[:, 1, 0], sos[:, 1, 4], sos[:, 1, 5],
    ]).astype(np.float32))
