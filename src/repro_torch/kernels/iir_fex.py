"""Batched IIR band-pass feature extractor: audio in, 12-bit features out.

``batched_iir_fex`` is the wrapper of the CUDA kernel ``csrc/iir_fex.cu``
(the port of the Pallas kernel ``repro/kernels/iir_fex.py::
batched_iir_fex``).  ``batched_iir_fex_ref`` is its plain PyTorch version:
a Python loop over samples calling ``fex_sample_step``, frames outer and
samples inner, exactly like the JAX package's ``_fex_scan_xla``.  The
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.

State layout (B, 5, C) float32, rows = [s0_1, s0_2, s1_1, s1_2, env]
(section-0 DF2T registers, section-1 DF2T registers, envelope).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

STATE_ROWS = 5      # [s0_1, s0_2, s1_1, s1_2, env]

# The feature grid is fixed by the IC: 12-bit features, log2 range
# [-11, 0] mapped to [0, 1] (one 12-bit LSB of headroom below 1.0).
_FEAT_STEP = 2.0 ** -11
_LOG_RANGE = 11.0


def fex_sample_step(x_col, s, coef, env_alpha):
    """Advance every (stream, channel) cascade by ONE audio sample.

    x_col: (B,) sample per stream; s: (B, 5, C) state; coef: (6, C) rows
    [b0_0, a1_0, a2_0, b0_1, a1_1, a2_1] in the symmetric form (b1 = 0,
    b2 = −b0).  Returns the new (B, 5, C) state.
    """
    b0_0, a1_0, a2_0 = coef[0], coef[1], coef[2]
    b0_1, a1_1, a2_1 = coef[3], coef[4], coef[5]
    x = x_col[:, None]                          # (B, 1) → broadcast lanes
    # section 0 (DF2T, symmetric numerator)
    y0 = b0_0 * x + s[:, 0]
    ns0_1 = -a1_0 * y0 + s[:, 1]
    ns0_2 = -b0_0 * x - a2_0 * y0
    # section 1
    y1 = b0_1 * y0 + s[:, 2]
    ns1_1 = -a1_1 * y1 + s[:, 3]
    ns1_2 = -b0_1 * y0 - a2_1 * y1
    # envelope detector: full-wave rectifier + one-pole low-pass
    env = (1.0 - env_alpha) * s[:, 4] + env_alpha * torch.abs(y1)
    return torch.stack([ns0_1, ns0_2, ns1_1, ns1_2, env], dim=1)


def compress_env(env, log_eps):
    """In-datapath feature compression: log₂ + normalize + 12-bit quantize.

    env (..., C) → features on the 12-bit Q0.11 grid in [-1, 1-2^-11].
    """
    # Divide by a tensor, not a Python float: on CUDA, PyTorch turns a
    # division by a host scalar into a multiplication by its reciprocal,
    # which can differ by an ulp from the true division the reference
    # and the kernel perform.
    log_range = torch.full((), _LOG_RANGE, dtype=env.dtype,
                           device=env.device)
    v = (torch.log2(env + log_eps) + _LOG_RANGE) / log_range
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


def batched_iir_fex_ref(x, coef, state, *, frame_shift: int = 128,
                        env_alpha: float = 0.0606,
                        log_eps: float = 2.0 ** -11, compress: bool = True):
    """Plain PyTorch version of ``batched_iir_fex`` (same arguments and
    returns): a loop over samples calling ``fex_sample_step``, frames
    outer, in the reference's op order."""
    _check_args(x, coef, state)
    B, T = x.shape
    C = coef.shape[1]
    n_frames = T // frame_shift
    x = x[:, :n_frames * frame_shift].float()
    coef = coef.float()
    s = state.float()
    feats = []
    for f in range(n_frames):
        for k in range(f * frame_shift, (f + 1) * frame_shift):
            s = fex_sample_step(x[:, k], s, coef, env_alpha)
        env = s[:, STATE_ROWS - 1]
        feats.append(compress_env(env, log_eps) if compress else env)
    if not feats:
        return x.new_zeros((B, 0, C)), s
    return torch.stack(feats, dim=1), s


def _launcher():
    lib = build.load("iir_fex")
    fn = lib.iir_fex_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, f, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def batched_iir_fex(x, coef, state, *, frame_shift: int = 128,
                    env_alpha: float = 0.0606, log_eps: float = 2.0 ** -11,
                    compress: bool = True):
    """Run the full FEx over a chunk of raw audio in ONE kernel launch.

    Args:
      x:     (B, T) float32 audio (T need not be frame-aligned; the
             trailing ``T % frame_shift`` samples are ignored — callers
             carry them to the next chunk).
      coef:  (6, C) float32 symmetric-form rows (``pack_coefficients``).
      state: (B, 5, C) float32 carried filter/envelope state.
      compress: in-kernel log₂ + 12-bit quantization (the deployed
             datapath); False emits raw pre-log envelopes.

    Returns (features (B, T // frame_shift, C), new state (B, 5, C)).
    Feeding ``[a | b]`` through two calls with the state carried equals
    one call on the concatenation.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/iir_fex.cu`` (contiguous float32 only).
    """
    _check_args(x, coef, state)
    if x.device.type == "cpu":
        return batched_iir_fex_ref(x, coef, state, frame_shift=frame_shift,
                                   env_alpha=env_alpha, log_eps=log_eps,
                                   compress=compress)
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
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # 1 - env_alpha is formed in double and rounded to float once, by
        # the c_float argument, as the reference folds its constants.
        err = fn(x.data_ptr(), coef.data_ptr(), state.data_ptr(),
                 feats.data_ptr(), state_out.data_ptr(), B, T, n_frames, C,
                 frame_shift, env_alpha, 1.0 - env_alpha, log_eps,
                 int(compress), stream)
    build.check(lib, err, "iir_fex kernel launch")
    batched_iir_fex.launches += 1
    return feats, state_out


batched_iir_fex.launches = 0


def init_fex_kernel_state(batch: int, n_channels: int,
                          device="cpu") -> torch.Tensor:
    """Zero (B, 5, C) carry — quiescent filters, zero envelope."""
    return torch.zeros((batch, STATE_ROWS, n_channels), dtype=torch.float32,
                       device=device)


def pack_coefficients(sos) -> torch.Tensor:
    """(C, 2, 6) SOS bank → (6, C) float32 symmetric-form coefficient rows
    (on the CPU; move it to the device it will run on)."""
    sos = np.asarray(sos)
    return torch.from_numpy(np.stack([
        sos[:, 0, 0], sos[:, 0, 4], sos[:, 0, 5],
        sos[:, 1, 0], sos[:, 1, 4], sos[:, 1, 5],
    ]).astype(np.float32))
