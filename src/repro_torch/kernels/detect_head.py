"""The detection head fused over a chunk: softmax → EMA → hysteresis latch.

``detect_head`` is the wrapper of the CUDA kernel ``csrc/detect_head.cu``.
It has no Pallas counterpart: in the JAX package the head is plain JAX
(``jax.nn.softmax`` in ``repro/launch/streaming.py::_detect_tail`` and
``repro/models/detector.py::detector_scan``) that XLA fuses into the
serving step.  Eager PyTorch cannot fuse a frame-sequential latch, and
a per-frame loop costs ~20 launches per frame, so the port runs the whole
chunk in one kernel.  ``detect_head_ref`` is its plain PyTorch version:
``xla_softmax`` then ``models.detector.detector_scan``.

``xla_softmax`` is ``jax.nn.softmax`` as XLA:CPU computes it:
``exp(x − max) / Σ exp``, with XLA's exp (``xla_math.xla_exp``), a max
that keeps NaN, results below 2^-126 flushed to zero, and the sum in
XLA's order — class by class from the first, in windows of 32 classes
when there are more than 32 (XLA pads the row to a multiple of 32 split
evenly at both ends, sums each window in order, then sums the windows).
A vectorised ``torch.sum`` rounds differently.

The wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import xla_math as xm
from repro_torch.models.detector import (DetectorConfig, DetectorState,
                                         detector_scan, keyword_thresholds)

MAX_CLASSES = 64            # two classes per lane of a 32-lane group
SUM_WINDOW = 32             # XLA:CPU's reduction window
BLOCK = 128                 # threads per CTA, at most


def xla_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order (see the module doc)."""
    K = e.shape[-1]
    if K <= SUM_WINDOW:
        s = e[..., 0]
        for k in range(1, K):
            s = s + e[..., k]
        return s
    n = -(-K // SUM_WINDOW)
    lo = (SUM_WINDOW * n - K) // 2
    parts = [xla_sum(e[..., max(SUM_WINDOW * w - lo, 0):
                       min(SUM_WINDOW * (w + 1) - lo, K)]) for w in range(n)]
    return xla_sum(torch.stack(parts, dim=-1))


def xla_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=-1)`` on XLA:CPU, float32, bit for bit."""
    m = torch.amax(x, dim=-1, keepdim=True)          # keeps NaN
    e = xm.xla_exp(xm.ftz(x - m))
    return xm.ftz(e / xla_sum(e)[..., None])


def lanes_per_slot(n_classes: int) -> int:
    """The kernel's group of lanes per slot: 16 up to 16 classes, else 32
    (one class per lane, two above 32 classes)."""
    return 16 if n_classes <= 16 else 32


def detect_launch_plan(batch: int, n_classes: int) -> tuple[int, int, int]:
    """(grid, block, dynamic shared bytes) of the kernel: a group of
    ``lanes_per_slot`` lanes per slot, up to ``BLOCK`` threads per CTA,
    and the per-keyword fire and release thresholds staged in shared
    memory."""
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"detect_head holds 1..{MAX_CLASSES} classes, "
                         f"got {n_classes}")
    lanes = batch * lanes_per_slot(n_classes)
    block = min(BLOCK, max(32, -(-lanes // 32) * 32))
    return -(-lanes // block), block, 2 * 4 * n_classes


def _check(logits, state: DetectorState):
    if logits.dim() != 3:
        raise ValueError(f"detect_head: logits must be (F, B, K), got "
                         f"{tuple(logits.shape)}")
    _, B, K = logits.shape
    for name, t, shape in (("smooth", state.smooth, (B, K)),
                           ("active", state.active, (B,)),
                           ("refract", state.refract, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"detect_head: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != logits.device:
            raise ValueError(f"detect_head: {name} is on {t.device}, logits "
                             f"on {logits.device}")


def detect_head_ref(logits: torch.Tensor, state: DetectorState,
                    cfg: DetectorConfig) -> tuple[DetectorState, torch.Tensor]:
    """Plain PyTorch version of ``detect_head`` (same arguments and
    returns)."""
    _check(logits, state)
    return detector_scan(cfg, state, xla_softmax(logits.float()))


_thresholds: dict = {}


def _device_thresholds(cfg: DetectorConfig, n_classes: int, device):
    """The per-keyword (fire, release) thresholds on ``device``, uploaded
    once per configuration rather than once per step."""
    key = (cfg.fire_threshold, cfg.release_threshold, cfg.first_keyword,
           n_classes, str(device))
    th = _thresholds.get(key)
    if th is None:
        th = tuple(torch.from_numpy(t).to(device)
                   for t in keyword_thresholds(cfg, n_classes))
        _thresholds[key] = th
    return th


def _launcher():
    lib = build.load("detect_head")
    fn = lib.detect_head_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 6 + [ctypes.c_float] + [i] * 2 + [p] * 4
                       + [i] * 6 + [p])
        fn.restype = ctypes.c_int
    return lib, fn


def detect_head(logits: torch.Tensor, state: DetectorState,
                cfg: DetectorConfig) -> tuple[DetectorState, torch.Tensor]:
    """Softmax, EMA and hysteresis latch over a chunk of frames.

    logits: (F, B, K) float32; ``state`` the carried ``DetectorState``
    (smooth (B, K) float32, active and refract (B,) int32).  Returns
    (state', events (F, B) int32), as ``detect_head_ref``.  CPU tensors
    run the plain version; CUDA tensors launch ``csrc/detect_head.cu``.
    """
    _check(logits, state)
    if logits.device.type == "cpu":
        return detect_head_ref(logits, state, cfg)
    if logits.device.type != "cuda":
        raise ValueError(f"detect_head runs on cuda or cpu, not "
                         f"{logits.device}")
    F, B, K = logits.shape
    grid, block, smem = detect_launch_plan(B, K)
    for name, t, dtype in (("logits", logits, torch.float32),
                           ("smooth", state.smooth, torch.float32),
                           ("active", state.active, torch.int32),
                           ("refract", state.refract, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"detect_head: {name} must be {dtype}, got "
                            f"{t.dtype}")
    dev = logits.device
    logits = logits.contiguous()
    th = _device_thresholds(cfg, K, dev)
    ins = tuple(t.contiguous() for t in state)
    out = DetectorState(*(torch.empty_like(t) for t in ins))
    events = torch.empty((F, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out, events
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(logits.data_ptr(), *(t.data_ptr() for t in ins),
                 th[0].data_ptr(), th[1].data_ptr(),
                 float(cfg.smooth_alpha), int(cfg.refractory_frames),
                 int(cfg.first_keyword), *(t.data_ptr() for t in out),
                 events.data_ptr(), F, B, K, grid, block, smem, stream)
    build.check(lib, err, "detect_head kernel launch")
    detect_head.launches += 1
    return out, events


detect_head.launches = 0
