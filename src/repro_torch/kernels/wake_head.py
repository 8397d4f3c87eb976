"""The cascade's wake head fused over a chunk: stage 0's posterior → wake
machine.

``wake_head`` is the wrapper of the CUDA kernel ``csrc/wake_head.cu``.  It
has no Pallas counterpart: in the JAX package the stage-0 posterior
(``jax.nn.softmax(logits)[..., 1]``) and the wake machine
(``cascade_wake_scan``, a ``lax.scan``) are plain JAX that XLA fuses into
the cascade step.  In eager PyTorch the softmax on XLA's exp alone is ~256
launches a chunk and the closed-form wake machine ~40, more than the rest
of the step adds, so the port runs both in one kernel.
``wake_head_ref`` is its plain PyTorch version: ``xla_softmax`` then
``launch.streaming.cascade_wake_scan`` (the closed form).

The wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.detect_head import xla_softmax

MAX_CLASSES = 32            # the kernel sums classes in order up to 32
BLOCK = 128                 # threads per CTA, at most


def wake_launch_plan(batch: int, n_classes: int) -> tuple[int, int]:
    """(grid, block) of the kernel: one thread per slot, up to ``BLOCK``
    threads per CTA.  Raises for a head it cannot run (2..32 classes)."""
    if not 2 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"wake_head holds 2..{MAX_CLASSES} classes (class "
                         f"1 is the event posterior), got {n_classes}")
    block = min(BLOCK, max(32, -(-batch // 32) * 32))
    return -(-batch // block), block


def _check(logits, awake, hang):
    if logits.dim() != 3:
        raise ValueError(f"wake_head: logits must be (F, B, K), got "
                         f"{tuple(logits.shape)}")
    B = logits.shape[1]
    for name, t, dtype in (("awake", awake, torch.bool),
                           ("hang", hang, torch.int32)):
        if tuple(t.shape) != (B,) or t.dtype != dtype:
            raise ValueError(f"wake_head: {name} must be ({B},) {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != logits.device:
            raise ValueError(f"wake_head: {name} is on {t.device}, logits "
                             f"on {logits.device}")


def wake_head_ref(logits: torch.Tensor, awake: torch.Tensor,
                  hang: torch.Tensor, cfg):
    """Plain PyTorch version of ``wake_head`` (same arguments and
    returns)."""
    from repro_torch.launch.streaming import cascade_wake_scan
    _check(logits, awake, hang)
    return cascade_wake_scan(cfg, awake, hang,
                             xla_softmax(logits.float())[..., 1])


def _launcher():
    lib = build.load("wake_head")
    fn = lib.wake_head_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 3 + [ctypes.c_float] * 2 + [i] + [p] * 3
                       + [i] * 5 + [p])
        fn.restype = ctypes.c_int
    return lib, fn


def wake_head(logits: torch.Tensor, awake: torch.Tensor, hang: torch.Tensor,
              cfg):
    """Stage 0's posterior and the wake machine over a chunk of frames.

    logits: (F, B, K) float32 stage-0 logits (class 1 is "an event might
    be here"); ``awake`` (B,) bool and ``hang`` (B,) int32 the carried
    latch and countdown; ``cfg`` a ``launch.streaming.CascadeConfig``.
    Returns ``(awake_trace (F, B) bool, awake' (B,), hang' (B,) int32)``,
    as ``wake_head_ref``.  CPU tensors run the plain version; CUDA
    tensors launch ``csrc/wake_head.cu``.
    """
    _check(logits, awake, hang)
    if logits.device.type == "cpu":
        return wake_head_ref(logits, awake, hang, cfg)
    if logits.device.type != "cuda":
        raise ValueError(f"wake_head runs on cuda or cpu, not "
                         f"{logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"wake_head: logits must be float32, got "
                        f"{logits.dtype}")
    F, B, K = logits.shape
    grid, block = wake_launch_plan(B, K)
    dev = logits.device
    logits = logits.contiguous()
    awake = awake.contiguous()
    hang = hang.contiguous()
    trace = torch.empty((F, B), dtype=torch.bool, device=dev)
    awake_out = torch.empty_like(awake)
    hang_out = torch.empty_like(hang)
    if B == 0:
        return trace, awake_out, hang_out
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(logits.data_ptr(), awake.data_ptr(), hang.data_ptr(),
                 float(cfg.wake_threshold), float(cfg.sleep_threshold),
                 int(cfg.hangover_frames), trace.data_ptr(),
                 awake_out.data_ptr(), hang_out.data_ptr(), F, B, K, grid,
                 block, stream)
    build.check(lib, err, "wake_head kernel launch")
    wake_head.launches += 1
    return trace, awake_out, hang_out


wake_head.launches = 0
