"""Device resolution for the port's entry points.

Entry points run on the GPU by default.  ``resolve_device(None)`` means
CUDA and raises when CUDA is missing: there is no silent CPU fallback, so
a CPU number can never pass for a GPU number.  Tests pass
``device="cpu"`` explicitly, which runs every kernel wrapper through its
plain PyTorch version (a wrapper picks the plain version only because its
tensor lies on the CPU).

The resolved device is logged once per distinct device, with the card's
name.

``refuse_grad`` is the kernels' autograd contract: no kernel of the port
has a backward (no Pallas kernel of the reference has one either), so a
wrapper handed a tensor that needs a gradient raises instead of
returning a result that would silently drop it.
"""
from __future__ import annotations

import logging

import torch

_log = logging.getLogger(__name__)
_logged: set[str] = set()


def _configure_cuda_numerics() -> None:
    # The float path is full fp32: the FC product and any other float32
    # matmul or convolution must not drop to TF32 (about 3 decimal
    # digits), or the port would drift from the fp32 reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a GPU); otherwise the device
    asked for, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels on the CPU")
        _configure_cuda_numerics()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        name = torch.cuda.get_device_name(dev)
    elif dev.type == "cpu":
        name = "cpu (plain PyTorch versions of the kernels)"
    else:
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    key = str(dev)
    if key not in _logged:
        _logged.add(key)
        _log.info("repro_torch device: %s [%s]", key, name)
    return dev


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``ValueError`` if grad mode is on and any of ``tensors``
    requires a gradient: ``kernel`` has no backward.  Training runs the
    differentiable eager path (``delta_gru_scan(backend="xla")``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward, and an input requires a gradient: "
            f"train through the differentiable backend='xla' (the eager "
            f"DeltaGRUCell loop), or run under torch.no_grad()")
