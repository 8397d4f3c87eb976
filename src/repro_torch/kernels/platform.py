"""Device resolution for the port's entry points.

Entry points run on the GPU by default.  ``resolve_device(None)`` means
CUDA and raises when CUDA is missing: there is no silent CPU fallback, so
a CPU number can never pass for a GPU number.  Tests pass
``device="cpu"`` explicitly, which runs every kernel wrapper through its
plain PyTorch version (a wrapper picks the plain version only because its
tensor lies on the CPU).

The resolved device is logged once per distinct device, with the card's
name.
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
