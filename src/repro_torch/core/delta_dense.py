"""Delta-gated dense layers — the paper's mechanism generalized.

Port of ``repro/core/delta_dense.py``:

1. ``delta_matmul`` — a matmul whose LHS is a delta-encoded streaming
   vector: x_t @ W is replaced by the incremental update
   M_t = M_{t-1} + Δx_t @ W, skipping the weight traffic of unchanged
   channels in hardware.  Here it has the exact functional semantics (a
   dense product of the sparse Δ, as the reference's).
2. ``DeltaStream`` — carries (x̂, M) across decode steps for any linear
   layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.delta_gru import delta_encode


class DeltaStream(NamedTuple):
    x_hat: torch.Tensor   # (..., I)   last transmitted input
    m: torch.Tensor       # (..., O)   accumulated output == x_hat @ w


def init_delta_stream(batch_shape, in_dim: int, out_dim: int,
                      dtype=torch.float32, device="cpu") -> DeltaStream:
    return DeltaStream(
        x_hat=torch.zeros((*batch_shape, in_dim), dtype=dtype, device=device),
        m=torch.zeros((*batch_shape, out_dim), dtype=dtype, device=device))


def delta_matmul(stream: DeltaStream, x, w, threshold: float):
    """Incremental y = x̂ @ w with delta gating.

    Returns (new_stream, y, nnz_fraction).  At threshold=0, y == x @ w up
    to the rounding of the accumulated sum.
    """
    th = torch.tensor(threshold, dtype=x.dtype, device=x.device)
    dx, x_hat, mask = delta_encode(x, stream.x_hat, th)
    m = stream.m + dx @ w
    nnz = torch.mean(mask.to(torch.float32))
    return DeltaStream(x_hat=x_hat, m=m), m, nnz
