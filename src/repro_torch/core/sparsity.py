"""Temporal-sparsity metrics and accumulators for Δ networks (the
counterpart of ``repro/core/sparsity.py``).

``SparsityAccumulator`` folds the per-frame ``DeltaStats`` of many scans
into host totals; ``delta_histogram`` and ``sparsity_at_threshold`` show
on the inputs alone why temporal sparsity exists.  The tensors may live
on any device; the accumulator reads each update back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class SparsityAccumulator:
    """Streaming accumulator for sparsity over many sequences (host side)."""

    macs_exec: float = 0.0
    macs_dense: float = 0.0
    nz_dx: float = 0.0
    nz_dh: float = 0.0
    frames: int = 0

    def update(self, stats) -> None:
        self.macs_exec += float(stats.macs.double().sum())
        self.macs_dense += float(stats.macs_dense.double().sum())
        self.nz_dx += float(stats.nz_dx.double().sum())
        self.nz_dh += float(stats.nz_dh.double().sum())
        self.frames += math.prod(stats.macs.shape)

    @property
    def sparsity(self) -> float:
        return 1.0 - self.macs_exec / max(self.macs_dense, 1.0)

    @property
    def macs_per_frame(self) -> float:
        return self.macs_exec / max(self.frames, 1)


def delta_histogram(xs: torch.Tensor, n_bins: int = 64,
                    max_abs: float = 2.0):
    """Histogram of |x_t − x_{t−1}| — shows why temporal sparsity exists.

    ``n_bins`` equal bins of [0, max_abs], as ``jnp.histogram`` counts
    them: each bin right-open but the last, values outside (and NaN) not
    counted.  Returns (counts (n_bins,) float32, edges (n_bins + 1,)
    float32)."""
    d = torch.abs(torch.diff(xs.float(), dim=0)).reshape(-1)
    edges = torch.linspace(0.0, max_abs, n_bins + 1, device=d.device)
    idx = torch.searchsorted(edges, d, right=True)
    idx = torch.where(d == edges[-1], n_bins, idx)
    idx = idx[(idx >= 1) & (idx <= n_bins)] - 1
    return torch.bincount(idx, minlength=n_bins).float(), edges


def sparsity_at_threshold(xs: torch.Tensor, threshold: float
                          ) -> torch.Tensor:
    """Fraction of components with |Δ| ≤ threshold (input-side upper bound
    on temporal sparsity, before hidden-state feedback effects)."""
    d = torch.abs(torch.diff(xs.float(), dim=0))
    return (d <= threshold).float().mean()
