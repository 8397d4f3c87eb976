"""Top-k gradient compression with error feedback (Deep Gradient
Compression, Lin et al. arXiv:1712.01887), for a slow cross-pod axis.

Port of ``repro/train/compress.py`` on trees (nested dicts /
NamedTuples) of tensors.  Error-feedback top-k keeps a residual of the
coordinates not sent, so the update stays unbiased over time:

    acc   = residual + grad
    mask  = |acc| in the top-k fraction (every value >= the k-th largest,
            so ties are all kept, as the reference's ``lax.top_k``
            threshold keeps them)
    sent  = acc * mask          (communicated: k·(idx+val) bytes)
    residual' = acc - sent

As in the reference, the compressed all-reduce is a dense masked tensor
here; the compression ratio and the convergence behaviour are what is
tested and reported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import tree_map


class CompressState(NamedTuple):
    residual: Any          # tree like grads (float32)


def init_state(grads_like) -> CompressState:
    return CompressState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def _leaves_sorted(tree) -> list:
    """Leaves in a JAX pytree's order (a dict's keys sorted), the order
    the reference sums the densities in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves_sorted(v)]
    return [tree]


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    k = max(1, int(x.numel() * frac))
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress(grads, state: CompressState, frac: float = 0.01
             ) -> tuple[Any, CompressState, dict]:
    """Returns (sparse grads to communicate, new state, metrics): the
    metrics ``density`` (the mean kept fraction over leaves, a 0-d
    tensor) and ``wire_ratio`` (bytes as (int32 index, bf16 value) pairs
    over dense bf16)."""
    def one(g, r):
        acc = r + g.to(torch.float32)
        mask = _topk_mask(acc, frac)
        sent = acc * mask
        return sent, acc - sent, torch.mean(mask)

    outs = tree_map(one, grads, state.residual)
    sent = tree_map(lambda o: o[0], outs)
    resid = tree_map(lambda o: o[1], outs)
    flat = _leaves_sorted(outs)
    density = sum(o[2] for o in flat) / len(flat)
    ratio = (6.0 * frac) / 2.0
    return sent, CompressState(resid), {"density": density,
                                        "wire_ratio": ratio}
