"""Architecture zoo: dense/MoE/VLM transformers, Mamba2 SSD, Zamba2 hybrid,
Seamless enc-dec, and the paper's ΔGRU KWS model."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import get_api


def _leaf_from_numpy(a, device) -> torch.Tensor:
    """One array → a tensor of the same dtype; a bfloat16 array (an
    ``ml_dtypes`` array, as ``np.asarray`` of a JAX bf16 array gives) is
    carried by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cpu"):
    """The reference's LM parameter tree (nested dicts of numpy arrays,
    ``jax.tree.map(np.asarray, params)``) → this package's, leaf for leaf,
    with the same names and dtypes, on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)
