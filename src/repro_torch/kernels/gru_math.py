"""The ΔGRU datapath as torch ops, in the op order of
``repro/kernels/gru_math.py``: the plain version of the ΔGRU kernel and
the per-step cell both run these two functions."""
from __future__ import annotations

import torch


def delta_branch(v, v_hat, threshold):
    """Δ encoder: (delta, new_v_hat, transmitted_mask).

    delta[i] = v[i] - v_hat[i] where |v - v_hat| > threshold, else 0.
    v_hat only advances for transmitted components (the IC's Δ-encoder
    semantics — not an unconditional update, which would let small drifts
    accumulate unseen).
    """
    diff = v - v_hat
    mask = torch.abs(diff) > threshold
    delta = torch.where(mask, diff, torch.zeros((), dtype=diff.dtype,
                                                device=diff.device))
    new_v_hat = torch.where(mask, v, v_hat)
    return delta, new_v_hat, mask


def gru_gates(m_x, m_h, h, hidden_dim: int):
    """Type-2 GRU nonlinearity on accumulated pre-activations [r|u|c]."""
    H = hidden_dim
    r = torch.sigmoid(m_x[:, :H] + m_h[:, :H])
    u = torch.sigmoid(m_x[:, H:2 * H] + m_h[:, H:2 * H])
    c = torch.tanh(m_x[:, 2 * H:] + r * m_h[:, 2 * H:])
    return u * h + (1.0 - u) * c
