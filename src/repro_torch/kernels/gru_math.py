"""The ΔGRU datapath as torch ops, in the op order of
``repro/kernels/gru_math.py``: the plain version of the ΔGRU kernel and
the per-step cell both run these two functions."""
from __future__ import annotations

import torch

from repro_torch.kernels.xla_math import fma, xla_sigmoid, xla_tanh


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
    """Type-2 GRU nonlinearity on accumulated pre-activations [r|u|c].

    σ and tanh are XLA's (``xla_math``), and the two products that XLA on
    the CPU fuses into the following add are fused here too: r·M_hc into
    the candidate's pre-activation and u·h into the blend (whose other
    product, (1 − u)·c, rounds on its own).
    """
    H = hidden_dim
    r = xla_sigmoid(m_x[:, :H] + m_h[:, :H])
    u = xla_sigmoid(m_x[:, H:2 * H] + m_h[:, H:2 * H])
    c = xla_tanh(fma(r, m_h[:, 2 * H:], m_x[:, 2 * H:]))
    return fma(u, h, (1.0 - u) * c)
