"""Plain PyTorch oracles of the reference's kernels (the counterpart of
``repro/kernels/ref.py``): allclose targets written as the reference
writes them, independent of the kernels' exact plain versions.

``delta_matvec_ref`` and ``delta_gru_cell_ref`` are the plain versions
of those two kernels (``kernels/delta_matvec.py``,
``kernels/delta_gru_cell.py``), re-exported; ``iir_fex_ref`` is the
reference's scan of the symmetric-form biquad cascade, one sample at a
time, each product rounded on its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_gru_cell import delta_gru_cell_ref
from repro_torch.kernels.delta_matvec import delta_matvec_ref

__all__ = ["delta_matvec_ref", "iir_fex_ref", "delta_gru_cell_ref"]


def iir_fex_ref(x, coef, frame_shift: int = 128, env_alpha: float = 0.0606):
    """Oracle for ``kernels.iir_fex`` (symmetric-form biquad cascade):
    (T,) audio, (6, C) rows → (T // frame_shift, C) raw envelopes at each
    frame's last sample, from zero state."""
    C = coef.shape[1]
    coef = coef.float()
    b0_0, a1_0, a2_0, b0_1, a1_1, a2_1 = (coef[i] for i in range(6))
    z = torch.zeros((C,), dtype=torch.float32, device=coef.device)
    s0_1 = s0_2 = s1_1 = s1_2 = env = z
    T = x.shape[0] // frame_shift * frame_shift
    xs = x[:T].float()
    envs = []
    for t in range(T):
        xt = xs[t]
        y0 = b0_0 * xt + s0_1
        s0_1, s0_2 = -a1_0 * y0 + s0_2, -b0_0 * xt - a2_0 * y0
        y1 = b0_1 * y0 + s1_1
        s1_1, s1_2 = -a1_1 * y1 + s1_2, -b0_1 * y0 - a2_1 * y1
        env = (1.0 - env_alpha) * env + env_alpha * torch.abs(y1)
        envs.append(env)
    if not envs:
        return z.new_zeros((0, C))
    return torch.stack(envs)[frame_shift - 1::frame_shift]
