"""Public wrappers of the port's hand-written kernels, in one place (the
counterpart of ``repro/kernels/ops.py``).

Every wrapper launches its CUDA kernel for tensors on the GPU and runs its
plain PyTorch version for tensors on the CPU.
"""
from __future__ import annotations

from repro_torch.kernels.delta_gru_cell import delta_gru_cell
from repro_torch.kernels.delta_gru_seq import delta_gru_seq, delta_gru_seq_int
from repro_torch.kernels.delta_matvec import delta_matvec, make_block_mask
from repro_torch.kernels.detect_head import detect_head
from repro_torch.kernels.iir_fex import (batched_iir_fex, batched_iir_fex_int,
                                         iir_fex, init_fex_kernel_state,
                                         pack_coefficients)
from repro_torch.kernels.wake_head import wake_head

__all__ = [
    "delta_matvec", "make_block_mask", "delta_gru_cell", "delta_gru_seq",
    "delta_gru_seq_int", "iir_fex", "batched_iir_fex", "batched_iir_fex_int",
    "init_fex_kernel_state", "pack_coefficients", "delta_matvec_auto",
    "detect_head", "wake_head",
]


def delta_matvec_auto(dx, w, m, *, block_i: int = 128, block_o: int = 128):
    """``delta_matvec`` with the block mask derived from the deltas
    themselves; returns ``(out, mask)``."""
    mask = make_block_mask(dx, block_i)
    return delta_matvec(dx, w, m, mask, block_i=block_i,
                        block_o=block_o), mask
