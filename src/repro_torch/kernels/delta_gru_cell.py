"""One fused ΔGRU step: Δ-encode, the two gated matvecs, the GRU gates.

``delta_gru_cell`` is the wrapper of the CUDA kernel
``csrc/delta_gru_cell.cu`` (the port of the Pallas kernel
``repro/kernels/delta_gru_cell.py::delta_gru_cell``); ``delta_gru_cell_ref``
is its plain PyTorch version, the counterpart of
``repro/kernels/ref.py::delta_gru_cell_ref``, on ``gru_math``'s Δ-encode
and gates.  Like the reference it adds no bias: M_x carries one when the
caller wants it.

The wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.delta_gru_seq import MAX_THREADS
from repro_torch.kernels.gru_math import delta_branch, gru_gates
from repro_torch.kernels.platform import refuse_grad

_NAMES = ("x", "h", "x_hat", "h_hat", "m_x", "m_h", "w_x", "w_h")


def cell_kernel_smem_bytes(input_dim: int, hidden_dim: int) -> int:
    """Dynamic shared memory of one CTA of the kernel (the layout of
    ``layout`` in ``csrc/delta_gru_cell.cu``): the compacted (Δ, row
    offset) lists, a segment of 32 8-byte entries per warp of
    components, the segment counts rounded up to 16 bytes, and the M_x
    and M_h rows the gates read.  The weights are read from global
    memory, so it stays under the 48 KB a block has without opting in at
    every width the threads admit."""
    I, H = input_dim, hidden_dim
    segments = -(-I // 32) + -(-H // 32)
    return 256 * segments + -(-4 * segments // 16) * 16 + 2 * 4 * 3 * H


def check_cell_fits(input_dim: int, hidden_dim: int) -> None:
    """Raise ``ValueError`` when the kernel cannot run this ΔGRU: 3H
    columns must fit one block's threads, and the input width the
    block's threads."""
    threads = -(-3 * hidden_dim // 32) * 32
    if threads > MAX_THREADS or input_dim > threads:
        raise ValueError(
            f"ΔGRU cell I={input_dim}, H={hidden_dim} needs 3H <= "
            f"{MAX_THREADS} and I <= 3H rounded up to a warp ({threads})")


def _check_shapes(args):
    x, h = args[0], args[1]
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"delta_gru_cell: expected x (B, I) and h (B, H), "
                         f"got {tuple(x.shape)} and {tuple(h.shape)}")
    (B, I), H = x.shape, h.shape[1]
    expect = ((B, I), (B, H), (B, I), (B, H), (B, 3 * H), (B, 3 * H),
              (I, 3 * H), (H, 3 * H))
    for name, t, shape in zip(_NAMES, args, expect):
        if tuple(t.shape) != shape:
            raise ValueError(f"delta_gru_cell: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"delta_gru_cell: {name} is on {t.device}, x "
                             f"on {x.device}")


def delta_gru_cell_ref(x, h, x_hat, h_hat, m_x, m_h, w_x, w_h, threshold):
    """Plain PyTorch version of ``delta_gru_cell`` (same arguments and
    returns)."""
    _check_shapes((x, h, x_hat, h_hat, m_x, m_h, w_x, w_h))
    dx, new_x_hat, _ = delta_branch(x, x_hat, threshold)
    dh, new_h_hat, _ = delta_branch(h, h_hat, threshold)
    new_m_x = m_x + dx @ w_x
    new_m_h = m_h + dh @ w_h
    return (gru_gates(new_m_x, new_m_h, h, h.shape[1]), new_x_hat,
            new_h_hat, new_m_x, new_m_h)


def _launcher():
    lib = build.load("delta_gru_cell")
    fn = lib.delta_gru_cell_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [p] * 5 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def delta_gru_cell(x, h, x_hat, h_hat, m_x, m_h, w_x, w_h, threshold):
    """One fused ΔGRU step.

    Shapes: x, x_hat (B, I); h, h_hat (B, H); m_x, m_h (B, 3H); w_x
    (I, 3H); w_h (H, 3H); ``threshold`` Δ_TH, a Python float.  Returns
    ``(h', x̂', ĥ', M_x', M_h')``.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/delta_gru_cell.cu`` (contiguous float32).
    """
    args = (x, h, x_hat, h_hat, m_x, m_h, w_x, w_h)
    _check_shapes(args)
    refuse_grad("delta_gru_cell", *args)
    if x.device.type == "cpu":
        return delta_gru_cell_ref(*args, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"delta_gru_cell runs on cuda or cpu, not "
                         f"{x.device}")
    for name, t in zip(_NAMES, args):
        if t.dtype != torch.float32:
            raise TypeError(f"delta_gru_cell: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"delta_gru_cell: {name} must be contiguous")
    (B, I), H = x.shape, h.shape[1]
    check_cell_fits(I, H)
    outs = tuple(torch.empty_like(t) for t in (h, x_hat, h_hat, m_x, m_h))
    if B == 0:
        return outs
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(a.data_ptr() for a in args), float(threshold),
                 *(o.data_ptr() for o in outs), B, I, H, stream)
    build.check(lib, err, "delta_gru_cell kernel launch")
    delta_gru_cell.launches += 1
    return outs


delta_gru_cell.launches = 0
