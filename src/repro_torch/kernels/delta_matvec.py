"""Block-sparse delta matvec: ``out = m + Δx·W``, skipping idle input blocks.

``delta_matvec`` is the wrapper of the CUDA kernel ``csrc/delta_matvec.cu``
(the port of the Pallas kernel ``repro/kernels/delta_matvec.py::
delta_matvec``); ``delta_matvec_ref`` is its plain PyTorch version,
``m + (Δx · mask) @ W`` in float32.  The ΔGRU's fallback for weights that
do not fit one thread block's shared memory
(``core.delta_gru._delta_gru_scan_blocked``) calls it twice per frame.

The delta vector is cut into blocks of ``block_i`` inputs; ``block_mask``
(one int32 per block, ``make_block_mask``) says which blocks hold any
non-zero delta.  A masked-off block contributes nothing, even where its
deltas are non-zero, and its weight rows are never read.  ``block_i`` is
therefore part of the numerics (the mask's granularity); ``block_o`` is a
tiling knob of the TPU kernel, checked as the reference checks it and
free to differ here.

The wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.platform import refuse_grad

_DTYPES = (torch.float32, torch.bfloat16)


def _check(dx, w, m, block_mask, block_i: int, block_o: int):
    if dx.dim() != 2 or w.dim() != 2 or m.dim() != 2:
        raise ValueError(f"delta_matvec: expected dx (B, I), w (I, O), m "
                         f"(B, O), got {tuple(dx.shape)}, {tuple(w.shape)}, "
                         f"{tuple(m.shape)}")
    B, I = dx.shape
    O = w.shape[1]
    if w.shape[0] != I or tuple(m.shape) != (B, O):
        raise ValueError(f"delta_matvec: shapes dx {tuple(dx.shape)}, w "
                         f"{tuple(w.shape)}, m {tuple(m.shape)} disagree")
    if block_i <= 0 or block_o <= 0 or I % block_i or O % block_o:
        raise ValueError(f"delta_matvec: I={I} and O={O} must be multiples "
                         f"of block_i={block_i} and block_o={block_o}")
    if tuple(block_mask.shape) != (I // block_i,):
        raise ValueError(f"delta_matvec: block_mask has shape "
                         f"{tuple(block_mask.shape)}, expected "
                         f"({I // block_i},)")
    for name, t in (("dx", dx), ("w", w)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"delta_matvec: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    if not (dx.device == w.device == m.device == block_mask.device):
        raise ValueError("delta_matvec: dx, w, m and block_mask must share "
                         "one device")


# The CUDA kernel's tiling (csrc/delta_matvec.cu): a CTA covers TILE_B
# rows × TILE_O columns with THREADS threads (a 3 × 4 register tile each)
# and pipelines slices of TILE_K input rows through STAGES shared-memory
# buffers, copied by TMA, by cp.async or by plain loads.  The kernel
# launches with the plan below and refuses one it cannot run.
TILE_B, TILE_O, TILE_K, STAGES, THREADS = 12, 64, 32, 3, 64
COPY_CODES = {"plain": 0, "cp.async": 1, "tma": 2}


def matvec_launch_plan(B: int, I: int, O: int, block_i: int = 128,
                       block_o: int = 128, dtype=torch.float32,
                       aligned: bool = True) -> dict:
    """The kernel's launch for a (B, I) × (I, O) call: ``grid`` (column
    tiles, row tiles), ``threads``, ``smem_bytes`` (the slice ring and one
    barrier per stage, which the kernel holds statically and the launcher
    checks) and ``copy``, how slices reach shared memory: ``"tma"``
    (float32, I and O multiples of 4, block_i a multiple of TILE_K),
    ``"cp.async"`` (float32, O a multiple of 4) or ``"plain"`` (bfloat16
    and the rest).  The first two also need 16-byte aligned pointers
    (``aligned``).  Refuses what the reference refuses: I and O not
    multiples of ``block_i`` and ``block_o``."""
    if block_i <= 0 or block_o <= 0 or I % block_i or O % block_o:
        raise ValueError(f"delta_matvec: I={I} and O={O} must be multiples "
                         f"of block_i={block_i} and block_o={block_o}")
    if dtype not in _DTYPES:
        raise TypeError(f"delta_matvec: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    f32 = dtype == torch.float32 and O % 4 == 0 and aligned
    copy = ("tma" if f32 and I % 4 == 0 and block_i % TILE_K == 0
            else "cp.async" if f32 else "plain")
    smem = STAGES * (TILE_K * (TILE_O + TILE_B) * 4 + 8)
    smem = -(-smem // 128) * 128              # the ring's 128-byte alignment
    return {"grid": (-(-O // TILE_O), -(-B // TILE_B)), "threads": THREADS,
            "smem_bytes": smem, "copy": copy}


def make_block_mask(dx, block_i: int = 128):
    """(B, I) deltas → (I // block_i,) int32 block-activity mask: 1 where
    any delta of the block, over the whole batch, is non-zero.  Computed
    on the deltas' device with no host sync; a block holding a NaN gets 0,
    as ``jnp.max`` followed by ``> 0`` gives it."""
    B, I = dx.shape
    if I % block_i:
        raise ValueError(f"make_block_mask: I={I} is not a multiple of "
                         f"block_i={block_i}")
    blocks = dx.reshape(B, I // block_i, block_i).abs()
    return (torch.amax(blocks, dim=(0, 2)) > 0).to(torch.int32)


def delta_matvec_ref(dx, w, m, block_mask, block_i: int = 128):
    """Plain version: ``m + (Δx · mask) @ W`` in float32 (the counterpart
    of ``repro/kernels/ref.py::delta_matvec_ref``)."""
    mask = torch.repeat_interleave(block_mask.to(torch.float32), block_i)
    dx_m = dx.to(torch.float32) * mask[None, :]
    return m.to(torch.float32) + dx_m @ w.to(torch.float32)


def _launcher():
    lib = build.load("delta_matvec")
    fn = lib.delta_matvec_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def delta_matvec(dx, w, m, block_mask, *, block_i: int = 128,
                 block_o: int = 128):
    """``m + Δx·W`` over the active input blocks only.

    Args:
      dx: (B, I) float32 or bfloat16 thresholded deltas.
      w: (I, O) weights, the dtype of ``dx``.
      m: (B, O) float32 accumulator.
      block_mask: (I // block_i,) int32, non-zero for an active block.
      block_i: the mask's granularity (I must be a multiple).
      block_o: the reference's output tile (O must be a multiple).

    Returns the (B, O) float32 sum.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/delta_matvec.cu`` (contiguous only).
    """
    _check(dx, w, m, block_mask, block_i, block_o)
    refuse_grad("delta_matvec", dx, w, m)
    if dx.device.type == "cpu":
        return delta_matvec_ref(dx, w, m, block_mask, block_i)
    if dx.device.type != "cuda":
        raise ValueError(f"delta_matvec runs on cuda or cpu, not "
                         f"{dx.device}")
    if w.dtype != dx.dtype:
        raise TypeError(f"delta_matvec: w ({w.dtype}) must have the dtype "
                        f"of dx ({dx.dtype})")
    if m.dtype != torch.float32:
        raise TypeError(f"delta_matvec: m must be float32, got {m.dtype}")
    if block_mask.dtype != torch.int32:
        raise TypeError(f"delta_matvec: block_mask must be int32, got "
                        f"{block_mask.dtype}")
    for name, t in (("dx", dx), ("w", w), ("m", m),
                    ("block_mask", block_mask)):
        if not t.is_contiguous():
            raise ValueError(f"delta_matvec: {name} must be contiguous")
    B, I = dx.shape
    O = w.shape[1]
    out = torch.empty((B, O), dtype=torch.float32, device=dx.device)
    if B == 0 or O == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (dx, w, m, out))
    plan = matvec_launch_plan(B, I, O, block_i, block_o, dx.dtype, aligned)
    lib, fn = _launcher()
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream(dx.device).cuda_stream
        err = fn(dx.data_ptr(), w.data_ptr(), m.data_ptr(),
                 block_mask.data_ptr(), out.data_ptr(), B, I, O, block_i,
                 int(dx.dtype == torch.bfloat16), *plan["grid"],
                 plan["threads"], COPY_CODES[plan["copy"]], plan["smem_bytes"],
                 stream)
    build.check(lib, err, "delta_matvec kernel launch")
    delta_matvec.launches += 1
    return out


delta_matvec.launches = 0
