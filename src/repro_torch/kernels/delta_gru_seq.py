"""Full-sequence fused ΔGRU: one kernel launch per chunk of frames.

``delta_gru_seq`` is the wrapper of the CUDA kernel
``csrc/delta_gru_seq.cu`` (the port of the Pallas kernel
``repro/kernels/delta_gru_seq.py::delta_gru_seq``).  ``delta_gru_seq_ref``
is its plain PyTorch version: a Python loop over frames of
``delta_branch`` → ``m += d @ W`` → ``gru_gates``.

``delta_gru_seq_int`` is the int8-weight / int16-state variant, the
wrapper of ``csrc/delta_gru_seq_int.cu`` (the port of
``delta_gru_seq_int``); its plain version ``delta_gru_seq_int_ref`` runs
one ``core.fixed_point.gru_frame_step`` per frame on the fused
``[m_x | m_h]`` accumulator, as the reference's golden scan does.

Both wrappers take ``awake=``, a (T, B) bool wake trace: the masked
instantiation of each kernel (the stage-1 half of the two-stage wake
cascade) freezes a slot's whole state on its asleep frames, emits the
frozen h and counts no transmitted delta there, as the reference's
``masked_delta_gru_scan`` / ``masked_int_gru_scan`` do.  Launches of the
masked instantiations count in ``masked_launches``, those of the plain
ones in ``launches``.

Both take the reference's launch knobs (``kernels/autotune.py``):
``block_b`` (streams per launch: ``B / block_b`` launches over
consecutive slices of streams, xs read with its full-B strides; the
plain versions run the slices and stitch the state back together) and
``block_t`` (frames of x staged in shared memory at a time, clipped to
what shared memory holds; the float kernel's default 1 is its
one-frame-ahead register load, the int kernel's default ``min(32, T)``;
the plain versions validate it).  ``None`` is the default launch, and
every value is bit for bit the default's.  The masked instantiations
take no knob, as the reference's masked scans take none.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.  Neither kernel has a
backward: an input that requires a gradient is refused
(``platform.refuse_grad``), on the CPU too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.autotune import validate_block_b, validate_divisor
from repro_torch.kernels.gru_math import delta_branch, gru_gates
from repro_torch.kernels.platform import refuse_grad

# Shared memory one Hopper thread block may use (227 KB).
MAX_SMEM_BYTES = 232_448
MAX_THREADS = 1024


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def seq_kernel_smem_bytes(input_dim: int, hidden_dim: int,
                          x_frames: int = 0) -> int:
    """Dynamic shared memory of one CTA of the float kernel (the layout of
    ``layout`` in ``csrc/delta_gru_seq.cu``): W_x and W_h at a row pitch
    of 3H rounded up to 4 floats, the compacted (Δ, row offset) lists (a
    segment of 32 8-byte entries per warp), the two rows the gates read
    and the segment counts, and for the staged instance (``x_frames`` >=
    2) x for ``x_frames`` frames, each part rounded up to 16 bytes."""
    I, H = input_dim, hidden_dim
    pitch = -(-3 * H // 4) * 4
    segments = -(-I // 32) + -(-H // 32)
    return (_r16(4 * (I + H) * pitch) + 256 * segments + 8 * pitch
            + _r16(4 * segments) + _r16(4 * x_frames * I))


def int_seq_kernel_smem_bytes(input_dim: int, hidden_dim: int,
                              x_frames: int = 1) -> int:
    """Dynamic shared memory of one CTA of the int kernel staging x codes
    for blocks of ``x_frames`` frames (the layout of ``layout`` in
    ``csrc/delta_gru_seq_int.cu``): the int8 W_x and W_h at a row pitch
    of 3H rounded up to 4 bytes, the compacted (Δ, row offset) lists (an
    entry per component, a segment per warp), the m_x and m_h rows,
    the segment counts and the block's int16 x codes, each part rounded
    up to 16 bytes.  With the default one frame: the least the kernel
    runs with."""
    I, H = input_dim, hidden_dim
    pitch = -(-3 * H // 4) * 4
    segments = -(-I // 32) + -(-H // 32)
    return (_r16((I + H) * pitch) + 8 * (I + H) + 8 * pitch
            + _r16(4 * segments) + _r16(2 * x_frames * I))


# The int kernel stages x codes for blocks of at most this many frames.
INT_X_FRAMES = 32


def staged_frames(I: int, H: int, T: int, block_t: int | None) -> int:
    """The float kernel's staged x frames for ``block_t``: 0 (x loaded one
    frame ahead into a register: ``block_t`` None or 1, the default), else
    ``block_t`` frames, at most T, fewer where shared memory is short."""
    x_frames = 0 if block_t is None else min(block_t, max(T, 1))
    while (x_frames > 1 and seq_kernel_smem_bytes(I, H, x_frames)
           > MAX_SMEM_BYTES):
        x_frames -= 1
    return x_frames if x_frames >= 2 else 0


def gru_launch_plan(B: int, I: int, H: int, x_frames: int = 0) -> dict:
    """The float ΔGRU kernel's launch for B streams (of one launch: a
    ``block_b`` launch takes the plan of ``block_b`` streams), input width
    I and hidden H, with ``x_frames`` staged frames (``staged_frames``):
    ``ctas`` (one per stream), ``threads`` (a warp multiple covering the
    3H columns and the I x encoders) and dynamic ``smem_bytes``.  The
    masked instantiation launches with the default plan: its wake bits
    live in registers, not in shared memory.  Raises ``ValueError`` for a
    ΔGRU the kernel cannot hold (``check_kernel_fits``)."""
    check_kernel_fits(I, H)
    return {"ctas": B, "threads": -(-3 * H // 32) * 32,
            "smem_bytes": seq_kernel_smem_bytes(I, H, x_frames)}


def gru_int_launch_plan(B: int, I: int, H: int, T: int,
                        block_t: int | None = None) -> dict:
    """The int ΔGRU kernel's launch for B streams (of one launch, as in
    ``gru_launch_plan``), input width I, hidden H and T frames: ``ctas``
    (one per stream), ``threads`` (a warp multiple covering the 3H
    columns, four per column group, and the I x encoders), ``x_frames``
    (frames of x codes staged at a time: ``block_t``, by default up to
    INT_X_FRAMES, fewer where shared memory is short) and dynamic
    ``smem_bytes``; the masked instantiation launches with the default
    plan.  Raises ``ValueError`` for a ΔGRU the kernel cannot hold
    (``check_int_kernel_fits``)."""
    check_int_kernel_fits(I, H)
    x_frames = max(1, min(INT_X_FRAMES if block_t is None else block_t, T))
    while (x_frames > 1 and int_seq_kernel_smem_bytes(I, H, x_frames)
           > MAX_SMEM_BYTES):
        x_frames -= 1
    return {"ctas": B, "threads": -(-3 * H // 32) * 32,
            "x_frames": x_frames,
            "smem_bytes": int_seq_kernel_smem_bytes(I, H, x_frames)}


def seq_kernel_fits(input_dim: int, hidden_dim: int,
                    smem_budget_bytes: int = MAX_SMEM_BYTES) -> bool:
    """Whether the kernel can hold this ΔGRU within ``smem_budget_bytes``
    of shared memory (at most the card's 227 KB) and one block's
    threads (``check_kernel_fits`` says why not)."""
    threads = -(-3 * hidden_dim // 32) * 32
    smem = seq_kernel_smem_bytes(input_dim, hidden_dim)
    return (smem <= min(smem_budget_bytes, MAX_SMEM_BYTES)
            and threads <= MAX_THREADS and input_dim <= threads)


def check_kernel_fits(input_dim: int, hidden_dim: int) -> None:
    """Raise ``ValueError`` when the kernel cannot hold this ΔGRU: its
    weights must fit one thread block's shared memory, 3H columns one
    block's threads, and the input width the block's threads."""
    smem = seq_kernel_smem_bytes(input_dim, hidden_dim)
    threads = -(-3 * hidden_dim // 32) * 32
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"ΔGRU I={input_dim}, H={hidden_dim} needs {smem} bytes of "
            f"shared memory per block; the delta_gru_seq kernel holds at "
            f"most {MAX_SMEM_BYTES} (227 KB on Hopper).  "
            f"core.delta_gru.delta_gru_scan(backend='pallas') takes the "
            f"block-sparse delta_matvec path for such a ΔGRU")
    if threads > MAX_THREADS or input_dim > threads:
        raise ValueError(
            f"ΔGRU I={input_dim}, H={hidden_dim} needs 3H <= {MAX_THREADS} "
            f"and I <= 3H rounded up to a warp ({threads})")


def _check_shapes(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (T, B, I), got {tuple(xs.shape)}")
    T, B, I = xs.shape
    H = h0.shape[1]
    expect = {"h0": (B, H), "x_hat0": (B, I), "h_hat0": (B, H),
              "m_x0": (B, 3 * H), "m_h0": (B, 3 * H), "w_x": (I, 3 * H),
              "w_h": (H, 3 * H)}
    got = {"h0": h0, "x_hat0": x_hat0, "h_hat0": h_hat0, "m_x0": m_x0,
           "m_h0": m_h0, "w_x": w_x, "w_h": w_h}
    for name, shape in expect.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"delta_gru_seq: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
        if got[name].device != xs.device:
            raise ValueError(f"delta_gru_seq: {name} is on "
                             f"{got[name].device}, xs on {xs.device}")


def _check_awake(awake, xs):
    """``awake`` must be a (T, B) bool tensor beside ``xs``."""
    if awake is None:
        return
    if not isinstance(awake, torch.Tensor) or awake.dtype != torch.bool:
        raise TypeError("awake must be a bool tensor")
    if tuple(awake.shape) != tuple(xs.shape[:2]):
        raise ValueError(f"awake has shape {tuple(awake.shape)}, expected "
                         f"(T, B) = {tuple(xs.shape[:2])}")
    if awake.device != xs.device:
        raise ValueError(f"awake is on {awake.device}, xs on {xs.device}")


def _freeze(awake_t, new, old):
    """Per slot: the new row where awake, the old one where asleep."""
    return torch.where(awake_t[:, None], new, old)


def _knobs(kernel: str, xs, awake, block_b, block_t):
    """The reference's knob checks: (block_b or B, block_t).  The masked
    instantiation takes no knob."""
    T, B = xs.shape[0], xs.shape[1]
    if awake is not None and (block_b is not None or block_t is not None):
        raise ValueError(f"{kernel}: the masked instantiation (awake=) "
                         f"takes no block_b / block_t")
    bb = validate_block_b(kernel, B, block_b)
    validate_divisor(kernel, "block_t", block_t, "T", T)
    return bb, block_t


def _by_slices(fn, bb: int, xs, state):
    """``fn(xs, state)`` over consecutive slices of ``bb`` streams; hs and
    counts concatenated on the stream axis, the state on its first.  A
    one-stream slice, or a batch of one stream (one shard's block of a
    slot mesh), runs doubled and keeps its first row: the CPU's BLAS
    takes another path for a one-row product, which rounds the float sums
    differently (every other row count rounds as the whole batch does),
    and a stream's rows must not depend on how many it is launched with,
    as they do not in the kernel."""
    B = xs.shape[1]
    if bb == B and B != 1:
        return fn(xs, state)
    if bb == 1:
        def one(x, st):
            out = fn(torch.cat([x, x], dim=1),
                     tuple(torch.cat([s, s]) for s in st))
            return (out[0][:, :1], tuple(s[:1] for s in out[1]),
                    out[2][:, :1], out[3][:, :1])
    else:
        one = fn
    outs = [one(xs[:, b0:b0 + bb], tuple(s[b0:b0 + bb] for s in state))
            for b0 in range(0, B, bb)]
    cat = lambda i: torch.cat([o[i] for o in outs], dim=1)
    return (cat(0), tuple(torch.cat([o[1][k] for o in outs])
                          for k in range(len(state))), cat(2), cat(3))


def delta_gru_seq_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h,
                      threshold, awake=None, *, block_b: int | None = None,
                      block_t: int | None = None):
    """Plain PyTorch version of ``delta_gru_seq`` (same arguments and
    returns), one frame at a time, ``block_b`` slices of streams; with
    ``awake``, each frame's new state is kept only on awake slots
    (``torch.where``), as the reference's masked scan keeps it."""
    _check_shapes(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    _check_awake(awake, xs)
    bb, _ = _knobs("delta_gru_seq", xs, awake, block_b, block_t)
    return _by_slices(
        lambda x, st: _gru_ref(x, *st, w_x, w_h, threshold, awake), bb, xs,
        (h0, x_hat0, h_hat0, m_x0, m_h0))


def _gru_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h, threshold,
             awake):
    T, B, _ = xs.shape
    H = h0.shape[1]
    h, x_hat, h_hat, m_x, m_h = (a.float() for a in
                                 (h0, x_hat0, h_hat0, m_x0, m_h0))
    w_x, w_h = w_x.float(), w_h.float()
    hs, nz_dx, nz_dh = [], [], []
    for t in range(T):
        old = (h, x_hat, h_hat, m_x, m_h)
        dx, x_hat, mx_mask = delta_branch(xs[t].float(), x_hat, threshold)
        dh, h_hat, mh_mask = delta_branch(h, h_hat, threshold)
        m_x = m_x + dx @ w_x
        m_h = m_h + dh @ w_h
        h = gru_gates(m_x, m_h, h, H)
        nx = mx_mask.sum(-1, dtype=torch.int32)
        nh = mh_mask.sum(-1, dtype=torch.int32)
        if awake is not None:
            h, x_hat, h_hat, m_x, m_h = (
                _freeze(awake[t], n, o)
                for n, o in zip((h, x_hat, h_hat, m_x, m_h), old))
            nx, nh = (torch.where(awake[t], n, 0) for n in (nx, nh))
        hs.append(h)
        nz_dx.append(nx)
        nz_dh.append(nh)
    if T == 0:
        z = torch.zeros((0, B), dtype=torch.int32, device=xs.device)
        return (torch.zeros((0, B, H), device=xs.device),
                (h, x_hat, h_hat, m_x, m_h), z, z)
    return (torch.stack(hs), (h, x_hat, h_hat, m_x, m_h),
            torch.stack(nz_dx), torch.stack(nz_dh))


def _launcher():
    lib = build.load("delta_gru_seq")
    fn = lib.delta_gru_seq_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [p] * 8 + [i] * 9 + [p] * 2
        fn.restype = ctypes.c_int
    return lib, fn


def delta_gru_seq(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h, threshold,
                  awake=None, *, block_b: int | None = None,
                  block_t: int | None = None):
    """Run a ΔGRU over a whole chunk of frames in ONE kernel launch
    (``B / block_b`` with ``block_b``).

    Args:
      xs:      (T, B, I) inputs, one row per 16 ms frame.
      h0, x_hat0, h_hat0, m_x0, m_h0: initial delta state (see
        ``core.delta_gru.DeltaState``; m_x0 carries the bias).
      w_x: (I, 3H); w_h: (H, 3H); threshold: Δ_TH (a Python float).
      awake: None, or a (T, B) bool wake trace: the masked instantiation
        runs only the awake frames of each slot (an asleep frame stores
        the frozen h and zero counts and leaves the state as it was).
      block_b: streams per launch (must divide B; default B, one launch).
      block_t: frames of x staged in shared memory at a time (must divide
        T; default 1, x loaded one frame ahead into a register).

    Returns ``(hs, (h, x_hat, h_hat, m_x, m_h), nz_dx, nz_dh)`` with
    hs (T, B, H) and nz_* (T, B) int32 per-frame transmit counts.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/delta_gru_seq.cu`` (contiguous float32 only).
    """
    _check_shapes(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    _check_awake(awake, xs)
    bb, block_t = _knobs("delta_gru_seq", xs, awake, block_b, block_t)
    refuse_grad("delta_gru_seq", xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x,
                w_h)
    if xs.device.type == "cpu":
        return delta_gru_seq_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x,
                                 w_h, threshold, awake, block_b=block_b,
                                 block_t=block_t)
    if xs.device.type != "cuda":
        raise ValueError(f"delta_gru_seq runs on cuda or cpu, not "
                         f"{xs.device}")
    args = (xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    names = ("xs", "h0", "x_hat0", "h_hat0", "m_x0", "m_h0", "w_x", "w_h")
    for name, t in zip(names, args):
        if t.dtype != torch.float32:
            raise TypeError(f"delta_gru_seq: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"delta_gru_seq: {name} must be contiguous")
    T, B, I = xs.shape
    H = h0.shape[1]
    x_frames = staged_frames(I, H, T, block_t)
    plan = gru_launch_plan(bb, I, H, x_frames)
    # Held until the launch is enqueued: a freed copy's block could be
    # handed to an output below.
    awake_c = None if awake is None else awake.contiguous()
    dev = xs.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    nz_dx = torch.empty((T, B), dtype=torch.int32, device=dev)
    nz_dh = torch.empty((T, B), dtype=torch.int32, device=dev)
    final = (torch.empty_like(h0), torch.empty_like(x_hat0),
             torch.empty_like(h_hat0), torch.empty_like(m_x0),
             torch.empty_like(m_h0))
    if B == 0:
        return hs, (h0, x_hat0, h_hat0, m_x0, m_h0), nz_dx, nz_dh
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, bb):
            err = fn(*(a.data_ptr() for a in args), float(threshold),
                     hs.data_ptr(), nz_dx.data_ptr(), nz_dh.data_ptr(),
                     *(a.data_ptr() for a in final), T, B, I, H,
                     plan["ctas"], plan["threads"], plan["smem_bytes"],
                     x_frames, b0,
                     None if awake_c is None else awake_c.data_ptr(), stream)
            build.check(lib, err, "delta_gru_seq kernel launch")
            if awake is None:
                delta_gru_seq.launches += 1
            else:
                delta_gru_seq.masked_launches += 1
    return hs, final, nz_dx, nz_dh


delta_gru_seq.launches = 0
delta_gru_seq.masked_launches = 0


# --------------------------------------------------------------- int variant
def _th_pair(th) -> tuple:
    """``th``: a pair of numbers or a (1, 2) / (2,) tensor → a 2-tuple of
    Python numbers (reading a CUDA tensor synchronises)."""
    vals = th.reshape(-1).tolist() if isinstance(th, torch.Tensor) else \
        list(th)
    if len(vals) != 2:
        raise ValueError(f"th must hold [th_x, th_h], got {vals}")
    return vals[0], vals[1]


def delta_gru_seq_int_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h, th,
                          *, fmt, awake=None, block_b: int | None = None,
                          block_t: int | None = None):
    """Plain PyTorch version of ``delta_gru_seq_int`` with an integer
    ``fmt`` (same arguments and returns): one ``gru_frame_step`` per frame
    on the fused ``[m_x | m_h]`` block, int16 codes carried, ``block_b``
    slices of streams; with ``awake``, each frame's new state is kept
    only on awake slots, as the reference's ``masked_int_gru_scan`` keeps
    it."""
    _check_shapes(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    _check_awake(awake, xs)
    bb, _ = _knobs("delta_gru_seq_int", xs, awake, block_b, block_t)
    return _by_slices(
        lambda x, st: _gru_int_ref(x, *st, w_x, w_h, th, fmt, awake), bb,
        xs, (h0, x_hat0, h_hat0, m_x0, m_h0))


def _gru_int_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h, th, fmt,
                 awake):
    from repro_torch.core.fixed_point import gru_frame_step
    T, B, _ = xs.shape
    H = h0.shape[1]
    th_x, th_h = _th_pair(th)
    h, xh, hh = (a.to(torch.int16) for a in (h0, x_hat0, h_hat0))
    m = torch.cat([m_x0, m_h0], dim=-1).to(torch.int32)
    hs, nz_dx, nz_dh = [], [], []
    for t in range(T):
        old = (h, xh, hh, m)
        h, xh, hh, m, mask_x, mask_h = gru_frame_step(
            fmt, xs[t], h, xh, hh, m, w_x, w_h, th_x, th_h)
        h, xh, hh = (a.to(torch.int16) for a in (h, xh, hh))
        nx = mask_x.sum(-1, dtype=torch.int32)
        nh = mask_h.sum(-1, dtype=torch.int32)
        if awake is not None:
            h, xh, hh, m = (_freeze(awake[t], n, o)
                            for n, o in zip((h, xh, hh, m), old))
            nx, nh = (torch.where(awake[t], n, 0) for n in (nx, nh))
        hs.append(h)
        nz_dx.append(nx)
        nz_dh.append(nh)
    final = (h, xh, hh, m[:, :3 * H], m[:, 3 * H:])
    if T == 0:
        z = torch.zeros((0, B), dtype=torch.int32, device=xs.device)
        return (torch.zeros((0, B, H), dtype=torch.int16, device=xs.device),
                final, z, z)
    return torch.stack(hs), final, torch.stack(nz_dx), torch.stack(nz_dh)


def check_int_kernel_fits(input_dim: int, hidden_dim: int) -> None:
    """Raise ``ValueError`` when the int kernel cannot hold this ΔGRU (its
    int8 weights and state in one block's shared memory, 3H columns and
    the input width on one block's threads)."""
    smem = int_seq_kernel_smem_bytes(input_dim, hidden_dim)
    threads = -(-3 * hidden_dim // 32) * 32
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"int8 ΔGRU I={input_dim}, H={hidden_dim} needs {smem} bytes of "
            f"shared memory per block; the delta_gru_seq_int kernel holds at "
            f"most {MAX_SMEM_BYTES} (227 KB on Hopper)")
    if threads > MAX_THREADS or input_dim > threads:
        raise ValueError(
            f"int8 ΔGRU I={input_dim}, H={hidden_dim} needs 3H <= "
            f"{MAX_THREADS} and I <= 3H rounded up to a warp ({threads})")


def _check_int_formats(fmt) -> None:
    if not 2 <= fmt.acc_bits <= 31:
        raise ValueError(f"delta_gru_seq_int: acc_bits must lie in [2, 31], "
                         f"got {fmt.acc_bits}")
    if not 1 <= fmt.hid_frac <= 15 or not 0 <= fmt.acc_frac <= 126:
        raise ValueError(f"delta_gru_seq_int: hid_frac {fmt.hid_frac} or "
                         f"acc_frac {fmt.acc_frac} out of range")
    for name in ("shift_x", "shift_h"):
        if not -30 <= getattr(fmt, name) <= 30:
            raise ValueError(f"delta_gru_seq_int: {name} "
                             f"{getattr(fmt, name)} out of [-30, 30]")


def _int_launcher():
    lib = build.load("delta_gru_seq_int")
    fn = lib.delta_gru_seq_int_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 7 + [p] * 8 + [i] * 9 + [p] * 2
        fn.restype = ctypes.c_int
    return lib, fn


def delta_gru_seq_int(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h, th, *,
                      fmt=None, packed: bool | None = None, awake=None,
                      block_b: int | None = None, block_t: int | None = None):
    """Run the integer ΔGRU over a whole chunk of frames in ONE launch
    (``B / block_b`` with ``block_b``; ``block_t`` frames of x codes
    staged at a time, default ``min(32, T)``).

    With ``fmt`` a ``core.fixed_point.GruFormats``: xs (T, B, I), h0,
    x_hat0, h_hat0 int16 codes, m_x0/m_h0 (B, 3H) int32 on the 24-bit
    saturating accumulator grid, w_x/w_h int8, ``th`` the integer
    [th_x, th_h] (a pair or a (1, 2) tensor).  Returns ``(hs (T, B, H)
    int16, (h, x̂, ĥ, m_x, m_h), nz_dx, nz_dh)``.  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/delta_gru_seq_int.cu``
    (contiguous, exact dtypes only).  ``awake`` (None, or a (T, B) bool
    wake trace) selects the masked instantiation, as in ``delta_gru_seq``.

    ``fmt=None`` is the identity-quant mode: float operands through the
    float ΔGRU (``delta_gru_seq``), which the reference defines as bit-
    identical to its float kernel; both ``th`` entries must be Δ_TH.

    ``packed`` is the reference's byte-plane float32 dot, a way round
    XLA's slow integer dot; it changes no numerics and the kernel, which
    accumulates int32 directly, ignores it.  Its argument checks stay.
    """
    from repro_torch.core.fixed_point import PACKED_DOT_MAX_K
    _check_shapes(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    T, B, I = xs.shape
    H = h0.shape[1]
    bb, block_t = _knobs("delta_gru_seq_int", xs, awake, block_b, block_t)
    if packed:
        if fmt is None:
            raise ValueError("delta_gru_seq_int: packed=True requires an "
                             "integer GruFormats (fmt is None — the "
                             "identity-quant mode has no int8 image)")
        if max(I, H) > PACKED_DOT_MAX_K:
            raise ValueError(
                f"delta_gru_seq_int: packed=True is only exact for "
                f"contraction dims <= {PACKED_DOT_MAX_K}, got I={I}, H={H}")
    th_x, th_h = _th_pair(th)
    if fmt is None:
        if th_x != th_h:
            raise ValueError(f"delta_gru_seq_int: the identity-quant mode "
                             f"takes one Δ_TH, got {th_x} and {th_h}")
        return delta_gru_seq(xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h,
                             float(th_x), awake, block_b=block_b,
                             block_t=block_t)
    _check_awake(awake, xs)
    if xs.device.type == "cpu":
        return delta_gru_seq_int_ref(xs, h0, x_hat0, h_hat0, m_x0, m_h0,
                                     w_x, w_h, (th_x, th_h), fmt=fmt,
                                     awake=awake, block_b=block_b,
                                     block_t=block_t)
    if xs.device.type != "cuda":
        raise ValueError(f"delta_gru_seq_int runs on cuda or cpu, not "
                         f"{xs.device}")
    args = (xs, h0, x_hat0, h_hat0, m_x0, m_h0, w_x, w_h)
    names = ("xs", "h0", "x_hat0", "h_hat0", "m_x0", "m_h0", "w_x", "w_h")
    dtypes = (torch.int16,) * 4 + (torch.int32,) * 2 + (torch.int8,) * 2
    for name, t, dt in zip(names, args, dtypes):
        if t.dtype != dt:
            raise TypeError(f"delta_gru_seq_int: {name} must be {dt}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"delta_gru_seq_int: {name} must be contiguous")
    plan = gru_int_launch_plan(bb, I, H, T, block_t)
    _check_int_formats(fmt)
    # Held until the launch is enqueued: a freed copy's block could be
    # handed to an output below.
    awake_c = None if awake is None else awake.contiguous()
    dev = xs.device
    hs = torch.empty((T, B, H), dtype=torch.int16, device=dev)
    nz_dx = torch.empty((T, B), dtype=torch.int32, device=dev)
    nz_dh = torch.empty((T, B), dtype=torch.int32, device=dev)
    final = (torch.empty_like(h0), torch.empty_like(x_hat0),
             torch.empty_like(h_hat0), torch.empty_like(m_x0),
             torch.empty_like(m_h0))
    if B == 0:
        return hs, (h0, x_hat0, h_hat0, m_x0, m_h0), nz_dx, nz_dh
    lib, fn = _int_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, bb):
            err = fn(*(a.data_ptr() for a in args), int(th_x), int(th_h),
                     fmt.shift_x, fmt.shift_h, fmt.acc_bits, fmt.acc_frac,
                     fmt.hid_frac, hs.data_ptr(), nz_dx.data_ptr(),
                     nz_dh.data_ptr(), *(a.data_ptr() for a in final), T, B,
                     I, H, plan["ctas"], plan["threads"], plan["smem_bytes"],
                     plan["x_frames"], b0,
                     None if awake_c is None else awake_c.data_ptr(), stream)
            build.check(lib, err, "delta_gru_seq_int kernel launch")
            if awake is None:
                delta_gru_seq_int.launches += 1
            else:
                delta_gru_seq_int.masked_launches += 1
    return hs, final, nz_dx, nz_dh


delta_gru_seq_int.launches = 0
delta_gru_seq_int.masked_launches = 0
