"""Delta-gated GRU (ΔGRU) — PyTorch port of ``repro/core/delta_gru.py``.

A neuron transmits its activation only when the change since the last
transmitted value exceeds Δ_TH:

    Δx_t[i] = x_t[i] - x̂_{t-1}[i]      if |x_t[i] - x̂_{t-1}[i]| > Δ_TH else 0
    x̂_t[i]  = x_t[i]                    if transmitted, else x̂_{t-1}[i]
    (and identically for the hidden state h with memory ĥ)

and the pre-activations are kept incrementally, M_t = M_{t-1} + W_x Δx_t
+ W_h Δh_t, so a zero delta skips the MAC and the weight read.  The gates
are the type-2 GRU (reset gate on the candidate's hidden pre-activation):

    r = σ(M_r), u = σ(M_u), c = tanh(M_xc + r ⊙ M_hc), h = u ⊙ h + (1-u) ⊙ c

``masked_delta_gru_scan`` is the stage-1 half of the two-stage wake
cascade: a slot runs only its awake frames.  ``delta_gru_scan(...,
event_driven=True)`` skips the slots that provably do nothing in a chunk
(``kernels.compaction``).

Training runs ``delta_gru_scan(backend="xla")``, the eager loop over
``DeltaGRUCell``: differentiable (σ, tanh and the fused products carry
JAX's derivative rules, ``kernels.xla_math``; the threshold acts as a
piecewise-constant gate and the gradient flows through the transmitted
path), and with ``h_qformat`` the QAT image of the IC's quantized ĥ.
The kernels have no backward and refuse inputs that need a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.quantize import ste_quantize
from repro_torch.kernels.delta_gru_seq import (MAX_SMEM_BYTES, delta_gru_seq,
                                               seq_kernel_fits)
from repro_torch.kernels.delta_matvec import delta_matvec, make_block_mask
from repro_torch.kernels.gru_math import delta_branch, gru_gates
from repro_torch.kernels.platform import refuse_grad


class DeltaGRUParams(NamedTuple):
    """Weights for a single ΔGRU layer (input dim I, hidden dim H)."""

    w_x: torch.Tensor  # (I, 3H)  -> [r | u | c] input kernels
    w_h: torch.Tensor  # (H, 3H)  -> [r | u | c] hidden kernels
    b: torch.Tensor    # (3H,)


class DeltaState(NamedTuple):
    """Carried state of the delta recurrence."""

    h: torch.Tensor       # (B, H)  hidden state
    x_hat: torch.Tensor   # (B, I)  last transmitted input
    h_hat: torch.Tensor   # (B, H)  last transmitted hidden
    m_x: torch.Tensor     # (B, 3H) accumulated input pre-activations (+ bias)
    m_h: torch.Tensor     # (B, 3H) accumulated hidden pre-activations


class DeltaStats(NamedTuple):
    """Per-step op statistics (all shapes (B,) per step, (T, B) stacked)."""

    nz_dx: torch.Tensor       # number of non-zero input deltas
    nz_dh: torch.Tensor       # number of non-zero hidden deltas
    macs: torch.Tensor        # MACs actually executed
    macs_dense: torch.Tensor  # MACs a dense GRU would execute
    sram_reads: torch.Tensor  # weight words read (== macs)


def init_delta_gru(generator: torch.Generator, input_dim: int,
                   hidden_dim: int) -> DeltaGRUParams:
    """Scaled-normal kernels, zero bias (on the generator's device)."""
    dev = generator.device
    w_x = torch.randn((input_dim, 3 * hidden_dim), generator=generator,
                      device=dev) * (1.0 / np.sqrt(input_dim))
    w_h = torch.randn((hidden_dim, 3 * hidden_dim), generator=generator,
                      device=dev) * (1.0 / np.sqrt(hidden_dim))
    b = torch.zeros((3 * hidden_dim,), device=dev)
    return DeltaGRUParams(w_x, w_h, b)


def init_delta_state(batch: int, input_dim: int, hidden_dim: int,
                     params: DeltaGRUParams) -> DeltaState:
    """Zero state on the weights' device.  m_x starts at the bias so
    M == W x̂ + W ĥ + b holds."""
    dev = params.b.device
    return DeltaState(
        h=torch.zeros((batch, hidden_dim), device=dev),
        x_hat=torch.zeros((batch, input_dim), device=dev),
        h_hat=torch.zeros((batch, hidden_dim), device=dev),
        m_x=params.b.float().expand(batch, 3 * hidden_dim).contiguous(),
        m_h=torch.zeros((batch, 3 * hidden_dim), device=dev),
    )


def delta_encode(x, x_hat, threshold):
    """Δ encoder: returns (delta, new_x_hat, transmitted_mask).

    delta[i] = x[i] - x_hat[i] where |x - x_hat| > th, else 0.  x_hat only
    advances for transmitted components (the IC's Δ-encoder semantics).
    """
    return delta_branch(x, x_hat, threshold)


def _stats_from_counts(nz_dx, nz_dh, in_dim: int,
                       hidden_dim: int) -> DeltaStats:
    """Rebuild DeltaStats from per-frame transmit counts (device-side)."""
    macs = (nz_dx + nz_dh) * (3 * hidden_dim)
    macs_dense = torch.full_like(macs, (in_dim + hidden_dim) * 3 * hidden_dim)
    return DeltaStats(nz_dx=nz_dx, nz_dh=nz_dh, macs=macs,
                      macs_dense=macs_dense, sram_reads=macs)


@dataclasses.dataclass(frozen=True)
class DeltaGRUCell:
    """One ΔGRU timestep.  threshold=0 reproduces the dense GRU.

    ``h_qformat`` (a ``core.quantize.QFormat``) snaps the hidden state to
    a fixed-point grid after the gates with a straight-through gradient —
    the QAT image of the IC's quantized ĥ memory (Q0.15 in the integer
    serving path): training then sees the same delta-threshold compares
    the deployed integer datapath performs.
    """

    hidden_dim: int
    threshold: float = 0.0
    h_qformat: Any = None

    def __call__(self, params: DeltaGRUParams, state: DeltaState, x
                 ) -> tuple[DeltaState, torch.Tensor, DeltaStats]:
        H = self.hidden_dim
        dx, x_hat, mx = delta_branch(x, state.x_hat, self.threshold)
        dh, h_hat, mh = delta_branch(state.h, state.h_hat, self.threshold)
        m_x = state.m_x + dx @ params.w_x          # (B, 3H)
        m_h = state.m_h + dh @ params.w_h          # (B, 3H)
        h = gru_gates(m_x, m_h, state.h, H)
        if self.h_qformat is not None:
            h = ste_quantize(h, self.h_qformat)
        stats = _stats_from_counts(mx.sum(-1, dtype=torch.int32),
                                   mh.sum(-1, dtype=torch.int32),
                                   x.shape[-1], H)
        return DeltaState(h, x_hat, h_hat, m_x, m_h), h, stats


def _auto_block(n: int, target: int = 128) -> int:
    """Largest divisor of ``n`` that is <= target."""
    for d in range(min(n, target), 0, -1):
        if n % d == 0:
            return d
    return 1


def _delta_gru_scan_blocked(params: DeltaGRUParams, xs, threshold: float,
                            state: DeltaState, block_i: int | None,
                            block_o: int | None, awake=None
                            ) -> tuple[torch.Tensor, DeltaState, DeltaStats]:
    """The scan over the block-sparse ``delta_matvec`` kernel, two
    launches per frame, for a ΔGRU whose weights the sequence kernel
    cannot hold: each frame derives the block masks from the thresholded
    deltas on the device and skips the weight tiles (and the MACs) of
    inactive blocks.  The state is carried as in every backend.  With a
    (T, B) bool ``awake``, each frame's new state and counts are kept
    only on awake slots, as ``masked_delta_gru_scan`` keeps them."""
    T, B, I = xs.shape
    H = params.w_h.shape[0]
    # block_i describes the INPUT axis; it carries over to the hidden
    # matvec only where it also divides H, else each axis picks its own.
    bi_x = block_i if block_i and I % block_i == 0 else _auto_block(I)
    bi_h = block_i if block_i and H % block_i == 0 else _auto_block(H)
    bo = block_o if block_o and (3 * H) % block_o == 0 else _auto_block(3 * H)
    hs, nz_dx, nz_dh = [], [], []
    for t in range(T):
        dx, x_hat, mx_mask = delta_branch(xs[t], state.x_hat, threshold)
        dh, h_hat, mh_mask = delta_branch(state.h, state.h_hat, threshold)
        m_x = delta_matvec(dx, params.w_x, state.m_x,
                           make_block_mask(dx, bi_x), block_i=bi_x,
                           block_o=bo)
        m_h = delta_matvec(dh, params.w_h, state.m_h,
                           make_block_mask(dh, bi_h), block_i=bi_h,
                           block_o=bo)
        h = gru_gates(m_x, m_h, state.h, H)
        nx = mx_mask.sum(-1, dtype=torch.int32)
        nh = mh_mask.sum(-1, dtype=torch.int32)
        new = DeltaState(h, x_hat, h_hat, m_x, m_h)
        if awake is not None:
            a = awake[t][:, None]
            new = DeltaState(*(torch.where(a, n, o)
                               for n, o in zip(new, state)))
            nx, nh = (torch.where(awake[t], n, 0) for n in (nx, nh))
        state = new
        hs.append(state.h)
        nz_dx.append(nx)
        nz_dh.append(nh)
    if T == 0:
        z = torch.zeros((0, B), dtype=torch.int32, device=xs.device)
        return xs.new_zeros((0, B, H)), state, _stats_from_counts(z, z, I, H)
    return (torch.stack(hs), state,
            _stats_from_counts(torch.stack(nz_dx), torch.stack(nz_dh), I, H))


def delta_gru_scan(params: DeltaGRUParams, xs, threshold: float = 0.0,
                   state: DeltaState | None = None, *,
                   backend: str = "xla", block_b: int | None = None,
                   block_t: int | None = None, block_i: int | None = None,
                   block_o: int | None = None,
                   smem_budget_bytes: int = MAX_SMEM_BYTES,
                   event_driven: bool = False, h_qformat=None,
                   consult_cache: bool = True
                   ) -> tuple[torch.Tensor, DeltaState, DeltaStats]:
    """Run a ΔGRU over ``xs`` of shape (T, B, I).

    Args:
      params: ``DeltaGRUParams`` (w_x (I, 3H), w_h (H, 3H), b (3H,)).
      xs: (T, B, I) frame-major inputs.
      threshold: Δ_TH — the transmit deadband (0.0 = dense GRU).
      state: carried ``DeltaState`` (None = fresh stream).
      backend: "xla" — a Python loop over ``DeltaGRUCell`` (the name of
        the reference's per-step path; differentiable, the training path)
        — or "pallas" — ``delta_gru_seq``,
        ONE launch of the hand-written kernel per chunk on a CUDA tensor
        (its plain version on a CPU tensor).  Where that kernel cannot
        hold the weights in ``smem_budget_bytes`` of shared memory (or
        3H columns on one block's threads), "pallas" takes the
        block-sparse path instead: ``delta_matvec`` twice per frame.
      block_b / block_t: the sequence kernel's launch knobs (streams per
        launch, frames of x staged at a time; ``kernels.autotune``).
        ``None`` consults the autotune cache for this (kernel, shape,
        dtype, threshold bucket, device) and otherwise keeps the default
        launch — behaviour is unchanged until a cache is tuned.  Both are
        numerics-invariant; the block-sparse path ignores them.
      block_i / block_o: the block-sparse path's input block (the mask's
        granularity) and output tile; None picks the largest divisor of
        each axis up to 128, as the reference does.
      smem_budget_bytes: the shared memory the sequence kernel may use
        (the counterpart of the reference's ``vmem_budget_bytes``); 0
        forces the block-sparse path.
      event_driven: active-slot compaction (``kernels.compaction``):
        slots whose whole chunk lies inside the Δ dead zone of their
        carried x̂ AND whose state a one-frame probe proves a bitwise
        fixed point are skipped; the rest run gathered through
        ``backend``.  Bit for bit the dense scan.  Host-level: it reads
        the candidate set and the probe's verdict back (two host syncs
        per call); the outputs stay on the device.  Incompatible with
        ``h_qformat`` and with inputs that need a gradient.
      h_qformat: QAT hidden-state quantization grid ("xla" backend only —
        see ``DeltaGRUCell``).
      consult_cache: False leaves a ``None`` knob at the default launch
        without reading the cache (a session passes the configuration it
        looked up once).

    Returns:
      (hs (T, B, H), final ``DeltaState``, ``DeltaStats`` stacked over T).
      Scanning [a|b] with the state carried equals one scan of the
      concatenation.
    """
    T, B, I = xs.shape
    H = params.w_h.shape[0]
    if state is None:
        state = init_delta_state(B, I, H, params)
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown ΔGRU backend: {backend!r}")
    if h_qformat is not None and backend != "xla":
        raise ValueError("h_qformat (QAT) requires the differentiable "
                         f"'xla' backend, got {backend!r}")
    if event_driven:
        if h_qformat is not None:
            raise ValueError("event_driven compaction is an inference "
                             "mode — incompatible with QAT (h_qformat)")
        refuse_grad("event_driven compaction", xs, *state, *params)
        from repro_torch.kernels import compaction

        def run(xs_c, st):
            hs, fin, stats = delta_gru_scan(
                params, xs_c, threshold, DeltaState(*st), backend=backend,
                block_i=block_i, block_o=block_o,
                smem_budget_bytes=smem_budget_bytes)
            return hs, tuple(fin), stats.nz_dx, stats.nz_dh

        held = compaction.held_slots(xs, state.x_hat, threshold)
        hs, st, nz_dx, nz_dh, _ = compaction.event_driven_seq(
            run, xs, tuple(state), held)
        return hs, DeltaState(*st), _stats_from_counts(nz_dx, nz_dh, I, H)
    if backend == "pallas":
        if not seq_kernel_fits(I, H, smem_budget_bytes):
            return _delta_gru_scan_blocked(params, xs, threshold, state,
                                           block_i, block_o)
        if consult_cache and (block_b is None or block_t is None):
            from repro_torch.kernels import autotune
            tuned = autotune.resolve("delta_gru_seq", (B, I, H), "float32",
                                     threshold, device=xs.device, B=B, T=T)
            block_b = block_b if block_b is not None else tuned.get("block_b")
            block_t = block_t if block_t is not None else tuned.get("block_t")
        hs, final, nz_dx, nz_dh = delta_gru_seq(
            xs.contiguous(), *state, params.w_x, params.w_h, threshold,
            block_b=block_b, block_t=block_t)
        return hs, DeltaState(*final), _stats_from_counts(nz_dx, nz_dh, I, H)
    cell = DeltaGRUCell(hidden_dim=H, threshold=threshold,
                        h_qformat=h_qformat)
    hs, per_step = [], []
    for t in range(T):
        state, h, stats = cell(params, state, xs[t])
        hs.append(h)
        per_step.append(stats)
    if T == 0:
        z = torch.zeros((0, B), dtype=torch.int32, device=xs.device)
        return (xs.new_zeros((0, B, H)), state,
                _stats_from_counts(z, z, I, H))
    stats = DeltaStats(*(torch.stack(f) for f in zip(*per_step)))
    return torch.stack(hs), state, stats


def masked_delta_gru_scan(params: DeltaGRUParams, xs, threshold: float,
                          state: DeltaState, awake, *,
                          block_i: int | None = None,
                          block_o: int | None = None,
                          smem_budget_bytes: int = MAX_SMEM_BYTES
                          ) -> tuple[torch.Tensor, DeltaState, DeltaStats]:
    """Wake-gated ΔGRU scan: the stage-1 half of the two-stage cascade.

    ``awake`` is a (T, B) bool trace from the stage-0 wake machine; on
    the frames where a slot sleeps its whole state (h, x̂, ĥ, M_x, M_h)
    stays bit-frozen, hs repeats the frozen h and the transmit counts are
    zero, so the stats count no executed MAC or weight read there while
    ``macs_dense`` stays dense — the reference's contract.  On a CUDA
    tensor one launch of the masked ``delta_gru_seq`` instantiation runs
    the chunk (an asleep frame costs the store of h); on a CPU tensor its
    plain version.  Where the sequence kernel cannot hold the weights
    (``seq_kernel_fits``; ``smem_budget_bytes`` 0 forces it) the
    block-sparse path runs with the same per-frame freeze.  Awake
    everywhere it is ``delta_gru_scan(backend="pallas")`` bit for bit.
    """
    T, B, I = xs.shape
    H = params.w_h.shape[0]
    if not seq_kernel_fits(I, H, smem_budget_bytes):
        return _delta_gru_scan_blocked(params, xs, threshold, state,
                                       block_i, block_o, awake=awake)
    hs, final, nz_dx, nz_dh = delta_gru_seq(
        xs.contiguous(), *state, params.w_x, params.w_h, threshold,
        awake=awake)
    return hs, DeltaState(*final), _stats_from_counts(nz_dx, nz_dh, I, H)


def dense_gru_scan(params: DeltaGRUParams, xs, h0=None) -> torch.Tensor:
    """Reference dense GRU (identical math to ΔGRU at threshold=0)."""
    T, B, _ = xs.shape
    H = params.w_h.shape[0]
    h = xs.new_zeros((B, H)) if h0 is None else h0
    hs = []
    for t in range(T):
        zx = xs[t] @ params.w_x + params.b
        zh = h @ params.w_h
        h = gru_gates(zx, zh, h, H)
        hs.append(h)
    return torch.stack(hs) if hs else xs.new_zeros((0, B, H))


def temporal_sparsity(stats: DeltaStats) -> torch.Tensor:
    """Fraction of dense MACs skipped, averaged over time and batch."""
    return 1.0 - stats.macs.sum() / stats.macs_dense.sum()
