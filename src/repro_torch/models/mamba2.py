"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Port of ``repro/models/mamba2.py``.  Training and prefill use the chunked
matmul ("SSD") form: a quadratic attention-like term within chunks plus
linear state passing between chunks.  Decode uses the O(1) recurrent
step, Δ-gated when ``cfg.use_delta`` (the paper's technique on the SSM
input projection: x_t @ w_in becomes M_t = M_{t-1} + Δx_t @ w_in, a plain
product of the sparse Δ, as in the reference).

Block layout (per layer):
  in_proj: d_model -> [z (d_inner) | x (d_inner) | B (G·N) | C (G·N) | dt (H)]
  causal depthwise conv (kernel 4) over [x|B|C]
  SSD:  h_t = exp(dt·A) h_{t-1} + dt·B x_t ;  y = C·h + D x
  gated RMSNorm (y * silu(z)), out_proj: d_inner -> d_model
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.delta_gru import delta_encode
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import AxTree, Sharder, is_dtensor

CHUNK = 256


def _dims(cfg):
    d_in = cfg.d_inner
    H = cfg.ssm_nheads
    P = cfg.ssm_headdim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    proj_dim = 2 * d_in + 2 * G * N + H
    return d_in, H, P, G, N, conv_dim, proj_dim


def init_mamba_block(key, cfg, layers=None):
    D = cfg.d_model
    d_in, H, P, G, N, conv_dim, proj_dim = _dims(cfg)
    dev = L._device(key)
    st, sa = L.stacked, L.st_axes
    t = AxTree()
    t.add("w_in", L._init(key, st((D, proj_dim), layers), cfg.dtype),
          sa(("embed", "mlp"), layers))
    t.add("conv_w", L._init(key, st((cfg.conv_kernel, conv_dim), layers),
                            cfg.dtype, scale=1.0 / np.sqrt(cfg.conv_kernel)),
          sa(("conv", "mlp"), layers))
    t.add("conv_b", L._full(st((conv_dim,), layers), 0.0, cfg.dtype, dev),
          sa(("mlp",), layers))
    t.add("a_log", L._full(st((H,), layers), 0.0, torch.float32, dev),
          sa(("heads",), layers))
    t.add("d_skip", L._full(st((H,), layers), 1.0, torch.float32, dev),
          sa(("heads",), layers))
    t.add("dt_bias", L._full(st((H,), layers), -2.0, torch.float32, dev),
          sa(("heads",), layers))
    t.add("norm_scale", L._full(st((d_in,), layers), 1.0, torch.float32, dev),
          sa(("mlp",), layers))
    t.add("w_out", L._init(key, st((d_in, D), layers), cfg.dtype,
                           scale=1.0 / np.sqrt(d_in)),
          sa(("mlp", "embed"), layers))
    return t.build()


def _split_proj(cfg, zxbcdt):
    d_in, H, P, G, N, conv_dim, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    return z, xbc, dt


def _split_xbc(cfg, xbc):
    d_in, H, P, G, N, _, _ = _dims(cfg)
    x = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + G * N]
    Cm = xbc[..., d_in + G * N:]
    return x, Bm, Cm


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (j ≤ i),
    -inf above the diagonal."""
    T = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    out = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full((), -torch.inf,
                                             device=x.device))


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, a, Bm, Cm, chunk: int = CHUNK):
    """SSD scan in chunked matmul form.

    x: (B,S,H,P)  dt: (B,S,H)  a: (H,) (negative)  Bm/Cm: (B,S,G,N)
    Returns (y (B,S,H,P), last state (B,H,P,N)).  On a mesh each rank
    scans its block of the batch and of the heads (``_ssd_blocks``).
    """
    if is_dtensor(x):
        return _ssd_blocks(x, dt, a, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    c = min(chunk, S)
    while S % c:
        c //= 2
    nc = S // c
    rep = H // G

    xx = x.reshape(Bsz, nc, c, H, P)
    dtc = dt.reshape(Bsz, nc, c, H)
    Bc = Bm.reshape(Bsz, nc, c, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(Bsz, nc, c, G, N).repeat_interleave(rep, dim=3)

    da = dtc * a[None, None, None, :]                            # (B,nc,c,H)
    da_cum = torch.cumsum(da, dim=2)                             # within chunk
    # ---- intra-chunk (quadratic) term --------------------------------------
    Lmat = torch.exp(_segsum(da.movedim(2, -1)))                 # (B,nc,H,c,c)
    scores = torch.einsum("bnihs,bnjhs->bnhij", Cc, Bc)          # (B,nc,H,c,c)
    y_diag = torch.einsum("bnhij,bnjhp->bnihp", scores * Lmat,
                          xx * dtc[..., None])
    # ---- chunk states ------------------------------------------------------
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)      # (B,nc,c,H)
    states = torch.einsum("bnchs,bnchp->bnhps",
                          Bc * (decay_to_end * dtc)[..., None], xx)
    # ---- inter-chunk recurrence --------------------------------------------
    chunk_decay = torch.exp(da_cum[:, :, -1, :])                 # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,P,N)
    # ---- inter-chunk output ------------------------------------------------
    decay_from_start = torch.exp(da_cum)                         # (B,nc,c,H)
    y_off = torch.einsum("bnchs,bnhps->bnchp", Cc, h_prev) \
        * decay_from_start[..., None]
    y = y_diag.reshape(Bsz, S, H, P) + y_off.reshape(Bsz, S, H, P)
    return y, h


def _ssd_blocks(x, dt, a, Bm, Cm, chunk):
    """``ssd_chunked`` on DTensors, one (batch, heads) block a rank: the
    scan of a (sequence, head) pair is independent of the others.  The
    batch keeps its split where x and dt share it, and so do the heads
    where each rank's heads cover whole groups of B and C or lie in one
    group; every other split is gathered.  B and C come whole on the head
    split, each rank taking its heads' groups, and ``a`` comes split with
    the heads; their gradients are partial sums where the blocks split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    H, G = x.shape[2], Bm.shape[2]
    rep = H // G
    pl = []
    for i, (p, q) in enumerate(zip(x.placements, dt.placements)):
        hl = H // mesh.size(i)
        heads_ok = hl % rep == 0 or rep % hl == 0
        pl.append(p if p == q and (p == Shard(0) or (p == Shard(2)
                                                     and heads_ok))
                  else Replicate())
    pl = tuple(pl)
    x, dt = x.redistribute(mesh, pl), dt.redistribute(mesh, pl)
    h0, h1 = L.local_bounds(x, 2)
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    bc_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    bc_grad = tuple(Partial() if p == Shard(2) else p for p in pl)
    a_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in pl)
    a_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(pl, a_pl))
    h_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)

    def scan(x_, dt_, b_, c_, a_):
        return ssd_chunked(x_, dt_, a_, b_[:, :, g0:g1], c_[:, :, g0:g1],
                           chunk)

    fn = local_map(scan, out_placements=(pl, h_pl),
                   in_placements=(pl, pl, bc_pl, bc_pl, a_pl),
                   in_grad_placements=(pl, pl, bc_grad, bc_grad, a_grad),
                   device_mesh=mesh)
    return fn(x, dt, Bm.redistribute(mesh, bc_pl),
              Cm.redistribute(mesh, bc_pl), a.redistribute(mesh, a_pl))


def _head_placed(t, shd: Sharder, heads: int):
    """``t`` (B, S, heads·P) placed as its heads (B, S, heads, P) are by
    ``("batch", "seq", "act_heads", None)``: split on 'model' where
    'model' divides the heads, whole where it does not."""
    if shd.mesh is None:
        return t
    from repro_torch.parallel.sharding import P, spec_placements
    B, S, n = t.shape
    spec = shd.spec((B, S, heads, n // heads),
                    ("batch", "seq", "act_heads", None))
    return t.redistribute(shd.mesh, spec_placements(shd.mesh, P(*spec[:3])))


def _in_proj(p, cfg, x, shd: Sharder):
    """The input projection's parts (z, x, [B | C], dt), each (B, S, ·),
    before the conv.

    Where the weight keeps its columns whole (no mesh, or ``d_proj`` not
    divided by 'model'), it is the reference's one product, sliced (on a
    mesh x is gathered whole on the sequence first: the product is then
    placed with the sequence whole, and x is the smaller operand).  Where
    'model' splits the columns, the parts' offsets straddle its shards,
    and a slice of the product would gather it whole on every rank: each
    part is then its own product (``L.project_cols``), z, x and dt placed
    by their heads (a rank holds only its heads) and [B | C], G·N wide
    each, whole."""
    d_in, H, P, G, N, conv_dim, _ = _dims(cfg)
    if _col_split_dim(p["w_in"]) is None:
        x = shd.act(x, ("batch", "seq", "act_embed"))
        zxbcdt = torch.einsum("bsd,dk->bsk", x, p["w_in"])
        zxbcdt = shd.act(zxbcdt, ("batch", "seq", "act_mlp"))
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        return z, xbc[..., :d_in], xbc[..., d_in:], dt
    z, xs, bc, dt = L.project_cols(x, p["w_in"], (
        (0, d_in), (d_in, 2 * d_in), (2 * d_in, d_in + conv_dim),
        (d_in + conv_dim, d_in + conv_dim + H)))
    return (_head_placed(z, shd, H), _head_placed(xs, shd, H),
            shd.act(bc, ("batch", "seq", None)), _head_placed(dt, shd, H))


def apply_mamba_train(p, cfg, x, shd: Sharder, return_state=False):
    """x: (B,S,D) → (B,S,D).  Training/prefill path (chunked SSD).  On a
    mesh each rank convolves, scans and normalises its own heads where
    the projection's columns are split (``_in_proj``)."""
    B, S, D = x.shape
    d_in, H, P, G, N, conv_dim, _ = _dims(cfg)
    z, x_raw, bc_raw, dt = _in_proj(p, cfg, x, shd)
    xs = _causal_conv(x_raw, p["conv_w"], p["conv_b"], 0)
    bc = _causal_conv(bc_raw, p["conv_w"], p["conv_b"], d_in)
    xs = xs.reshape(B, S, H, P)                # conv already applied silu
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])         # (B,S,H)
    a = -torch.exp(p["a_log"])                                   # (H,)
    f32 = torch.float32
    y, h_last = ssd_chunked(xs.to(f32), dt, a, Bm.to(f32), Cm.to(f32))
    y = y + p["d_skip"][None, None, :, None] * xs.to(f32)
    y = L.merge_heads(y, shd).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    out = torch.einsum("bsk,kd->bsd", y, p["w_out"])
    out = shd.act(out, ("batch", "res_seq", "act_embed"))
    if return_state:
        K = cfg.conv_kernel
        conv_tail = torch.cat([x_raw[:, S - (K - 1):],
                               bc_raw[:, S - (K - 1):]], dim=-1)  # (B,K-1,C)
        return out, (conv_tail.to(x.dtype), h_last)
    return out


def _causal_conv(xbc, w, b, col0: int = 0):
    """Depthwise causal conv1d, kernel K: xbc (B,S,C) holds the channels
    ``[col0, col0 + C)`` of w (K, ·) and b.  On a mesh it runs on each
    rank's block of the batch and of the channels, with the rank's
    columns of the weights (gathered whole: they are K + 1 rows): some
    torch releases (2.11) fail to redistribute DTensor's ``F.pad``."""
    if is_dtensor(xbc):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = xbc.device_mesh
        pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                   else Replicate() for p in xbc.placements)
        xbc = xbc.redistribute(mesh, pl)
        lo, hi = L.local_bounds(xbc, 2)
        rep = (Replicate(),) * mesh.ndim
        grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in pl)
        w = w.redistribute(mesh, rep).to_local(grad_placements=grad)
        b = b.redistribute(mesh, rep).to_local(grad_placements=grad)
        out = _causal_conv(xbc.to_local(), w, b, col0 + lo)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    K, S, C = w.shape[0], xbc.shape[1], xbc.shape[2]
    w, b = w[:, col0:col0 + C], b[col0:col0 + C]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S] * w[i][None, None] for i in range(K))
    return F.silu(out + b[None, None])


def _gated_norm(y, z, scale, eps=1e-6):
    yf = (y * F.silu(z)).to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * scale).to(y.dtype)


# ------------------------------------------------------------------ decode
class MambaCache(NamedTuple):
    conv: torch.Tensor    # (L, B, K-1, conv_dim) rolling conv inputs
    ssm: torch.Tensor     # (L, B, H, P, N) recurrent state
    # Δ-gating stream (paper technique): last transmitted input + accumulator
    x_hat: torch.Tensor   # (L, B, D)
    m_acc: torch.Tensor   # (L, B, proj_dim)


def _cache_shapes(cfg, batch, nl):
    d_in, H, P, G, N, conv_dim, proj_dim = _dims(cfg)
    return [((nl, batch, cfg.conv_kernel - 1, conv_dim), cfg.dtype),
            ((nl, batch, H, P, N), torch.float32),
            ((nl, batch, cfg.d_model), cfg.dtype),
            ((nl, batch, proj_dim), torch.float32)]


def mamba_cache_axes():
    return (("layers", "batch", None, "act_mlp"),
            ("layers", "batch", "heads", None, None),
            ("layers", "batch", None),
            ("layers", "batch", "act_mlp"))


def init_mamba_cache(cfg, batch: int, shd: Sharder, layers=None,
                     device="cpu") -> MambaCache:
    """Zero recurrent cache; on a mesh each buffer is placed per
    ``mamba_cache_axes``."""
    nl = layers if layers is not None else cfg.num_layers
    return MambaCache(*[shd.zeros(s, ax, d, device) for (s, d), ax in zip(
        _cache_shapes(cfg, batch, nl), mamba_cache_axes())])


def mamba_cache_specs(cfg, batch: int, shd: Sharder, layers=None
                      ) -> MambaCache:
    nl = layers if layers is not None else cfg.num_layers
    return MambaCache(*[shd.spec_tensor(s, ax, d) for (s, d), ax in zip(
        _cache_shapes(cfg, batch, nl), mamba_cache_axes())])


def apply_mamba_decode(p, cfg, x, cache: tuple, shd: Sharder,
                       delta_threshold: float | None = None):
    """One-token recurrent step.  x: (B,D); cache: per-layer slices of
    MambaCache (conv (B,K-1,C), ssm (B,H,P,N), x_hat (B,D), m_acc (B,proj)).

    With ``cfg.use_delta`` the input projection x @ w_in is Δ-gated
    (incremental accumulator) — the DeltaKWS mechanism on the SSM block.
    Returns (y (B,D), new_cache_slices, nnz_fraction).
    """
    conv_st, ssm_st, x_hat, m_acc = cache
    B, D = x.shape
    d_in, H, P, G, N, conv_dim, _ = _dims(cfg)
    th = cfg.delta_threshold if delta_threshold is None else delta_threshold
    f32 = torch.float32

    if cfg.use_delta:
        dx, x_hat, mask = delta_encode(
            x, x_hat, torch.tensor(th, dtype=x.dtype, device=x.device))
        m_acc = m_acc + torch.einsum("bd,dk->bk", dx, p["w_in"]).to(f32)
        zxbcdt = m_acc.to(x.dtype)
        nnz = torch.mean(mask.to(f32))
    else:
        zxbcdt = torch.einsum("bd,dk->bk", x, p["w_in"])
        nnz = torch.ones((), dtype=f32, device=x.device)

    z, xbc, dt = _decode_proj_parts(cfg, zxbcdt, conv_st, shd)
    conv_in = torch.cat([conv_st, xbc[:, None]], dim=1)          # (B,K,C)
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"])
                   + p["conv_b"][None])
    new_conv = conv_in[:, 1:]
    xs, Bm, Cm = _decode_xbc_parts(cfg, xbc_c)  # conv already applied silu
    xs = xs.reshape(B, H, P)
    rep = H // G
    Bh = Bm.reshape(B, G, N).repeat_interleave(rep, dim=1)       # (B,H,N)
    Ch = Cm.reshape(B, G, N).repeat_interleave(rep, dim=1)
    dt = _softplus(dt.to(f32) + p["dt_bias"])                    # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None])                              # (B,H)
    xf = xs.to(f32)
    new_ssm = (ssm_st * decay[..., None, None]
               + xf[..., :, None] * Bh.to(f32)[..., None, :]
               * dt[..., None, None])
    y = _ssm_readout(new_ssm, Ch.to(f32))
    y = y + p["d_skip"][None, :, None] * xf
    y = y.reshape(B, d_in).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    out = torch.einsum("bk,kd->bd", y, p["w_out"])
    return out, (new_conv, new_ssm, x_hat, m_acc), nnz


def _decode_proj_parts(cfg, zxbcdt, conv_st, shd: Sharder):
    """The decode step's (z, [x | B | C], dt) of its projection (B,
    d_proj).  On a mesh whose 'model' axis splits the projection's
    columns (the accumulator's ``act_mlp`` placement), its parts' offsets
    straddle the shards: ``_relayout_cols`` hands z and dt out by heads and
    [x | B | C] as the conv state is split, in one all-to-all, and no rank
    gathers the projection."""
    d_in, H, P, G, N, conv_dim, proj = _dims(cfg)
    if not is_dtensor(zxbcdt):
        return _split_proj(cfg, zxbcdt)
    zxbcdt = shd.act(zxbcdt, ("batch", "act_mlp"))    # reduces a partial
    m = _col_split_dim(zxbcdt)
    if m is None:
        return _split_proj(cfg, zxbcdt)
    from torch.distributed.tensor import Shard
    n = zxbcdt.device_mesh.size(m)
    heads = H % n == 0
    return _relayout_cols(zxbcdt, m, (
        (0, d_in, heads),
        (d_in, d_in + conv_dim, conv_st.placements[m] == Shard(2)),
        (d_in + conv_dim, proj, heads)))


def _decode_xbc_parts(cfg, xbc):
    """The decode step's (x, B, C) of its conv output (B, conv_dim): on a
    mesh that splits its columns, x comes out by heads and B, C whole
    (``_relayout_cols``)."""
    d_in, H, P, G, N, conv_dim, _ = _dims(cfg)
    m = _col_split_dim(xbc)
    if m is None:
        return _split_xbc(cfg, xbc)
    return _relayout_cols(xbc, m, (
        (0, d_in, H % xbc.device_mesh.size(m) == 0),
        (d_in, d_in + G * N, False), (d_in + G * N, conv_dim, False)))


def _col_split_dim(t):
    """The mesh dim that splits dim 1 of ``t`` (a DTensor), or None."""
    if not is_dtensor(t):
        return None
    from torch.distributed.tensor import Shard
    return next((i for i, p in enumerate(t.placements) if p == Shard(1)),
                None)


def _relayout_cols(t, m: int, parts):
    """Parts of DTensor ``t`` (B, C), whose columns mesh dim ``m`` splits
    into even blocks, each in its own layout, by one all-to-all over
    ``m``: each rank receives only the columns it lacks.

    ``parts``: ``(a, b, split)`` for the columns ``[a, b)``: split, rank r
    takes the r-th of n even shares of them (``Shard(1)`` on ``m``; a
    share needs n | b − a), else every rank takes them all
    (``Replicate()`` on ``m``).  The other mesh dims keep their
    placements.  Serving only: the exchange has no gradient."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = t.device_mesh
    n, r = mesh.size(m), mesh.get_local_rank(m)
    w = t.shape[1] // n
    parts = [(a, b, split and (b - a) % n == 0) for a, b, split in parts]

    def wanted(d):
        return [(a + d * ((b - a) // n), a + (d + 1) * ((b - a) // n))
                if split else (a, b) for a, b, split in parts]

    def held(iv, src):
        lo, hi = max(iv[0], src * w), min(iv[1], (src + 1) * w)
        return (lo, hi) if lo < hi else None

    tl = t.to_local()
    send, in_sizes = [], []
    for d in range(n):
        pieces = [tl[:, o[0] - r * w:o[1] - r * w] for iv in wanted(d)
                  if (o := held(iv, r))]
        send.extend(pieces)
        in_sizes.append(sum(x.shape[1] for x in pieces))
    mine = wanted(r)
    out_sizes = [sum(o[1] - o[0] for iv in mine if (o := held(iv, s)))
                 for s in range(n)]
    buf = torch.cat(send, dim=1).t().contiguous()
    recv = funcol.all_to_all_single(buf, out_sizes, in_sizes, (mesh, m))
    recv = funcol.wait_tensor(recv).t()
    blocks, off = {}, 0
    for s in range(n):                    # a source's pieces, part by part
        for i, iv in enumerate(mine):
            if (o := held(iv, s)):
                blocks[i, s] = recv[:, off:off + o[1] - o[0]]
                off += o[1] - o[0]
    out = []
    for i, (_, _, split) in enumerate(parts):
        local = torch.cat([blocks[i, s] for s in range(n)
                           if (i, s) in blocks], dim=1).contiguous()
        pl = tuple((Shard(1) if split else Replicate()) if j == m else p
                   for j, p in enumerate(t.placements))
        out.append(DTensor.from_local(local, mesh, pl, run_check=False))
    return out


def _ssm_readout(ssm, c):
    """y = C·h for each (batch, head): ``einsum("bhpn,bhn->bhp")``.  On a
    mesh it runs on each rank's (batch, head) block, C placed as the state
    is: DTensor's own einsum flattens a split batch and a split head dim
    into one strided split, whose propagation reads a value on the host."""
    def readout(s, cc):
        return torch.einsum("bhpn,bhn->bhp", s, cc)
    if not is_dtensor(ssm):
        return readout(ssm, c)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
               for p in ssm.placements)
    return L.local_blocks(readout, (ssm.redistribute(ssm.device_mesh, pl),
                                    c.redistribute(ssm.device_mesh, pl)),
                          split_dims=(0, 1))


# --------------------------------------------------------------- full model
def init_lm(key, cfg):
    dev = L._device(key)
    t = AxTree()
    t.sub("embed", L.init_embedding(key, cfg.vocab_padded, cfg.d_model,
                                    cfg.dtype))
    t.sub("mamba", init_mamba_block(key, cfg, layers=cfg.num_layers))
    t.sub("norm1", L.init_norm(cfg.d_model, layers=cfg.num_layers,
                               device=dev))
    t.sub("norm_f", L.init_norm(cfg.d_model, device=dev))
    head = AxTree()
    head.add("w", L._init(key, (cfg.d_model, cfg.vocab_padded), cfg.dtype),
             ("embed", "vocab"))
    t.sub("lm_head", head)
    return t.build()


def _layer(params, i):
    return {"mamba": L.layer_slice(params["mamba"], i),
            "norm1": L.layer_slice(params["norm1"], i)}


def _residual_block(cfg, shd, x, lp):
    h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
    h = apply_mamba_train(lp["mamba"], cfg, h, shd)
    return shd.act(x + h, ("batch", "res_seq", "act_embed"))


def forward(params, cfg, shd: Sharder, tokens, remat=True):
    x = L.embed_tokens(params["embed"], tokens, shd)
    body = functools.partial(_residual_block, cfg, shd)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        x = L.remat(body, x, lp) if remat else body(x, lp)
    return L.apply_norm(params["norm_f"], x, cfg.norm_type)


def loss_fn(params, cfg, shd, batch):
    x = forward(params, cfg, shd, batch["tokens"])
    ce = L.chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                shd, vocab_size=cfg.vocab_size)
    return ce, {"ce": ce}


def decode_layers(params, cfg, shd, x, cache: MambaCache, layers):
    """Run the recurrent step of ``layers`` (indices into the stacked
    weights and cache) on x (B,D) → (x, per-layer new cache slices)."""
    new = []
    for i in layers:
        lp = _layer(params, i)
        h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
        h, c, _ = apply_mamba_decode(
            lp["mamba"], cfg, h, tuple(t[i] for t in cache), shd)
        x = x + h
        new.append(c)
    return x, new


def stack_cache(slices) -> MambaCache:
    """Per-layer (conv, ssm, x_hat, m_acc) slices → a stacked MambaCache."""
    return MambaCache(*[torch.stack(list(f)) for f in zip(*slices)])


@L.serving
def decode_step(params, cfg, shd, cache: MambaCache, tokens):
    """tokens (B,1) → (logits (B,1,V), cache)."""
    x = L.embed_tokens(params["embed"], tokens, shd)[:, 0]       # (B,D)
    x, new = decode_layers(params, cfg, shd, x, cache, range(cfg.num_layers))
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    logits = torch.einsum("bd,dv->bv", x, params["lm_head"]["w"])[:, None]
    logits = shd.act(logits, ("batch", None, "act_vocab"))
    return logits, stack_cache(new)


@L.serving
def prefill(params, cfg, shd, tokens, cache: MambaCache, embeds=None):
    """Process a full prompt, producing the recurrent cache + last logits."""
    x = L.embed_tokens(params["embed"], tokens, shd)
    conv, ssm = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
        h, (conv_tail, s) = apply_mamba_train(lp["mamba"], cfg, h, shd,
                                              return_state=True)
        x = x + h
        conv.append(conv_tail)
        ssm.append(s)
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    logits = torch.einsum("bd,dv->bv", x[:, -1],
                          params["lm_head"]["w"])[:, None]
    new_cache = MambaCache(conv=torch.stack(conv), ssm=torch.stack(ssm),
                           x_hat=cache.x_hat, m_acc=cache.m_acc)
    return new_cache, shd.act(logits, ("batch", None, "act_vocab"))


def make_api(cfg, shd: Sharder, device=None):
    from repro_torch.models.transformer import LMApi, resolve
    return LMApi(
        init=functools.partial(init_lm, cfg=cfg),
        loss=lambda params, batch: loss_fn(params, cfg, shd, batch),
        prefill=lambda params, tokens, cache, embeds=None: prefill(
            params, cfg, shd, tokens, cache, embeds),
        decode_step=lambda params, cache, tokens: decode_step(
            params, cfg, shd, cache, tokens),
        init_cache=lambda batch, seq: init_mamba_cache(
            cfg, batch, shd, device=resolve(device)),
        cache_specs=lambda batch, seq: mamba_cache_specs(cfg, batch, shd),
    )
