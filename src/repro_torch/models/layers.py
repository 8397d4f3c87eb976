"""Shared neural-net layers for the architecture zoo.

Port of ``repro/models/layers.py``.  Functional style: ``init_*`` builds
(params, logical_axes) dict pairs via :class:`AxTree`; ``apply_*`` are
plain functions on tensors.  All weights are stored in ``cfg.dtype``
(bf16 by default); norm scales and softmax statistics are kept in f32.

Initialisers draw from a ``torch.Generator`` on the generator's device,
with the reference's scales; ``key=None`` gives ``meta`` tensors (shapes
and dtypes only, no allocation: the counterpart of ``jax.eval_shape``).

Attention is the reference's ``_attend``: a direct masked softmax for a
one-token query or fewer than ``FLASH_MIN_KV`` keys, else the q/kv-tiled
online-softmax ``flash_attention`` whose backward recomputes the scores
per tile (an ``autograd.Function``).  Both are plain PyTorch, as the
reference's are plain JAX: no Pallas kernel lies on this path.

On a ``DeviceMesh`` the same functions run on DTensors (the reference's
GSPMD partitioning): DTensor propagates each op's sharding, the
``shd.act`` constraints redistribute, attention (direct or the tiled
``flash_attention``) runs per shard through ``local_map`` (its batch and
KV-head blocks are independent), a KV cache sharded on its sequence
writes only the positions its rank holds, and a decode step attends it
where it lies (``_attend_split_cache``: each rank's softmax partials,
combined by an all-reduce), ``project_cols`` contracts each rank's own
batch and sequence block with column blocks of a gathered weight, and
``tp_down_proj`` is the reference's Megatron-SP ``shard_map``: a local
partial product reduce-scattered over ``'model'`` onto the sequence dim.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import register_flop_formula

from repro_torch.parallel.sharding import (AxTree, Sharder, is_dtensor,
                                          local_bounds)

BIG_WINDOW = 1 << 30
FLASH_MIN_KV = 4096
KV_CHUNK = 1024
Q_CHUNK = 512
NEG = -1e30


# ------------------------------------------------------------------- utils
def _device(key) -> torch.device:
    return key.device if key is not None else torch.device("meta")


def _init(key, shape, dtype, scale=None):
    """Normal(0, scale²) in f32, cast to ``dtype``; default scale
    1/√fan_in (the second-to-last dim, or the only one)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(
        shape[0] if len(shape) == 1 else shape[-2])
    if key is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=key, device=key.device,
                    dtype=torch.float32)
    return (x * float(scale)).to(dtype)


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def stacked(shape, layers):
    return shape if layers is None else (layers, *shape)


def st_axes(axes, layers):
    return axes if layers is None else ("layers", *axes)


# Selective remat: ``checkpoint_name`` tags the ops run inside it, and
# ``save_names_policy`` tells torch.utils.checkpoint to keep the outputs of
# tagged ops instead of recomputing them (jax.checkpoint_policies.
# save_only_these_names).
_CHECKPOINT_NAME: contextvars.ContextVar = contextvars.ContextVar(
    "checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


def save_names_context(*names):
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint`` that
    saves the outputs of ops run under ``checkpoint_name(n)`` for ``n`` in
    ``names`` and recomputes every other op."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    keep = frozenset(names)

    def policy(ctx, op, *args, **kwargs):
        if _CHECKPOINT_NAME.get() in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def remat(fn, *args, context_fn=None):
    """``fn(*args)`` with its activations recomputed in backward
    (``jax.checkpoint``); a plain call when no gradient is recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def serving(fn):
    """Run ``fn(params, cfg, shd, ...)`` (a prefill or decode step) without
    autograd: ``torch.inference_mode()``, or ``torch.no_grad()`` on a
    mesh (a DTensor made outside inference mode cannot be viewed inside
    it)."""
    @functools.wraps(fn)
    def run(params, cfg, shd, *args, **kwargs):
        ctx = torch.inference_mode() if shd.mesh is None else torch.no_grad()
        with ctx:
            return fn(params, cfg, shd, *args, **kwargs)
    return run


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked (leading L dim) parameter subtree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------- norms
def init_norm(d: int, layers=None, *, bias=False, dtype=torch.float32,
              device="cpu"):
    t = AxTree()
    t.add("scale", _full(stacked((d,), layers), 1.0, dtype, device),
          st_axes(("act_embed",), layers))
    if bias:
        t.add("bias", _full(stacked((d,), layers), 0.0, dtype, device),
              st_axes(("act_embed",), layers))
    return t.build()


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    out = xf * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D) rotary over the last dim (half-split); positions:
    (..., S).  Angles in f32."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), ar / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def init_attention(key, cfg, layers=None):
    """GQA attention weights (d_model, n_heads, n_kv_heads, d_head, qk_norm,
    qkv_bias, dtype of ``cfg``)."""
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = _device(key)
    t = AxTree()
    t.add("wq", _init(key, stacked((D, H, Dh), layers), cfg.dtype),
          st_axes(("embed", "heads", "head_dim"), layers))
    t.add("wk", _init(key, stacked((D, K, Dh), layers), cfg.dtype),
          st_axes(("embed", "kv_heads", "head_dim"), layers))
    t.add("wv", _init(key, stacked((D, K, Dh), layers), cfg.dtype),
          st_axes(("embed", "kv_heads", "head_dim"), layers))
    t.add("wo", _init(key, stacked((H, Dh, D), layers), cfg.dtype,
                      scale=1.0 / np.sqrt(H * Dh)),
          st_axes(("heads", "head_dim", "embed"), layers))
    if cfg.qkv_bias:
        t.add("bq", _full(stacked((H, Dh), layers), 0.0, cfg.dtype, dev),
              st_axes(("heads", "head_dim"), layers))
        t.add("bk", _full(stacked((K, Dh), layers), 0.0, cfg.dtype, dev),
              st_axes(("kv_heads", "head_dim"), layers))
        t.add("bv", _full(stacked((K, Dh), layers), 0.0, cfg.dtype, dev),
              st_axes(("kv_heads", "head_dim"), layers))
    if cfg.qk_norm:
        t.add("q_norm", _full(stacked((Dh,), layers), 1.0, torch.float32, dev),
              st_axes(("head_dim",), layers))
        t.add("k_norm", _full(stacked((Dh,), layers), 1.0, torch.float32, dev),
              st_axes(("head_dim",), layers))
    return t.build()


def _rms_head(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.to(torch.float32)).to(x.dtype)


def _causal_mask(qpos, kpos, window):
    """(S, T) mask: key ≤ query, and inside the window when one is set."""
    m = kpos[None, :] <= qpos[:, None]
    if window is not None:
        m = m & (kpos[None, :] > (qpos[:, None] - window))
    return m


def _write_cache(cache, new, cache_index: int):
    """Write ``new`` (B, S, …) into ``cache`` (B, S_max, …) at
    ``cache_index`` along dim 1, in place, with the start clamped so the
    update fits (``jax.lax.dynamic_update_slice_in_dim`` semantics).

    A DTensor cache (sharded on its sequence by the ``kv_seq`` rule) is
    written shard by shard, each rank the positions of its own block.  A
    write of the whole cache (a prefill of ``S_max`` tokens) brings
    ``new`` to the cache's own placements, so each rank receives only
    its block (a local slice, or an all-to-all from a head split);
    otherwise ``new`` (a few tokens) is brought to them with the
    sequence whole."""
    S, S_max = new.shape[1], cache.shape[1]
    start = min(max(int(cache_index), 0), S_max - S)
    if not is_dtensor(cache):
        cache[:, start:start + S] = new.to(cache.dtype)
        return cache
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    if S == S_max:
        new = new.redistribute(mesh, cache.placements)
        cache.to_local().copy_(new.to_local().to(cache.dtype))
        return cache
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in cache.placements)
    new = new.redistribute(mesh, pl)
    lo, hi = local_bounds(cache, 1)
    a, b = max(start, lo), min(start + S, hi)
    if a < b:
        cache.to_local()[:, a - lo:b - lo] = \
            new.to_local()[:, a - start:b - start].to(cache.dtype)
    return cache


def apply_attention(p, cfg, x, shd: Sharder, *, positions, window=None,
                    kv_cache=None, cache_index=None, kv_positions=None,
                    causal: bool = True, cross_kv=None, attend_local=None):
    """GQA attention.

    Train/prefill: kv_cache=None → causal (+ optional sliding window) mask;
    ``causal=False`` gives bidirectional (encoder) attention.
    Decode: kv_cache=(k, v) of shape (B, S_max, K, Dh), written at
    ``cache_index`` in place; attends over all positions < cache_index+1.
    Prefill with a cache (S > 1) writes the cache but attends over the
    fresh local k/v (the builders always prefill at index 0).
    Cross-attention: ``cross_kv=(k, v)`` precomputed from the memory — no
    cache update, full attention over the memory.
    Returns (out, new_kv_cache or None).
    """
    B, S, D = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // K
    if attend_local is None:
        attend_local = S > 1

    q = project_heads(x, p["wq"], shd, "act_heads")
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"])
    if cross_kv is None:
        k = project_heads(x, p["wk"], shd, "kv_heads")
        v = project_heads(x, p["wv"], shd, "kv_heads")
        if cfg.qkv_bias:
            k = k + p["bk"]
            v = v + p["bv"]
        if cfg.qk_norm:
            k = _rms_head(k, p["k_norm"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if S > 1:
            k = shd.act(k, ("batch", "seq", "kv_heads", None))
            v = shd.act(v, ("batch", "seq", "kv_heads", None))
    else:
        k, v = cross_kv
    q = shd.act(q, ("batch", "seq", "act_heads", None))

    dev = x.device
    if cross_kv is not None:
        qpos, causal_mask, new_cache = None, False, None
    elif kv_cache is not None and attend_local:
        ck, cv = kv_cache
        new_cache = (_write_cache(ck, k, cache_index),
                     _write_cache(cv, v, cache_index))
        qpos = torch.arange(S, device=dev)
        causal_mask = True
        kv_cache = None           # train-style: static diagonal skipping
    elif kv_cache is not None:
        ck, cv = kv_cache
        k = _write_cache(ck, k, cache_index)
        v = _write_cache(cv, v, cache_index)
        new_cache = (k, v)
        qpos = int(cache_index) + torch.arange(S, device=dev)
        causal_mask = True
    else:
        qpos = torch.arange(S, device=dev)
        causal_mask = causal
        new_cache = None

    # Train/prefill causal path: qpos is structurally arange(S) → pass None
    # so _attend can skip above-diagonal KV tiles statically.
    qpos_arg = None if (kv_cache is None and cross_kv is None) else qpos
    mask_qpos = qpos if causal_mask else None
    m = _group_head_split(q, K, G)
    if kv_cache is not None and _seq_split_dims(k):
        # A decode step over a cache split on its sequence: the cache
        # stays where it lies.
        out = _attend_split_cache(q, k, v, int(cache_index), window)
    elif m is not None:
        out = _attend_head_blocks(q, k, v, m, G, mask_qpos, qpos_arg,
                                  window, causal_mask)
    else:
        if is_dtensor(q):
            # A head split the KV heads do not divide, and whose blocks
            # straddle KV groups, cannot survive the (H) → (K, G) view:
            # gather it first.
            from torch.distributed.tensor import Replicate, Shard
            q = q.redistribute(q.device_mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == 2
                and K % q.device_mesh.size(i) else p
                for i, p in enumerate(q.placements)))
        out = _attend(q.reshape(B, S, K, G, Dh), k, v, mask_qpos,
                      qpos=qpos_arg, window=window,
                      causal=causal_mask).reshape(B, S, H, Dh)
    out = out.to(x.dtype)
    out = shd.act(out, ("batch", "seq", "act_heads", None))
    out = tp_down_proj(out, p["wo"], shd, "bshe,hed->bsd",
                       ("batch", "seq", "act_heads", None),
                       ("heads", "head_dim", "embed"))
    return out, new_cache


def project_heads(x, w, shd: Sharder, heads: str):
    """``x`` (B, S, D) · ``w`` (D, N, Dh) → (B, S, N, Dh), placed by
    ``("batch", "seq", heads, None)``.

    On a mesh the product runs on each rank's local blocks (the weight's
    FSDP axes gathered first, the sequence whole): where the weight is
    split on its heads the output is, where it is split on the
    contraction (DECODE_RULES' embed) the output is a partial sum, and
    elsewhere the output keeps x's batch split.  DTensor's own einsum
    flattens N·Dh into one product column and may split that column on
    any axis, a split that cannot be viewed back into heads that the axis
    does not divide; here no flat column exists.  The output is then
    placed by its logical axes, which also reduces a partial sum before
    anything is added to the heads."""
    logical = ("batch", "seq", heads, None)
    if not is_dtensor(w):
        return shd.act(torch.einsum("bsd,dhe->bshe", x, w), logical)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    w = gather_fsdp(w)
    x = shd.act(x, ("batch", "seq", "act_embed"))
    x_pl, x_grad, w_grad, out_pl = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(wp, Shard) and wp.dim == 0:        # split contraction
            x_pl.append(Shard(2))
            x_grad.append(Shard(2))
            w_grad.append(wp)
            out_pl.append(Partial())
        elif isinstance(wp, Shard):                      # split heads
            x_pl.append(Replicate())
            x_grad.append(Partial())
            w_grad.append(wp)
            out_pl.append(Shard(wp.dim + 1))
        else:
            keep = xp if isinstance(xp, Shard) and xp.dim < 2 else Replicate()
            x_pl.append(keep)
            x_grad.append(keep)
            w_grad.append(Partial() if isinstance(keep, Shard)
                          else Replicate())
            out_pl.append(keep)
    x = x.redistribute(mesh, tuple(x_pl))
    y = torch.einsum("bsd,dhe->bshe", x.to_local(grad_placements=x_grad),
                     w.to_local(grad_placements=w_grad))
    return shd.act(DTensor.from_local(y, mesh, tuple(out_pl),
                                      run_check=False), logical)


def project_cols(x, w, cols):
    """``x`` (B, S, D) · ``w[:, a:b]`` (B, S, b − a) for each ``(a, b)`` of
    ``cols``.

    Without a mesh: one einsum per block.  On a mesh each rank contracts
    its own block of x, its batch and sequence splits kept (as GSPMD keeps
    them under a constraint on the output only), with its copy of the
    weight gathered whole once: a column block that straddles the weight's
    shards cannot be sliced from them.  Each product keeps x's splits; the
    caller places it, and a sequence split turned into a column split is
    then one all-to-all, never a gather of the whole product.  No flat
    product of the batch and the sequence is formed, so none is split on
    two mesh dims (a strided split, which some torch releases refuse).
    The weight's gradient is a partial sum over x's splits, reduced back
    onto the weight's own placements."""
    if not is_dtensor(w):
        return [torch.einsum("bsd,dk->bsk", x, w[:, a:b]) for a, b in cols]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    x_pl = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                 for p in x.placements)
    x = x.redistribute(mesh, x_pl)
    w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in x_pl)
    xl = x.to_local()
    wl = w.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=w_grad)
    return [DTensor.from_local(torch.einsum("bsd,dk->bsk", xl, wl[:, a:b]),
                               mesh, x_pl, run_check=False)
            for a, b in cols]


def merge_heads(y, shd: Sharder, heads: str = "act_heads"):
    """(B, S, N, Dh) → (B, S, N·Dh).  On a mesh the flat result is placed
    by the spec of its head axis (split on 'model' where 'model' divides
    N, whole where it does not), and so is its gradient: the backward of a
    merge views the gradient back into heads, which a flat split the axis
    does not divide into N cannot survive."""
    B, S, N, Dh = y.shape
    out = y.reshape(B, S, N * Dh)
    if not is_dtensor(out):
        return out
    from repro_torch.parallel.sharding import P, spec_placements
    spec = shd.spec((B, S, N, Dh), ("batch", "seq", heads, None))
    return out.redistribute(out.device_mesh, spec_placements(
        out.device_mesh, P(*spec[:3])))


def _group_head_split(q, K: int, G: int):
    """The mesh dim that splits the query heads of DTensor ``q`` (B, S, H,
    Dh) into blocks that each lie inside one KV group, where that dim does
    not divide the K KV heads (None otherwise: no such split, or the
    split carries over to the KV heads through the (H) → (K, G) view)."""
    if not is_dtensor(q):
        return None
    from torch.distributed.tensor import Shard
    for m, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 2:
            n = q.device_mesh.size(m)
            hl = q.shape[2] // n
            return m if K % n and G % hl == 0 else None
    return None


def _attend_head_blocks(q, k, v, m, G, mask_qpos, qpos, window, causal):
    """Attention with mesh dim ``m`` splitting the query heads but not the
    KV heads, each rank's query heads inside one KV group: each rank
    attends with its own query heads against the one KV head they share,
    sliced from its whole copy, so the query heads keep the split the
    Sharder gives them and no rank computes another's heads.  The batch
    keeps its split where q, k and v share it; the KV gradients are
    partial sums over ``m``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    batch = [p if isinstance(p, Shard) and p.dim == 0 and p == kp == vp
             else Replicate()
             for p, kp, vp in zip(q.placements, k.placements, v.placements)]
    q_pl = tuple(Shard(2) if i == m else b for i, b in enumerate(batch))
    kv_pl = tuple(Replicate() if i == m else b for i, b in enumerate(batch))
    kv_grad = tuple(Partial() if i == m else b for i, b in enumerate(batch))
    rank = mesh.get_local_rank(m)

    def blocks(ql, kl, vl):
        B, S, hl, Dh = ql.shape
        kv = rank * hl // G
        out = _attend(ql.reshape(B, S, 1, hl, Dh), kl[:, :, kv:kv + 1],
                      vl[:, :, kv:kv + 1], mask_qpos, qpos, window, causal)
        return out.reshape(B, S, hl, Dh)

    fn = local_map(blocks, out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh)
    return fn(q.redistribute(mesh, q_pl), k.redistribute(mesh, kv_pl),
              v.redistribute(mesh, kv_pl))


def _seq_split_dims(k) -> tuple:
    """The mesh dims that split the sequence (dim 1) of DTensor ``k``."""
    if not is_dtensor(k):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(k.placements)
                 if isinstance(p, Shard) and p.dim == 1)


def _attend_split_cache(q, k, v, q0: int, window):
    """Decode attention over a KV cache split on its sequence (the
    ``kv_seq`` rule): flash-decoding across ranks.  q: (B, S, H, Dh) at
    positions ``q0 + arange(S)``; k, v: (B, T, K, Dh) DTensors.

    The cache stays where it lies.  Each rank scores its own block of
    cache positions, only those a query may see (``≤ q0 + S − 1``, and
    inside the window), so no rank reads a position not yet written, and
    keeps the online-softmax partials in float32: the running max m, the
    sum l and the weighted values o.  The partials are combined over the
    mesh dims that split the sequence: an all-reduce (max) of m, then one
    all-reduce (sum) of [o·e^(m−M) | l·e^(m−M)], B × H × (Dh + 2) floats
    a layer in all.  The batch keeps its split, and so do the KV heads
    (the query heads with them).  A mesh dim that splits the query heads
    but not the KV heads keeps that split where each rank's query heads
    lie in one KV group or the dim divides the KV heads: the rank slices
    its KV heads from its block.  Elsewhere q (one token) is gathered.
    The output is replicated over the sequence's dims.  Serving only: the
    combine has no gradient."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k.device_mesh
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim < 3 else Replicate()
                  for p in k.placements)
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    kv_heads_split = any(p == Shard(2) for p in kv_pl)
    q_pl, head_dim = [], None
    for i, (kp, qp) in enumerate(zip(kv_pl, q.placements)):
        n = mesh.size(i)
        if kp in (Shard(0), Shard(2)):
            q_pl.append(kp)
        elif (kp == Replicate() and qp == Shard(2) and not kv_heads_split
              and head_dim is None and (K % n == 0 or G % (H // n) == 0)):
            q_pl.append(qp)
            head_dim = i
        else:
            q_pl.append(Replicate())
    q_pl = tuple(q_pl)
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = k.to_local(), v.to_local()
    if head_dim is not None:
        n, r = mesh.size(head_dim), mesh.get_local_rank(head_dim)
        kv0, kvn = ((r * K // n, K // n) if K % n == 0
                    else (r * ql.shape[2] // G, 1))
        kl, vl = kl[:, :, kv0:kv0 + kvn], vl[:, :, kv0:kv0 + kvn]
    Bl, _, Hl, _ = ql.shape
    Kl = kl.shape[2]
    qg = ql.reshape(Bl, S, Kl, Hl // Kl, Dh)
    f32, dev = torch.float32, ql.device
    lo, hi = local_bounds(k, 1)
    a = lo if window is None else max(lo, q0 - int(window) + 1)
    b = min(hi, q0 + S)
    if a < b:
        ks, vs = kl[:, a - lo:b - lo], vl[:, a - lo:b - lo]
        s = torch.einsum("bskge,btke->bkgst", qg, ks).to(f32) \
            * float(1.0 / np.sqrt(Dh))
        mask = _causal_mask(q0 + torch.arange(S, device=dev),
                            torch.arange(a, b, device=dev), window)
        s = torch.where(mask, s, torch.full((), NEG, device=dev))
        m = torch.amax(s, dim=-1)                                # (B,K,G,S)
        pr = torch.where(mask, torch.exp(s - m[..., None]),
                         torch.zeros((), device=dev))
        l = torch.sum(pr, dim=-1)
        o = torch.einsum("bkgst,btke->bkgse", pr.to(vs.dtype), vs).to(f32)
    else:
        m = torch.full((Bl, Kl, Hl // Kl, S), NEG, dtype=f32, device=dev)
        l = torch.zeros((Bl, Kl, Hl // Kl, S), dtype=f32, device=dev)
        o = torch.zeros((Bl, Kl, Hl // Kl, S, Dh), dtype=f32, device=dev)
    seq = _seq_split_dims(k)
    m_all = m
    for i in seq:
        m_all = funcol.all_reduce(m_all, "max", (mesh, i))
    c = torch.exp(m - m_all)
    part = torch.cat([o * c[..., None], (l * c)[..., None]], dim=-1)
    for i in seq:
        part = funcol.all_reduce(part, "sum", (mesh, i))
    out = (part[..., :Dh] / part[..., Dh:]).permute(0, 3, 1, 2, 4)
    out = out.reshape(Bl, S, Hl, Dh).to(q.dtype)
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=(B, S, H, Dh),
                              stride=(S * H * Dh, H * Dh, Dh, 1))


def _attend(qg, k, v, mask_qpos, qpos=None, window=None, causal=True):
    """Online-softmax attention.  qg: (B,S,K,G,Dh); k,v: (B,T,K,Dh).

    ``mask_qpos``: query positions of the causal mask (None = no mask).
    For T ≥ FLASH_MIN_KV uses the q/kv-tiled ``flash_attention`` (scores
    recomputed per tile in backward — S×T never materializes in either
    pass); a one-token query or a short T takes the direct path.
    """
    if is_dtensor(qg):
        return _attend_blocks(qg, k, v, mask_qpos, qpos, window, causal)
    B, S, K, G, Dh = qg.shape
    T = k.shape[1]
    scale = float(1.0 / np.sqrt(Dh))
    if S == 1 or T < FLASH_MIN_KV:
        # The dot runs in the operands' dtype (the reference's: no f32
        # copy of the cache); softmax statistics are f32.
        scores = torch.einsum("bskge,btke->bkgst", qg, k
                              ).to(torch.float32) * scale
        if mask_qpos is not None:
            mask = _causal_mask(mask_qpos, torch.arange(T, device=k.device),
                                window)
            scores = torch.where(mask[None, None, None], scores,
                                 torch.full((), NEG, device=scores.device))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgst,btke->bskge", probs, v)

    # Static causal diagonal: in train/prefill qpos == arange(S) and
    # S == T, so q-chunk i never attends kv-chunk j when j·ck ≥ (i+1)·cq.
    static_diag = (causal and qpos is None and S == T and window is None)
    if qpos is None:
        qpos = torch.arange(S, device=qg.device)
    win = BIG_WINDOW if window is None else int(window)
    return flash_attention(qg, k, v, qpos.to(torch.int64), win, causal,
                           static_diag)


def _attend_blocks(qg, k, v, mask_qpos, qpos, window, causal):
    """``_attend`` on DTensors, one block at a time: attention over a
    batch row and a KV-head group is independent of the others, so each
    rank runs the plain path, direct or tiled, on its block of the batch
    (dim 0) and the KV heads (dim 2); the sequences are gathered whole
    (the counterpart of the reference's partitioned attention)."""
    return local_blocks(
        lambda q_, k_, v_: _attend(q_, k_, v_, mask_qpos, qpos, window,
                                   causal), (qg, k, v), split_dims=(0, 2))


def local_blocks(fn, blocked, split_dims=(0,)):
    """``fn(*blocked)`` (DTensors on one mesh) on their local tensors, once
    per rank, through ``local_map``.  A mesh dim keeps its split where
    every tensor of ``blocked`` is split on the same dim of
    ``split_dims`` (their blocks are independent there); every other
    placement is gathered.  The output takes the blocks' placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = blocked[0].device_mesh
    pl = tuple(ps[0] if isinstance(ps[0], Shard) and ps[0].dim in split_dims
               and all(p == ps[0] for p in ps) else Replicate()
               for ps in zip(*(t.placements for t in blocked)))
    fn = local_map(fn, out_placements=list(pl),
                   in_placements=(pl,) * len(blocked),
                   in_grad_placements=(pl,) * len(blocked), device_mesh=mesh)
    return fn(*(t.redistribute(mesh, pl) for t in blocked))


def _tile_mask(qp, kp, window: int, causal: bool):
    """(cq, ck) mask from absolute positions."""
    if not causal:
        return torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                          device=qp.device)
    m = kp[None, :] <= qp[:, None]
    return m & (kp[None, :] > (qp[:, None] - window))


def _pick_chunks(S, T):
    cq = Q_CHUNK
    while S % cq:
        cq //= 2
    ck = KV_CHUNK
    while T % ck:
        ck //= 2
    return max(cq, 1), max(ck, 1)


def _f32(x):
    return x.to(torch.float32)


def _n_kv(i, nq, nk, cq, ck, static_diag):
    """KV chunks q-chunk ``i`` visits (all, or up to the diagonal)."""
    return min(nk, -(-((i + 1) * cq) // ck)) if static_diag else nk


def _flash_fwd_impl(qg, k, v, qpos, window, causal, static_diag):
    B, S, K, G, Dh = qg.shape
    T = k.shape[1]
    scale = float(1.0 / np.sqrt(Dh))
    cq, ck = _pick_chunks(S, T)
    nq, nk = S // cq, T // ck
    kp_all = torch.arange(T, device=k.device)
    outs, lses = [], []
    for i in range(nq):
        qb = qg[:, i * cq:(i + 1) * cq]                      # (B,cq,K,G,Dh)
        qp = qpos[i * cq:(i + 1) * cq]
        m = torch.full((B, K, G, cq), NEG, dtype=torch.float32,
                       device=qg.device)
        l = torch.zeros((B, K, G, cq), dtype=torch.float32, device=qg.device)
        acc = torch.zeros((B, K, G, cq, Dh), dtype=torch.float32,
                          device=qg.device)
        for j in range(_n_kv(i, nq, nk, cq, ck, static_diag)):
            kb = k[:, j * ck:(j + 1) * ck]
            vb = v[:, j * ck:(j + 1) * ck]
            s = torch.einsum("bskge,btke->bkgst", _f32(qb), _f32(kb)) * scale
            msk = _tile_mask(qp, kp_all[j * ck:(j + 1) * ck], window,
                             causal)[None, None, None]
            s = torch.where(msk, s, torch.full((), NEG, device=s.device))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            pr = torch.where(msk, torch.exp(s - m_new[..., None]),
                             torch.zeros((), device=s.device))
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(pr, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btke->bkgse", _f32(pr.to(vb.dtype)), _f32(vb))
            m = m_new
        lc = torch.clamp_min(l, 1e-20)
        outs.append(acc / lc[..., None])                     # (B,K,G,cq,Dh)
        lses.append(m + torch.log(lc))                       # (B,K,G,cq)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).to(v.dtype)
    return out.contiguous(), torch.cat(lses, dim=3)          # (B,S,K,G,Dh)


def _flash_bwd_impl(qg, k, v, qpos, window, causal, static_diag, out, lse,
                    dout):
    B, S, K, G, Dh = qg.shape
    T = k.shape[1]
    scale = float(1.0 / np.sqrt(Dh))
    cq, ck = _pick_chunks(S, T)
    nq, nk = S // cq, T // ck
    kp_all = torch.arange(T, device=k.device)
    dk = torch.zeros((B, T, K, Dh), dtype=torch.float32, device=k.device)
    dv = torch.zeros((B, T, K, Dh), dtype=torch.float32, device=k.device)
    dqs = []
    for i in range(nq):
        sl = slice(i * cq, (i + 1) * cq)
        qb, dob, ob, qp = qg[:, sl], dout[:, sl], out[:, sl], qpos[sl]
        lse_b = lse[..., sl]                                 # (B,K,G,cq)
        delta = torch.sum(_f32(dob) * _f32(ob), dim=-1)      # (B,cq,K,G)
        delta = delta.permute(0, 2, 3, 1)                    # (B,K,G,cq)
        dq = torch.zeros((B, cq, K, G, Dh), dtype=torch.float32,
                         device=qg.device)
        for j in range(_n_kv(i, nq, nk, cq, ck, static_diag)):
            ks = slice(j * ck, (j + 1) * ck)
            kb, vb = k[:, ks], v[:, ks]
            s = torch.einsum("bskge,btke->bkgst", _f32(qb), _f32(kb)) * scale
            msk = _tile_mask(qp, kp_all[ks], window, causal)[None, None, None]
            pr = torch.where(msk, torch.exp(s - lse_b[..., None]),
                             torch.zeros((), device=s.device))
            dv[:, ks] += torch.einsum("bkgst,bskge->btke", pr, _f32(dob))
            dp = torch.einsum("bskge,btke->bkgst", _f32(dob), _f32(vb))
            ds = pr * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bkgst,btke->bskge", ds, _f32(kb))
            dk[:, ks] += torch.einsum("bkgst,bskge->btke", ds, _f32(qb))
        dqs.append(dq)
    dq = torch.cat(dqs, dim=1).to(qg.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# The tiled passes are single operators (``torch.library.custom_op``): the
# eager kernels are the loops above, and their fake kernels give the
# outputs' shapes alone, so that a trace on fake tensors (the dry-run)
# takes one op per call instead of a few dozen per tile; their FLOPs are
# registered with ``FlopCounterMode`` (the tiles each pass visits).
@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              qpos: torch.Tensor, window: int, causal: bool,
              static_diag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _flash_fwd_impl(qg, k, v, qpos, window, causal, static_diag)


@flash_fwd.register_fake
def _(qg, k, v, qpos, window, causal, static_diag):
    B, S, K, G, Dh = qg.shape
    return (qg.new_empty(qg.shape, dtype=v.dtype),
            qg.new_empty((B, K, G, S), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              qpos: torch.Tensor, window: int, causal: bool,
              static_diag: bool, out: torch.Tensor, lse: torch.Tensor,
              dout: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _flash_bwd_impl(qg, k, v, qpos, window, causal, static_diag,
                           out, lse, dout)


@flash_bwd.register_fake
def _(qg, k, v, qpos, window, causal, static_diag, out, lse, dout):
    return qg.new_empty(qg.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def flash_tile_products(qg_shape, k_shape, static_diag) -> int:
    """Multiply-adds of one (cq × ck × Dh) score or value product, summed
    over the tiles a pass visits: 2·B·K·G·cq·ck·Dh per product."""
    B, S, K, G, Dh = qg_shape
    T = k_shape[1]
    cq, ck = _pick_chunks(S, T)
    nq, nk = S // cq, T // ck
    tiles = sum(_n_kv(i, nq, nk, cq, ck, static_diag) for i in range(nq))
    return 2 * B * K * G * cq * ck * Dh * tiles


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(qg, k, v, qpos, window, causal, static_diag, *a, **kw):
    return 2 * flash_tile_products(qg, k, static_diag)       # s, p·v


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(qg, k, v, qpos, window, causal, static_diag, *a, **kw):
    return 5 * flash_tile_products(qg, k, static_diag)  # s, dv, dp, dq, dk


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qg, k, v, qpos, window, causal, static_diag):
        out, lse = flash_fwd(qg, k, v, qpos, window, causal, static_diag)
        ctx.save_for_backward(qg, k, v, qpos, out, lse)
        ctx.window, ctx.causal, ctx.static_diag = window, causal, static_diag
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, qpos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(qg, k, v, qpos, ctx.window, ctx.causal,
                               ctx.static_diag, out, lse, dout.contiguous())
        return dq, dk, dv, None, None, None, None


def flash_attention(qg, k, v, qpos, window, causal: bool,
                    static_diag: bool = False):
    """Tiled online-softmax attention, (B,S,K,G,Dh) × (B,T,K,Dh) →
    (B,S,K,G,Dh), with a backward that recomputes each tile's scores from
    the saved log-sum-exp (the reference's custom VJP)."""
    return _FlashAttention.apply(qg, k, v, qpos, int(window), bool(causal),
                                 bool(static_diag))


# ------------------------------------------------- TP collective matmul
def tp_down_proj(h, w, shd: Sharder, eq: str, h_logical: tuple,
                 w_logical: tuple):
    """Tensor-parallel down-projection with sequence-parallel output.

    The reference's ``shard_map`` (Megatron-SP): each rank contracts its
    local blocks, the weight's FSDP axes all-gathered first, into a
    partial sum over ``'model'``; that DTensor (``Partial()`` on
    ``'model'``) is redistributed to ``Shard(1)``, one reduce-scatter
    in the activations' dtype onto the sequence dim, whose backward is an
    all-gather.  For a one-token step or a sequence ``'model'`` does not
    divide, the partial sum is reduced to the reference's fallback
    constraint (``res_seq``: an all-reduce); without a ``'model'`` axis,
    or with a contraction not sharded on it, it is the plain einsum and
    that constraint."""
    mesh = shd.mesh
    S = h.shape[1]
    res = ("batch", "res_seq", "act_embed")
    if mesh is None or shd._axis_sizes.get("model", 1) <= 1:
        return shd.act(torch.einsum(eq, h, w), res)
    h_spec = shd.spec(h.shape, h_logical)
    w_spec = shd.spec(w.shape, w_logical)
    contract_ok = (any(_spec_uses((ax,), "model") for ax in h_spec[2:] if ax)
                   and _spec_uses(w_spec, "model"))
    if not contract_ok:
        return shd.act(torch.einsum(eq, h, w), res)
    from torch.distributed.tensor import DTensor, Partial, Shard
    names = mesh.mesh_dim_names
    h = shd.act(h, h_logical)
    w = gather_fsdp(shd.act(w, w_logical))              # FSDP all-gather
    # Where the batch is split and the weight whole, each rank's weight
    # gradient is a partial sum over the batch blocks.
    w_grad_pl = tuple(Partial() if isinstance(hp, Shard)
                      and not isinstance(wp, Shard) else wp
                      for hp, wp in zip(h.placements, w.placements))
    partial = torch.einsum(eq, h.to_local(),
                           w.to_local(grad_placements=w_grad_pl))
    out = DTensor.from_local(partial, mesh, tuple(
        Partial() if n == "model" else p
        for n, p in zip(names, h.placements)), run_check=False)
    if S == 1 or S % shd._axis_sizes["model"]:
        return shd.act(out, res)
    return out.redistribute(mesh, tuple(
        Shard(1) if n == "model" else p
        for n, p in zip(names, h.placements)))


def gather_fsdp(w):
    """``w`` with its FSDP mesh axes (``pod``, ``data``) gathered and its
    other placements kept (``w`` itself off a mesh): the per-layer weight
    all-gather GSPMD issues before a product over sharded weights."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    return w.redistribute(mesh, tuple(
        Replicate() if n in ("pod", "data") else p
        for n, p in zip(mesh.mesh_dim_names, w.placements)))


def _spec_uses(spec, axis):
    for e in spec:
        if e == axis or (isinstance(e, tuple) and axis in e):
            return True
    return False


# --------------------------------------------------------------------- mlp
def init_mlp(key, cfg, layers=None, d_ff=None, act=None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    act = act or cfg.mlp_act
    t = AxTree()
    if act in ("swiglu", "geglu"):
        t.add("wi_gate", _init(key, stacked((D, F_), layers), cfg.dtype),
              st_axes(("embed", "mlp"), layers))
    t.add("wi", _init(key, stacked((D, F_), layers), cfg.dtype),
          st_axes(("embed", "mlp"), layers))
    t.add("wo", _init(key, stacked((F_, D), layers), cfg.dtype,
                      scale=1.0 / np.sqrt(F_)),
          st_axes(("mlp", "embed"), layers))
    return t.build()


def apply_mlp(p, cfg, x, shd: Sharder, act=None):
    """swiglu / geglu / gelu (tanh approximation, ``jax.nn.gelu``'s
    default) / relu2.  The up and gate products run under
    ``checkpoint_name("mlp_up")`` / ``("mlp_gate")``: the ``save_mlp``
    remat policy keeps them."""
    act = act or cfg.mlp_act
    if x.shape[1] > 1:
        x = shd.act(x, ("batch", "seq", "act_embed"))
    with checkpoint_name("mlp_up"):
        h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if act in ("swiglu", "geglu"):
        with checkpoint_name("mlp_gate"):
            g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(act)
    h = shd.act(h, ("batch", "seq", "act_mlp"))
    return tp_down_proj(h, p["wo"], shd, "bsf,fd->bsd",
                        ("batch", "seq", "act_mlp"), ("mlp", "embed"))


# --------------------------------------------------------------- embedding
def init_embedding(key, vocab_padded: int, d: int, dtype):
    t = AxTree()
    t.add("table", _init(key, (vocab_padded, d), dtype, scale=1.0),
          ("vocab", "embed"))
    return t.build()


def embed_tokens(p, tokens, shd: Sharder):
    """Rows of the table, by ``F.embedding``.  On a mesh the tokens become
    a batch-sharded DTensor, the table's FSDP axes are gathered (its
    vocab split stays), and the masked partial sum DTensor makes of a
    vocab-split lookup is reduced before the constraint."""
    table = p["table"]
    if not is_dtensor(table):
        return shd.act(F.embedding(tokens.to(torch.int64), table),
                       ("batch", "res_seq", "act_embed"))
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = shd.act(tokens, ("batch", "seq"))
    table = table.redistribute(mesh, tuple(
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in table.placements))
    x = F.embedding(tokens.to(torch.int64), table)
    x = x.redistribute(mesh, tuple(Replicate() if isinstance(q, Partial)
                                   else q for q in x.placements))
    return shd.act(x, ("batch", "res_seq", "act_embed"))


def _chunk_loss(xc, lc, head, vocab_size, shd):
    logits = torch.einsum("bsd,dv->bsv", xc, head).to(torch.float32)
    logits = shd.act(logits, ("batch", "seq", "act_vocab"))
    V = head.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = torch.where(pad[None, None],
                             torch.full((), NEG, device=logits.device),
                             logits)
    lse = _logsumexp_vocab(logits)
    if is_dtensor(logits):
        gold = _gold_logit(logits, lc)
    else:
        gold = torch.gather(logits, -1, lc[..., None].to(torch.int64))[..., 0]
    return torch.sum(lse - gold)


def _logsumexp_vocab(logits):
    """``logsumexp`` over the vocabulary (the last dim).  Where a mesh dim
    splits it, each rank reduces its own block around the all-reduced
    max and the sums are all-reduced: (B, S) floats, where DTensor's own
    ``logsumexp`` gathers the (B, S, V) logits on every rank."""
    from torch.distributed.tensor import Shard
    if not (is_dtensor(logits) and Shard(logits.ndim - 1)
            in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    m = _reduced(torch.amax(logits, dim=-1, keepdim=True).detach())
    return torch.log(_reduced(torch.sum(torch.exp(logits - m), dim=-1))) \
        + m[..., 0]


def _reduced(x):
    """DTensor ``x`` with its partial placements reduced to replicas: an
    all-reduce, where DTensor left to itself may scatter the reduction
    onto another dim and then gather against it in the backward."""
    from torch.distributed.tensor import Partial, Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def _gold_logit(logits, labels):
    """The gold logit of each position of DTensor ``logits`` (B, S, V):
    each rank picks it out of its own block of the vocabulary by a
    one-hot product (a rank that does not hold it adds 0), and the
    partial sums are reduced over the vocabulary's split.  No rank builds
    a one-hot of the whole vocabulary or gathers the logits, in either
    pass (DTensor's own ``one_hot`` of the labels is whole: (B, S, V)
    int64 on every rank)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, tuple(
        p if p == Shard(0) else Replicate() for p in pl))
    v0, v1 = local_bounds(logits, 2)
    ll = logits.to_local()
    hot = labels.to_local().to(torch.int64)[..., None] == torch.arange(
        v0, v1, device=ll.device)
    part = torch.sum(ll * hot.to(ll.dtype), dim=-1)
    return _reduced(DTensor.from_local(part, mesh, tuple(
        Partial() if p == Shard(2) else p for p in pl), run_check=False))


def chunked_softmax_xent(x, head, labels, shd: Sharder, n_chunks: int = 8,
                         vocab_size: int | None = None):
    """Mean cross-entropy with seq-chunked logits so (B,S,V) never fully
    materializes outside one chunk: each chunk's logits are recomputed in
    backward (``torch.utils.checkpoint``).  head: (D, V_padded); labels:
    (B, S)."""
    B, S, D = x.shape
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks
    # On a mesh the head's FSDP axes are gathered once, so that each
    # chunk's logits keep the batch's split (DTensor would otherwise
    # gather the activations to meet the weight's split contraction).
    head = gather_fsdp(head)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + remat(functools.partial(_chunk_loss, shd=shd),
                              x[:, sl], labels[:, sl], head, vocab_size)
    return total / (B * S)
