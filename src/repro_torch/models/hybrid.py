"""Zamba2-style hybrid: Mamba2 backbone + one SHARED attention block
[arXiv:2411.15242].

Port of ``repro/models/hybrid.py``.  Every ``cfg.shared_attn_every``
Mamba layers, a single shared transformer block (attention + MLP, one set
of weights reused at every application) is applied to
``proj_g([x, x0])`` — the concatenation of the current hidden state and
the original embedding through a per-application projection.

Structure (54 layers, every=6 → 9 groups):
  x0 = embed(tokens)
  for g in 1..9:
      x = 6 mamba layers (x)
      x = x + SharedBlock(proj_g([x, x0]))
Shared-block KV caches are per application: (n_app, B, S, K, Dh), written
in place.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.parallel.sharding import AxTree, Sharder


def _n_groups(cfg):
    if cfg.num_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not group by "
                         f"shared_attn_every={cfg.shared_attn_every}")
    return cfg.num_layers // cfg.shared_attn_every


def init_lm(key, cfg):
    ng = _n_groups(cfg)
    dev = L._device(key)
    t = AxTree()
    t.sub("embed", L.init_embedding(key, cfg.vocab_padded, cfg.d_model,
                                    cfg.dtype))
    t.sub("mamba", M.init_mamba_block(key, cfg, layers=cfg.num_layers))
    t.sub("norm1", L.init_norm(cfg.d_model, layers=cfg.num_layers,
                               device=dev))
    # shared attention block (one copy)
    t.sub("sh_attn", L.init_attention(key, cfg, layers=None))
    t.sub("sh_mlp", L.init_mlp(key, cfg, layers=None))
    t.sub("sh_norm1", L.init_norm(cfg.d_model, device=dev))
    t.sub("sh_norm2", L.init_norm(cfg.d_model, device=dev))
    cat = AxTree()
    cat.add("w", L._init(key, (ng, 2 * cfg.d_model, cfg.d_model), cfg.dtype),
            ("layers", "embed", None))
    t.sub("w_cat", cat)
    t.sub("norm_f", L.init_norm(cfg.d_model, device=dev))
    head = AxTree()
    head.add("w", L._init(key, (cfg.d_model, cfg.vocab_padded), cfg.dtype),
             ("embed", "vocab"))
    t.sub("lm_head", head)
    return t.build()


def _group_layers(cfg, g):
    ev = cfg.shared_attn_every
    return range(g * ev, (g + 1) * ev)


def _shared_block(params, cfg, shd, xin, positions, kv_cache=None,
                  cache_index=None):
    h = L.apply_norm(params["sh_norm1"], xin, cfg.norm_type)
    h, new_kv = L.apply_attention(params["sh_attn"], cfg, h, shd,
                                  positions=positions, kv_cache=kv_cache,
                                  cache_index=cache_index)
    xin = xin + h
    h = L.apply_norm(params["sh_norm2"], xin, cfg.norm_type)
    h = L.apply_mlp(params["sh_mlp"], cfg, h, shd)
    return xin + h, new_kv


def _mamba_residual(cfg, shd, x, lp):
    h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
    return x + M.apply_mamba_train(lp["mamba"], cfg, h, shd)


def _mix_in(x, x0, w, shd: Sharder):
    """The shared block's input, ``[x | x0] · w_cat``, placed as the
    residual stream is (``res_seq``).  On a mesh each rank contracts its
    own block of the batch and the sequence (``L.project_cols``): the
    input, twice the model's width, is never gathered."""
    (out,) = L.project_cols(torch.cat([x, x0], dim=-1), w,
                            ((0, w.shape[1]),))
    return shd.act(out, ("batch", "res_seq", "act_embed"))


def forward(params, cfg, shd: Sharder, tokens, remat=True):
    x0 = L.embed_tokens(params["embed"], tokens, shd)
    S = x0.shape[1]
    positions = torch.arange(S, device=x0.device)
    body = functools.partial(_mamba_residual, cfg, shd)
    x = x0
    for g in range(_n_groups(cfg)):
        for i in _group_layers(cfg, g):
            lp = M._layer(params, i)
            x = L.remat(body, x, lp) if remat else body(x, lp)
        xin = _mix_in(x, x0, params["w_cat"]["w"][g], shd)
        out, _ = _shared_block(params, cfg, shd, xin, positions)
        x = shd.act(x + out, ("batch", "res_seq", "act_embed"))
    return L.apply_norm(params["norm_f"], x, cfg.norm_type)


def loss_fn(params, cfg, shd, batch):
    x = forward(params, cfg, shd, batch["tokens"])
    ce = L.chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                shd, vocab_size=cfg.vocab_size)
    return ce, {"ce": ce}


# ------------------------------------------------------------------ decode
class HybridCache(NamedTuple):
    mamba: M.MambaCache
    k: torch.Tensor       # (n_app, B, S, K, Dh)
    v: torch.Tensor
    index: int


KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def init_cache(cfg, batch: int, seq: int, shd: Sharder, device="cpu"
               ) -> HybridCache:
    shape = (_n_groups(cfg), batch, seq, cfg.n_kv_heads, cfg.d_head)
    return HybridCache(
        mamba=M.init_mamba_cache(cfg, batch, shd, device=device),
        k=shd.zeros(shape, KV_AXES, cfg.dtype, device),
        v=shd.zeros(shape, KV_AXES, cfg.dtype, device), index=0)


def cache_specs(cfg, batch: int, seq: int, shd: Sharder) -> HybridCache:
    shape = (_n_groups(cfg), batch, seq, cfg.n_kv_heads, cfg.d_head)
    kv = shd.spec_tensor(shape, KV_AXES, cfg.dtype)
    return HybridCache(mamba=M.mamba_cache_specs(cfg, batch, shd), k=kv,
                       v=kv, index=torch.empty((), dtype=torch.int32,
                                               device="meta"))


@L.serving
def decode_step(params, cfg, shd, cache: HybridCache, tokens):
    x0 = L.embed_tokens(params["embed"], tokens, shd)[:, 0]     # (B,D)
    idx = int(cache.index)
    positions = idx + torch.arange(1, device=x0.device)
    x, new = x0, []
    for g in range(_n_groups(cfg)):
        x, c = M.decode_layers(params, cfg, shd, x, cache.mamba,
                               _group_layers(cfg, g))
        new.extend(c)
        xin = torch.einsum("bd,dk->bk", torch.cat([x, x0], dim=-1),
                           params["w_cat"]["w"][g])
        out, _ = _shared_block(params, cfg, shd, xin[:, None], positions,
                               kv_cache=(cache.k[g], cache.v[g]),
                               cache_index=idx)
        x = x + out[:, 0]
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    logits = torch.einsum("bd,dv->bv", x, params["lm_head"]["w"])[:, None]
    logits = shd.act(logits, ("batch", None, "act_vocab"))
    return logits, HybridCache(mamba=M.stack_cache(new), k=cache.k,
                               v=cache.v, index=idx + 1)


@L.serving
def prefill(params, cfg, shd, tokens, cache: HybridCache, embeds=None):
    """Process a full prompt → (cache, last-token logits)."""
    x0 = L.embed_tokens(params["embed"], tokens, shd)
    S = x0.shape[1]
    positions = torch.arange(S, device=x0.device)
    idx = int(cache.index)
    x, conv, ssm = x0, [], []
    for g in range(_n_groups(cfg)):
        for i in _group_layers(cfg, g):
            lp = M._layer(params, i)
            h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
            h, (conv_tail, s) = M.apply_mamba_train(lp["mamba"], cfg, h, shd,
                                                    return_state=True)
            x = x + h
            conv.append(conv_tail)
            ssm.append(s)
        xin = _mix_in(x, x0, params["w_cat"]["w"][g], shd)
        out, _ = _shared_block(params, cfg, shd, xin, positions,
                               kv_cache=(cache.k[g], cache.v[g]),
                               cache_index=idx)
        x = shd.act(x + out, ("batch", "res_seq", "act_embed"))
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    logits = torch.einsum("bd,dv->bv", x[:, -1],
                          params["lm_head"]["w"])[:, None]
    mc = cache.mamba
    new_cache = HybridCache(
        mamba=M.MambaCache(torch.stack(conv), torch.stack(ssm), mc.x_hat,
                           mc.m_acc),
        k=cache.k, v=cache.v, index=idx + S)
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
        init_cache=lambda batch, seq: init_cache(cfg, batch, seq, shd,
                                                 resolve(device)),
        cache_specs=lambda batch, seq: cache_specs(cfg, batch, seq, shd),
    )
