"""Decoder-only transformer LM (dense / MoE / VLM).

Port of ``repro/models/transformer.py``.  Uniform model API (shared by
all families, see ``get_api`` in registry.py):

  init(key)                                -> (params, logical_axes)
  loss(params, batch)                      -> (loss, metrics)
  prefill(params, tokens, cache[, embeds]) -> (cache, last_logits)
  decode_step(params, cache, tokens)       -> (logits, cache)
  init_cache(batch, seq)                   -> cache
  cache_specs(batch, seq)                  -> cache of ``meta`` tensors

Per-layer weights are stacked (leading L dim, as in the reference, so
weights carry across 1:1); the reference's ``lax.scan`` over layers is a
loop over that dim.  For training each layer is recomputed in backward
(``torch.utils.checkpoint``); ``remat_policy="save_mlp"`` keeps the two
MLP up/gate products instead of recomputing them.  MoE layers add their
load-balance loss.  Prefill and decode run under
``torch.inference_mode()`` (``torch.no_grad()`` on a mesh) and write
the KV cache's buffers in place (the reference donates them); the cache
``index`` is a Python int.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.parallel.sharding import AxTree, Sharder

# ------------------------------------------------------------------- init
def init_lm(key, cfg) -> tuple[dict, dict]:
    nl = cfg.num_layers
    dev = L._device(key)
    ln = cfg.norm_type == "layernorm"
    t = AxTree()
    t.sub("embed", L.init_embedding(key, cfg.vocab_padded, cfg.d_model,
                                    cfg.dtype))
    t.sub("attn", L.init_attention(key, cfg, layers=nl))
    t.sub("norm1", L.init_norm(cfg.d_model, layers=nl, bias=ln, device=dev))
    t.sub("norm2", L.init_norm(cfg.d_model, layers=nl, bias=ln, device=dev))
    if cfg.family == "moe":
        t.sub("moe", moe_lib.init_moe(key, cfg, layers=nl))
    else:
        t.sub("mlp", L.init_mlp(key, cfg, layers=nl))
    t.sub("norm_f", L.init_norm(cfg.d_model, bias=ln, device=dev))
    head = AxTree()
    head.add("w", L._init(key, (cfg.d_model, cfg.vocab_padded), cfg.dtype),
             ("embed", "vocab"))
    t.sub("lm_head", head)
    return t.build()


def layer_windows(cfg) -> np.ndarray | None:
    """Per-layer attention window (int32); None = all-full-attention."""
    if cfg.window_size <= 0:
        return None
    nl = cfg.num_layers
    w = np.full((nl,), cfg.window_size, np.int32)
    if cfg.global_every > 0:
        is_global = (np.arange(nl) % cfg.global_every) == (cfg.global_every - 1)
        w[is_global] = L.BIG_WINDOW
    return w


def _windows(cfg) -> list[int]:
    """The per-layer window each layer runs with: BIG_WINDOW for a full
    attention layer (the reference scans it as a traced window, so even a
    full layer takes the masked path)."""
    w = layer_windows(cfg)
    return ([int(v) for v in w] if w is not None
            else [L.BIG_WINDOW] * cfg.num_layers)


def _layer_params(params, cfg, i: int):
    """Layer ``i`` of the stacked per-layer subtree."""
    keys = ["attn", "norm1", "norm2"] + (["moe"] if cfg.family == "moe"
                                         else ["mlp"])
    return {k: L.layer_slice(params[k], i) for k in keys}


# ---------------------------------------------------------------- forward
def _block(cfg, shd, positions, win, x, aux, lp):
    h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
    h, _ = L.apply_attention(lp["attn"], cfg, h, shd, positions=positions,
                             window=win)
    x = x + h
    h = L.apply_norm(lp["norm2"], x, cfg.norm_type)
    if cfg.family == "moe":
        h, a = moe_lib.apply_moe(lp["moe"], cfg, h, shd)
        aux = aux + a
    else:
        h = L.apply_mlp(lp["mlp"], cfg, h, shd)
    x = x + h
    x = shd.act(x, ("batch", "res_seq", "act_embed"))
    return x, aux


def forward(params, cfg, shd: Sharder, tokens, embeds=None,
            remat: bool = True):
    """Causal forward pass → (hidden (B,S,D), moe_aux_loss)."""
    x = L.embed_tokens(params["embed"], tokens, shd)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        x = shd.act(x, ("batch", "res_seq", "act_embed"))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    context_fn = (functools.partial(L.save_names_context, "mlp_up",
                                    "mlp_gate")
                  if cfg.remat_policy == "save_mlp" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, win in enumerate(_windows(cfg)):
        body = functools.partial(_block, cfg, shd, positions, win)
        lp = _layer_params(params, cfg, i)
        if remat:
            x, aux = L.remat(body, x, aux, lp, context_fn=context_fn)
        else:
            x, aux = body(x, aux, lp)
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    return x, aux


def loss_fn(params, cfg, shd: Sharder, batch: dict):
    """batch: tokens (B,S_t), labels (B,S_t), optional embeds (B,S_p,D)."""
    embeds = batch.get("embeds")
    x, aux = forward(params, cfg, shd, batch["tokens"], embeds)
    if embeds is not None:
        x = x[:, embeds.shape[1]:]                # loss on the token region
    ce = L.chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                shd, vocab_size=cfg.vocab_size)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "moe_aux": aux}


# ----------------------------------------------------------------- decode
def _kv_shape(cfg, nl, batch, seq):
    return (nl, batch, seq, cfg.n_kv_heads, cfg.d_head)


KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def init_cache(cfg, batch: int, seq: int, shd: Sharder, device) -> dict:
    """Zero KV cache; on a mesh each buffer is placed per ``KV_AXES``."""
    shape = _kv_shape(cfg, cfg.num_layers, batch, seq)
    return {"k": shd.zeros(shape, KV_AXES, cfg.dtype, device),
            "v": shd.zeros(shape, KV_AXES, cfg.dtype, device),
            "index": 0}


def cache_specs(cfg, batch: int, seq: int, shd: Sharder) -> dict:
    shape = _kv_shape(cfg, cfg.num_layers, batch, seq)
    kv = shd.spec_tensor(shape, KV_AXES, cfg.dtype)
    return {"k": kv, "v": kv,
            "index": torch.empty((), dtype=torch.int32, device="meta")}


def lm_logits(x, head):
    """(B, S, D) hidden → (B, S, V_padded) logits."""
    return torch.einsum("bsd,dv->bsv", x, head)


@L.serving
def _decode_forward(params, cfg, shd, tokens, cache: dict, embeds=None):
    """Shared by prefill (S>1, index=0) and decode (S=1, index=pos)."""
    x = L.embed_tokens(params["embed"], tokens, shd)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    idx = int(cache["index"])
    positions = idx + torch.arange(S, device=x.device)
    ck_all, cv_all = cache["k"], cache["v"]
    for i, win in enumerate(_windows(cfg)):
        lp = _layer_params(params, cfg, i)
        h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
        h, _ = L.apply_attention(
            lp["attn"], cfg, h, shd, positions=positions, window=win,
            kv_cache=(ck_all[i], cv_all[i]), cache_index=idx)
        x = x + h
        h = L.apply_norm(lp["norm2"], x, cfg.norm_type)
        if cfg.family == "moe":
            h, _ = moe_lib.apply_moe(lp["moe"], cfg, h, shd)
        else:
            h = L.apply_mlp(lp["mlp"], cfg, h, shd)
        x = x + h
    x = L.apply_norm(params["norm_f"], x, cfg.norm_type)
    logits = lm_logits(x[:, -1:], params["lm_head"]["w"])
    logits = shd.act(logits, ("batch", None, "act_vocab"))
    return logits, {"k": ck_all, "v": cv_all, "index": idx + S}


def prefill(params, cfg, shd, tokens, cache: dict, embeds=None):
    logits, cache = _decode_forward(params, cfg, shd, tokens, cache, embeds)
    return cache, logits


def decode_step(params, cfg, shd, cache: dict, tokens):
    """tokens (B,1) → (logits (B,1,V), updated cache)."""
    return _decode_forward(params, cfg, shd, tokens, cache)


class LMApi(NamedTuple):
    init: Any
    loss: Any
    prefill: Any
    decode_step: Any
    init_cache: Any
    cache_specs: Any


def resolve(device):
    """The device an API's caches live on (``None`` → CUDA, raising
    without a GPU)."""
    from repro_torch.kernels.platform import resolve_device
    return resolve_device(device)


def make_api(cfg, shd: Sharder, device=None) -> LMApi:
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
