"""Seamless-M4T-style encoder-decoder (speech → text) [arXiv:2308.11596].

Port of ``repro/models/encdec.py``.  The modality frontend is a stub:
callers supply precomputed speech-frame embeddings (B, S_enc, D).  With
``cfg.use_delta`` and a positive threshold, the frame embeddings are
Δ-encoded along time before the encoder (unchanged frames contribute no
update, as in the ΔRNN input layer).

Encoder: bidirectional self-attn + MLP.  Decoder: causal self-attn +
cross-attn over the encoder memory + MLP.  The decode cache holds the
self-attention KV per decoder layer (written in place) and the encoder
memory, from which each step projects the cross-attention k/v, as the
reference does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.parallel.sharding import AxTree, Sharder


def init_lm(key, cfg):
    dev = L._device(key)
    el, dl, D = cfg.enc_layers, cfg.dec_layers, cfg.d_model
    t = AxTree()
    t.sub("embed", L.init_embedding(key, cfg.vocab_padded, D, cfg.dtype))
    # encoder stack
    t.sub("enc_attn", L.init_attention(key, cfg, layers=el))
    t.sub("enc_mlp", L.init_mlp(key, cfg, layers=el))
    t.sub("enc_n1", L.init_norm(D, layers=el, bias=True, device=dev))
    t.sub("enc_n2", L.init_norm(D, layers=el, bias=True, device=dev))
    # decoder stack
    t.sub("dec_attn", L.init_attention(key, cfg, layers=dl))
    t.sub("dec_xattn", L.init_attention(key, cfg, layers=dl))
    t.sub("dec_mlp", L.init_mlp(key, cfg, layers=dl))
    t.sub("dec_n1", L.init_norm(D, layers=dl, bias=True, device=dev))
    t.sub("dec_n2", L.init_norm(D, layers=dl, bias=True, device=dev))
    t.sub("dec_n3", L.init_norm(D, layers=dl, bias=True, device=dev))
    t.sub("enc_nf", L.init_norm(D, bias=True, device=dev))
    t.sub("dec_nf", L.init_norm(D, bias=True, device=dev))
    head = AxTree()
    head.add("w", L._init(key, (D, cfg.vocab_padded), cfg.dtype),
             ("embed", "vocab"))
    t.sub("lm_head", head)
    return t.build()


def delta_encode_frames(embeds, threshold: float):
    """Δ-encode frame embeddings along time: each frame becomes the last
    transmitted value, channel by channel, where it moved by more than
    ``threshold``."""
    if threshold <= 0:
        return embeds
    x_hat = torch.zeros_like(embeds[:, 0])
    out = []
    for t in range(embeds.shape[1]):
        x = embeds[:, t]
        x_hat = torch.where(torch.abs(x - x_hat) > threshold, x, x_hat)
        out.append(x_hat)
    return torch.stack(out, dim=1)


def _enc_block(cfg, shd, positions, x, lp):
    h = L.apply_norm(lp["n1"], x, cfg.norm_type)
    h, _ = L.apply_attention(lp["attn"], cfg, h, shd, positions=positions,
                             causal=False)
    x = x + h
    h = L.apply_norm(lp["n2"], x, cfg.norm_type)
    h = L.apply_mlp(lp["mlp"], cfg, h, shd)
    return shd.act(x + h, ("batch", "res_seq", "act_embed"))


def encode(params, cfg, shd: Sharder, embeds, remat=True):
    x = embeds.to(cfg.dtype)
    if cfg.use_delta and cfg.delta_threshold > 0:
        x = delta_encode_frames(x, cfg.delta_threshold)
    x = shd.act(x, ("batch", "res_seq", "act_embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    body = functools.partial(_enc_block, cfg, shd, positions)
    for i in range(cfg.enc_layers):
        lp = {"attn": L.layer_slice(params["enc_attn"], i),
              "mlp": L.layer_slice(params["enc_mlp"], i),
              "n1": L.layer_slice(params["enc_n1"], i),
              "n2": L.layer_slice(params["enc_n2"], i)}
        x = L.remat(body, x, lp) if remat else body(x, lp)
    return L.apply_norm(params["enc_nf"], x, cfg.norm_type)


def _cross_kv(p_xattn, cfg, memory, shd: Sharder):
    k = L.project_heads(memory, p_xattn["wk"], shd, "kv_heads")
    v = L.project_heads(memory, p_xattn["wv"], shd, "kv_heads")
    if cfg.qkv_bias:
        k = k + p_xattn["bk"]
        v = v + p_xattn["bv"]
    return k, v


def _dec_block(cfg, shd, positions, memory, cache_index, x, lp,
               kv_cache=None):
    h = L.apply_norm(lp["n1"], x, cfg.norm_type)
    h, new_kv = L.apply_attention(lp["attn"], cfg, h, shd,
                                  positions=positions, kv_cache=kv_cache,
                                  cache_index=cache_index)
    x = x + h
    h = L.apply_norm(lp["n2"], x, cfg.norm_type)
    ckv = _cross_kv(lp["xattn"], cfg, memory, shd)
    h, _ = L.apply_attention(lp["xattn"], cfg, h, shd, positions=positions,
                             cross_kv=ckv)
    x = x + h
    h = L.apply_norm(lp["n3"], x, cfg.norm_type)
    h = L.apply_mlp(lp["mlp"], cfg, h, shd)
    return shd.act(x + h, ("batch", "res_seq", "act_embed"))


def decode_stack(params, cfg, shd, x, memory, positions, remat=True,
                 self_cache=None, cache_index=None):
    """Decoder layers.  self_cache: (k, v) stacked (L,B,S,K,Dh), written in
    place, or None."""
    for i in range(cfg.dec_layers):
        lp = {name: L.layer_slice(params[f"dec_{name}"], i)
              for name in ("attn", "xattn", "mlp", "n1", "n2", "n3")}
        if self_cache is not None:
            x = _dec_block(cfg, shd, positions, memory, cache_index, x, lp,
                           kv_cache=(self_cache[0][i], self_cache[1][i]))
        elif remat:
            x = L.remat(functools.partial(_dec_block, cfg, shd, positions,
                                          memory, cache_index), x, lp)
        else:
            x = _dec_block(cfg, shd, positions, memory, cache_index, x, lp)
    return L.apply_norm(params["dec_nf"], x, cfg.norm_type), self_cache


def loss_fn(params, cfg, shd, batch):
    """batch: embeds (B,S_enc,D) speech frames, tokens/labels (B,S_dec)."""
    memory = encode(params, cfg, shd, batch["embeds"])
    x = L.embed_tokens(params["embed"], batch["tokens"], shd)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = decode_stack(params, cfg, shd, x, memory, positions)
    ce = L.chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                shd, vocab_size=cfg.vocab_size)
    return ce, {"ce": ce}


# ------------------------------------------------------------------ decode
class EncDecCache(NamedTuple):
    k: torch.Tensor       # (L_dec, B, S_max, K, Dh) decoder self-attention
    v: torch.Tensor
    memory: torch.Tensor  # (B, S_enc, D) encoder output
    index: int


def _shapes(cfg, batch, seq):
    return ((cfg.dec_layers, batch, seq, cfg.n_kv_heads, cfg.d_head),
            (batch, cfg.frontend_tokens, cfg.d_model))


KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
MEMORY_AXES = ("batch", None, None)


def init_cache(cfg, batch: int, seq: int, shd: Sharder, device="cpu"
               ) -> EncDecCache:
    kv, mem = _shapes(cfg, batch, seq)
    return EncDecCache(k=shd.zeros(kv, KV_AXES, cfg.dtype, device),
                       v=shd.zeros(kv, KV_AXES, cfg.dtype, device),
                       memory=shd.zeros(mem, MEMORY_AXES, cfg.dtype, device),
                       index=0)


def cache_specs(cfg, batch: int, seq: int, shd: Sharder) -> EncDecCache:
    kv, mem = _shapes(cfg, batch, seq)
    return EncDecCache(k=shd.spec_tensor(kv, KV_AXES, cfg.dtype),
                       v=shd.spec_tensor(kv, KV_AXES, cfg.dtype),
                       memory=shd.spec_tensor(mem, MEMORY_AXES, cfg.dtype),
                       index=torch.empty((), dtype=torch.int32,
                                         device="meta"))


@L.serving
def prefill(params, cfg, shd, tokens, cache: EncDecCache, embeds=None):
    """Encoder pass over frames + decoder prefill over prompt tokens."""
    memory = (encode(params, cfg, shd, embeds, remat=False)
              if embeds is not None else cache.memory)
    x = L.embed_tokens(params["embed"], tokens, shd)
    idx = int(cache.index)
    positions = idx + torch.arange(x.shape[1], device=x.device)
    x, _ = decode_stack(params, cfg, shd, x, memory, positions, remat=False,
                        self_cache=(cache.k, cache.v), cache_index=idx)
    logits = torch.einsum("bd,dv->bv", x[:, -1],
                          params["lm_head"]["w"])[:, None]
    new_cache = EncDecCache(k=cache.k, v=cache.v, memory=memory,
                            index=idx + x.shape[1])
    return new_cache, shd.act(logits, ("batch", None, "act_vocab"))


@L.serving
def decode_step(params, cfg, shd, cache: EncDecCache, tokens):
    x = L.embed_tokens(params["embed"], tokens, shd)
    idx = int(cache.index)
    positions = idx + torch.arange(1, device=x.device)
    x, _ = decode_stack(params, cfg, shd, x, cache.memory, positions,
                        remat=False, self_cache=(cache.k, cache.v),
                        cache_index=idx)
    logits = torch.einsum("bsd,dv->bsv", x[:, -1:], params["lm_head"]["w"])
    new_cache = EncDecCache(k=cache.k, v=cache.v, memory=cache.memory,
                            index=idx + 1)
    return shd.act(logits, ("batch", None, "act_vocab")), new_cache


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
