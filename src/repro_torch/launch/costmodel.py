"""Analytic FLOP / HBM-byte cost model per (arch × shape) cell.

Port of ``repro/launch/costmodel.py`` (pure numpy, equal to the
reference's for every config and shape).  It counts what the reference's
compiled graph executes, which the port's eager graph mirrors:

  * flash attention computes full (not causal-halved) masked S×T chunks;
  * MoE runs capacity-bucketed dispatch/combine einsums (cf = 1.25);
  * training remat (full layer recompute) → layer fwd FLOPs ×2;
  * backward = 2× forward;
  * the chunked-CE head materializes padded-vocab logits per chunk.

MODEL_FLOPS (the "useful FLOPs" yardstick) is the classic 6·N·D (train) /
2·N·D (decode) with N = active non-embedding params.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig

BF16 = 2
F32 = 4
MOE_CF = 1.25
KV_CHUNK = 1024


# ------------------------------------------------------------ param counts
def _attn_params(cfg, D=None):
    D = D or cfg.d_model
    return D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head \
        + cfg.n_heads * cfg.d_head * D


def _mlp_params(cfg, F=None, act=None):
    act = act or cfg.mlp_act
    F = F or cfg.d_ff
    mult = 3 if act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * F


def _moe_params(cfg, active_only=False):
    E = cfg.top_k if active_only else cfg.n_experts
    p = cfg.d_model * cfg.n_experts + E * 3 * cfg.d_model * cfg.moe_d_ff
    if cfg.n_shared_experts:
        p += 3 * cfg.d_model * cfg.n_shared_experts * cfg.moe_d_ff + cfg.d_model
    return p


def _mamba_params(cfg):
    d_in = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = d_in + 2 * G * N
    proj_dim = 2 * d_in + 2 * G * N + H
    return (cfg.d_model * proj_dim + cfg.conv_kernel * conv_dim + conv_dim
            + 3 * H + d_in + d_in * cfg.d_model)


def param_count(cfg: ArchConfig, active_only: bool = False,
                include_embed: bool = True) -> int:
    D = cfg.d_model
    emb = cfg.vocab_padded * D * 2 if include_embed else 0   # embed + head
    if cfg.family in ("dense", "vlm"):
        layer = _attn_params(cfg) + _mlp_params(cfg) + 2 * D
        return emb + cfg.num_layers * layer + D
    if cfg.family == "moe":
        layer = _attn_params(cfg) + _moe_params(cfg, active_only) + 2 * D
        return emb + cfg.num_layers * layer + D
    if cfg.family == "ssm":
        return emb + cfg.num_layers * (_mamba_params(cfg) + D) + D
    if cfg.family == "hybrid":
        ng = cfg.num_layers // cfg.shared_attn_every
        shared = _attn_params(cfg) + _mlp_params(cfg) + 2 * D
        wcat = ng * 2 * D * D
        return emb + cfg.num_layers * (_mamba_params(cfg) + D) + shared + wcat + D
    if cfg.family == "audio":
        enc = cfg.enc_layers * (_attn_params(cfg) + _mlp_params(cfg) + 2 * D)
        dec = cfg.dec_layers * (2 * _attn_params(cfg) + _mlp_params(cfg) + 3 * D)
        return emb + enc + dec + 2 * D
    if cfg.family == "kws":
        return (10 + cfg.d_model) * 3 * cfg.d_model + cfg.d_model * 12 + 12
    raise ValueError(cfg.family)


# ----------------------------------------------------------------- flops
@dataclasses.dataclass
class CellCost:
    model_flops: float        # useful FLOPs (6·N·D / 2·N·D convention)
    hlo_flops: float          # what the compiled graph executes
    hbm_bytes: float          # HBM traffic (whole step, all devices)
    tokens: float
    note: str = ""


def _attn_flops_fwd(cfg, B, S, T, flash: bool, causal: bool = True):
    """QK^T + AV for one layer.  flash=True → what the compiled flash
    executes: with static causal tile-skipping ≈ T/2 + half a KV chunk of
    diagonal padding; bidirectional → full T.  flash=False → causal half
    (model accounting)."""
    H, Dh = cfg.n_heads, cfg.d_head
    if flash:
        eff = (T / 2 + KV_CHUNK / 2) if causal else T
    else:
        eff = T / 2
    return 2 * 2 * B * S * eff * H * Dh


def _layer_fwd_flops(cfg, B, S, hlo: bool):
    """Matmul FLOPs of one scanned layer body, forward, whole batch."""
    tok = B * S
    D = cfg.d_model
    if cfg.family in ("dense", "vlm", "moe"):
        f = 2 * tok * _attn_params(cfg)
        f += _attn_flops_fwd(cfg, B, S, S, flash=hlo)
        if cfg.family == "moe":
            E, K, Fe = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
            Sg = min(S, 4096 if K <= 4 else 2048)    # dispatch group size
            C = max(4, min(int(np.ceil(K * Sg * MOE_CF / E)), Sg))
            if hlo:
                f += 2 * 2 * B * S * E * C * D          # dispatch + combine
                f += 2 * 3 * B * (S // Sg) * E * C * D * Fe   # expert FFN
            else:
                f += 2 * tok * K * 3 * D * Fe
            if cfg.n_shared_experts:
                f += 2 * tok * 3 * D * cfg.n_shared_experts * Fe
            f += 2 * tok * D * E                         # router
        else:
            f += 2 * tok * _mlp_params(cfg)
        return f
    if cfg.family == "ssm":
        return _mamba_fwd_flops(cfg, B, S, hlo)
    raise ValueError(cfg.family)


def _mamba_fwd_flops(cfg, B, S, hlo: bool):
    tok = B * S
    d_in = cfg.d_inner
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    f = 2 * tok * _mamba_params(cfg)
    if S > 1:
        c = min(256, S)                                  # SSD chunk
        # intra-chunk: CB^T (c×c×N) + (scores·L)·x (c×c×P) per head
        f += 2 * B * (S // c) * H * (c * c * N + c * c * P)
        # states + inter-chunk output: c×P×N einsums, twice
        f += 2 * B * (S // c) * H * (2 * c * P * N)
    else:
        f += 2 * B * H * (2 * P * N)                     # recurrent step
    return f


def _hybrid_fwd_flops(cfg, B, S, hlo: bool):
    ng = cfg.num_layers // cfg.shared_attn_every
    f = cfg.num_layers * _mamba_fwd_flops(cfg, B, S, hlo)
    tok = B * S
    shared = (2 * tok * (_attn_params(cfg) + _mlp_params(cfg) + 2 * cfg.d_model * cfg.d_model)
              + _attn_flops_fwd(cfg, B, S, S, flash=hlo))
    return f + ng * shared


def _encdec_fwd_flops(cfg, B, S_dec, S_enc, hlo: bool):
    f_enc = cfg.enc_layers * (
        2 * B * S_enc * (_attn_params(cfg) + _mlp_params(cfg))
        + _attn_flops_fwd(cfg, B, S_enc, S_enc, flash=hlo, causal=False))
    f_dec = cfg.dec_layers * (
        2 * B * S_dec * (2 * _attn_params(cfg) + _mlp_params(cfg))
        + _attn_flops_fwd(cfg, B, S_dec, S_dec, flash=hlo)
        + 2 * 2 * B * S_dec * S_enc * cfg.n_heads * cfg.d_head)  # cross
    return f_enc + f_dec


def _head_flops(cfg, B, S):
    return 2 * B * S * cfg.d_model * cfg.vocab_padded


def step_costs(cfg: ArchConfig, shape: ShapeConfig) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    n_active = param_count(cfg, active_only=True, include_embed=False)
    p_total = param_count(cfg)
    p_bytes = p_total * BF16

    if shape.kind == "train":
        tokens = B * S
        model = 6 * n_active * tokens
        if cfg.family == "hybrid":
            fwd_body = _hybrid_fwd_flops(cfg, B, S, hlo=True)
        elif cfg.family == "audio":
            fwd_body = _encdec_fwd_flops(cfg, B, S, cfg.frontend_tokens, hlo=True)
        elif cfg.family == "vlm":
            S_tot = S  # embeds + tokens jointly attend
            fwd_body = cfg.num_layers * _layer_fwd_flops(
                dataclasses.replace(cfg, family="dense"), B, S_tot, hlo=True)
        else:
            fwd_body = cfg.num_layers * _layer_fwd_flops(cfg, B, S, hlo=True)
        head = _head_flops(cfg, B, S)
        # remat: body fwd ×2 (fwd + recompute) + bwd 2× = 4×; head: 3×.
        # save_mlp policy: recompute skips the MLP GEMMs (§Perf).
        recompute = 1.0
        if cfg.remat_policy == "save_mlp" and cfg.family in ("dense", "vlm"):
            mlp_share = (2 * B * S * _mlp_params(cfg) * cfg.num_layers
                         ) / fwd_body
            recompute = 1.0 - mlp_share
        hlo = (3 + recompute) * fwd_body + 3 * head + 10 * p_total
        # HBM: weights stream 5× bf16; optimizer 28 B/param; activation
        # checkpoints 2×; flash-softmax carries; logits chunks.
        act_ckpt = cfg.num_layers * B * S * cfg.d_model * BF16 * 2
        flash_carry = 0.0
        if cfg.family in ("dense", "vlm", "moe", "audio", "hybrid") and S >= 4096:
            nlayers_attn = (cfg.num_layers if cfg.family != "hybrid"
                            else cfg.num_layers // cfg.shared_attn_every)
            nc = S // KV_CHUNK
            flash_carry = (nlayers_attn * 3 * nc * 2 *
                           B * cfg.n_heads * S * cfg.d_head * F32)
        hbm = 5 * p_bytes + 28 * p_total + act_ckpt + flash_carry \
            + 2 * B * S * cfg.vocab_padded * F32 / 8   # CE chunks (approx)
        return CellCost(model, hlo, hbm, tokens, "train")

    if shape.kind == "prefill":
        tokens = B * S
        model = 2 * n_active * tokens
        if cfg.family == "hybrid":
            fwd = _hybrid_fwd_flops(cfg, B, S, hlo=True)
        elif cfg.family == "audio":
            fwd = _encdec_fwd_flops(cfg, B, S, cfg.frontend_tokens, hlo=True)
        elif cfg.family == "vlm":
            fwd = cfg.num_layers * _layer_fwd_flops(
                dataclasses.replace(cfg, family="dense"), B, S, hlo=True)
        else:
            fwd = cfg.num_layers * _layer_fwd_flops(cfg, B, S, hlo=True)
        hlo = fwd + _head_flops(cfg, B, 1)
        kv_bytes = _cache_bytes(cfg, B, S)
        hbm = p_bytes + kv_bytes + cfg.num_layers * B * S * cfg.d_model * BF16 * 2
        return CellCost(model, hlo, hbm, tokens, "prefill")

    # ----- decode: one new token against a cache of S -----
    tokens = B
    model = 2 * n_active * tokens
    if cfg.family == "ssm":
        fwd = cfg.num_layers * _mamba_fwd_flops(cfg, B, 1, hlo=True)
    elif cfg.family == "hybrid":
        ng = cfg.num_layers // cfg.shared_attn_every
        fwd = cfg.num_layers * _mamba_fwd_flops(cfg, B, 1, hlo=True)
        fwd += ng * (2 * B * (_attn_params(cfg) + _mlp_params(cfg)
                              + 2 * cfg.d_model ** 2)
                     + 2 * 2 * B * S * cfg.n_heads * cfg.d_head)
    elif cfg.family == "audio":
        fwd = cfg.dec_layers * (
            2 * B * (2 * _attn_params(cfg) + _mlp_params(cfg))
            + 2 * 2 * B * S * cfg.n_heads * cfg.d_head
            + 2 * 2 * B * cfg.frontend_tokens * cfg.n_heads * cfg.d_head)
    else:
        kv_eff = _decode_kv_effective(cfg, S)
        fwd = cfg.num_layers * 2 * B * _attn_params(cfg)
        fwd += 2 * 2 * B * kv_eff * cfg.n_heads * cfg.d_head
        if cfg.family == "moe":
            E, K, Fe = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
            C = 4
            fwd += cfg.num_layers * (2 * 2 * B * E * C * cfg.d_model
                                     + 2 * 3 * B * E * C * cfg.d_model * Fe
                                     + (2 * 3 * B * cfg.d_model
                                        * cfg.n_shared_experts * Fe
                                        if cfg.n_shared_experts else 0))
        else:
            fwd += cfg.num_layers * 2 * B * _mlp_params(cfg)
    hlo = fwd + _head_flops(cfg, B, 1)
    cache_bytes = _cache_bytes(cfg, B, S)
    hbm = p_bytes + cache_bytes    # weights + full cache read per step
    return CellCost(model, hlo, hbm, tokens, "decode")


def _decode_kv_effective(cfg, S):
    """Sum over layers of attended KV length (window-aware), per head."""
    if cfg.window_size and cfg.global_every:
        nl = cfg.num_layers
        ng = nl // cfg.global_every
        return ng * S + (nl - ng) * min(cfg.window_size, S)
    if cfg.window_size:
        return cfg.num_layers * min(cfg.window_size, S)
    return cfg.num_layers * S


def _cache_bytes(cfg, B, S):
    if cfg.family == "ssm":
        H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        return cfg.num_layers * B * (H * P * N * F32
                                     + (cfg.conv_kernel - 1)
                                     * (cfg.d_inner + 2 * cfg.ssm_ngroups
                                        * cfg.ssm_state) * BF16)
    if cfg.family == "hybrid":
        ssm = _cache_bytes(dataclasses.replace(cfg, family="ssm"), B, S)
        ng = cfg.num_layers // cfg.shared_attn_every
        return ssm + ng * B * S * 2 * cfg.n_kv_heads * cfg.d_head * BF16
    if cfg.family == "audio":
        return (cfg.dec_layers * B * S * 2 * cfg.n_kv_heads * cfg.d_head * BF16
                + B * cfg.frontend_tokens * cfg.d_model * BF16)
    # dense/moe/vlm: per-layer (window-aware sizes are a §Perf optimization;
    # the baseline allocates full S per layer)
    return cfg.num_layers * B * S * 2 * cfg.n_kv_heads * cfg.d_head * BF16
