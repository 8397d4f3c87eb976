"""Mixture-of-Experts layer — GShard-style einsum dispatch/combine.

Port of ``repro/models/moe.py``: top-k routing with a fixed per-group
capacity; dispatch and combine are einsums over a (B, S, E, C) combine
tensor, so FLOPs scale with capacity (≈ top_k × tokens × capacity
factor), not with n_experts.  The router and its softmax are f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init, gather_fsdp, st_axes, stacked
from repro_torch.parallel.sharding import AxTree, Sharder


def init_moe(key, cfg, layers=None):
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    t = AxTree()
    t.add("router", _init(key, stacked((D, E), layers), torch.float32),
          st_axes(("embed", "expert"), layers))
    t.add("w_gate", _init(key, stacked((E, D, F_), layers), cfg.dtype),
          st_axes(("expert", "embed", "mlp"), layers))
    t.add("w_up", _init(key, stacked((E, D, F_), layers), cfg.dtype),
          st_axes(("expert", "embed", "mlp"), layers))
    t.add("w_down", _init(key, stacked((E, F_, D), layers), cfg.dtype,
                          scale=1.0 / np.sqrt(F_)),
          st_axes(("expert", "mlp", "embed"), layers))
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F_
        t.add("ws_gate", _init(key, stacked((D, Fs), layers), cfg.dtype),
              st_axes(("embed", "mlp"), layers))
        t.add("ws_up", _init(key, stacked((D, Fs), layers), cfg.dtype),
              st_axes(("embed", "mlp"), layers))
        t.add("ws_down", _init(key, stacked((Fs, D), layers), cfg.dtype,
                               scale=1.0 / np.sqrt(Fs)),
              st_axes(("mlp", "embed"), layers))
        t.add("ws_sgate", _init(key, stacked((D, 1), layers), cfg.dtype),
              st_axes(("embed", None), layers))
    return t.build()


def moe_group_size(top_k: int) -> int:
    """Dispatch-group token count.  The (Sg, E, C) combine tensor holds
    Sg²·k·cf elements per group, so higher top-k gets smaller groups."""
    return 4096 if top_k <= 4 else 2048


def route(p, cfg, x, capacity_factor: float = 1.25):
    """The routing decisions of one group-batch x (B, S, D): (probs
    (B,S,E), gate_vals (B,S,K) renormalised and zeroed where dropped,
    gate_idx (B,S,K), pos (B,S,K) slot in the expert's buffer, keep
    (B,S,K), capacity C)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = int(np.ceil(K * S * capacity_factor / E))
    C = max(4, min(C, S))
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)                        # (B,S,E)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)           # (B,S,K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    onehot = F.one_hot(gate_idx, E).to(torch.float32)            # (B,S,K,E)
    # Position of each (token, k) inside its expert's capacity buffer.
    flat = onehot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    pos = torch.sum(pos * onehot, dim=-1)                        # (B,S,K)
    keep = pos < C
    return probs, gate_vals * keep, gate_idx, onehot, pos, keep, C


def apply_moe(p, cfg, x, shd: Sharder, capacity_factor: float = 1.25):
    """x: (B, S, D) → (out, aux_loss).  Group = one sequence (or a bounded
    slice of one: capacity scales with group size, so a long sequence is
    re-grouped into ``moe_group_size`` groups)."""
    B, S, D = x.shape
    grp = moe_group_size(cfg.top_k)
    if S > grp and S % grp == 0:
        n = S // grp
        out, aux = apply_moe(p, cfg, x.reshape(B * n, grp, D), shd,
                             capacity_factor)
        return out.reshape(B, S, D), aux
    E = cfg.n_experts
    probs, gate_vals, gate_idx, onehot, pos, keep, C = route(
        p, cfg, x, capacity_factor)

    # Load-balancing auxiliary loss (Switch §2.2).
    me = torch.mean(probs, dim=(0, 1))                           # (E,)
    ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # combine[b,s,e,c]: weight of token (b,s) at slot c of expert e.  A
    # dropped (token, k) has pos ≥ C: its one-hot row is all zero.
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).to(x.dtype) * keep[..., None]
    comb = torch.einsum("bske,bskc->bsec", onehot.to(x.dtype),
                        pos_oh * gate_vals[..., None].to(x.dtype))
    comb = shd.act(comb, ("batch", "seq", "expert", None))
    disp = (comb > 0).to(x.dtype)

    # Dispatch → expert FFN (swiglu) → combine.  On a mesh the expert
    # weights' FSDP axes are gathered first (DTensor would otherwise set
    # the batch's and the weight's 'data' splits against each other).
    xe = torch.einsum("bsec,bsd->becd", disp, x)                 # (B,E,C,D)
    xe = shd.act(xe, ("batch", "expert", None, "act_embed"))
    h = F.silu(torch.einsum("becd,edf->becf", xe, gather_fsdp(p["w_gate"])))
    h = h * torch.einsum("becd,edf->becf", xe, gather_fsdp(p["w_up"]))
    h = shd.act(h, ("batch", "expert", None, "act_mlp"))
    ye = torch.einsum("becf,efd->becd", h, gather_fsdp(p["w_down"]))
    out = torch.einsum("bsec,becd->bsd", comb, ye)

    if cfg.n_shared_experts:
        hs = F.silu(torch.einsum("bsd,df->bsf", x, p["ws_gate"]))
        hs = hs * torch.einsum("bsd,df->bsf", x, p["ws_up"])
        ys = torch.einsum("bsf,fd->bsd", hs, p["ws_down"])
        sg = torch.sigmoid(torch.einsum("bsd,do->bso", x, p["ws_sgate"]))
        out = out + sg * ys

    return shd.act(out, ("batch", "res_seq", "act_embed")), aux
