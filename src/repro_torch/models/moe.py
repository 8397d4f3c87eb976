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


def route(p, cfg, x, capacity_factor: float = 1.25,
          shd: Sharder | None = None):
    """The routing decisions of one group-batch x (B, S, D): (probs
    (B,S,E), gate_vals (B,S,K) renormalised and zeroed where dropped,
    gate_idx (B,S,K), pos (B,S,K) slot in the expert's buffer, keep
    (B,S,K), capacity C).  On a mesh (``shd``) the router logits are
    placed by their batch, and so is their gradient, which the softmax
    and top-k would otherwise hand back split on the sequence (a split
    the product's backward flattens into a strided one)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = int(np.ceil(K * S * capacity_factor / E))
    C = max(4, min(C, S))
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), p["router"])
    if shd is not None:
        logits = shd.act(logits, ("batch", "seq", None))
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
    # On a mesh the sequence is gathered whole (a batch- and sequence-split
    # x would flatten into one strided split in the router's product).
    x = shd.act(x, ("batch", "seq", "act_embed"))
    grp = moe_group_size(cfg.top_k)
    if S > grp and S % grp == 0:
        n = S // grp
        out, aux = apply_moe(p, cfg, x.reshape(B * n, grp, D), shd,
                             capacity_factor)
        # The groups merge back into whole sequences: a sequence split
        # cannot be flattened with the group dim (torch 2.11 refuses it).
        out = shd.act(out, ("batch", "seq", "act_embed"))
        return shd.act(out.reshape(B, S, D),
                       ("batch", "res_seq", "act_embed")), aux
    E = cfg.n_experts
    probs, gate_vals, gate_idx, onehot, pos, keep, C = route(
        p, cfg, x, capacity_factor, shd)

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
    # The expert outputs are reduced onto the experts' own split (DTensor
    # would otherwise scatter the partial sum unevenly over the experts,
    # which the combine cannot flatten), and the products that feed the
    # output are placed by the batch, and so are their gradients: the
    # output's sequence split would otherwise reach them and be flattened
    # into a strided split in their backward.
    ye = shd.act(ye, ("batch", "expert", None, "act_embed"))
    tok = ("batch", "seq", "act_embed")
    out = shd.act(torch.einsum("bsec,becd->bsd", comb, ye), tok)

    if cfg.n_shared_experts:
        hs = F.silu(torch.einsum("bsd,df->bsf", x, p["ws_gate"]))
        hs = hs * torch.einsum("bsd,df->bsf", x, p["ws_up"])
        ys = shd.act(torch.einsum("bsf,fd->bsd", hs, p["ws_down"]), tok)
        sg = torch.sigmoid(shd.act(torch.einsum(
            "bsd,do->bso", x, p["ws_sgate"]), ("batch", "seq", None)))
        out = out + sg * ys

    return shd.act(out, ("batch", "res_seq", "act_embed")), aux
