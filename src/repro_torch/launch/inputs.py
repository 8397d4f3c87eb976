"""Input stand-ins for every (arch × shape) cell.

Port of ``repro/launch/inputs.py``: ``meta``-device tensors of the right
shapes and dtypes (no allocation), the counterpart of the reference's
``ShapeDtypeStruct``s.  Modality frontends are stubs: vlm / audio cells
receive precomputed patch / frame embeddings as inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.parallel.sharding import Sharder


def _tok(shd: Sharder, batch: int, seq: int):
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def _emb(shd: Sharder, batch: int, seq: int, d: int):
    return torch.empty((batch, seq, d), dtype=torch.bfloat16, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder
                      ) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vit_stub":
        s_txt = S - cfg.frontend_tokens
        return {"tokens": _tok(shd, B, s_txt), "labels": _tok(shd, B, s_txt),
                "embeds": _emb(shd, B, cfg.frontend_tokens, cfg.d_model)}
    if cfg.frontend == "audio_stub":
        # encoder consumes frame embeddings; decoder trains on S tokens
        return {"tokens": _tok(shd, B, S), "labels": _tok(shd, B, S),
                "embeds": _emb(shd, B, cfg.frontend_tokens, cfg.d_model)}
    return {"tokens": _tok(shd, B, S), "labels": _tok(shd, B, S)}


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if cfg.frontend == "vit_stub":
        out["tokens"] = _tok(shd, B, S - cfg.frontend_tokens)
        out["embeds"] = _emb(shd, B, cfg.frontend_tokens, cfg.d_model)
    elif cfg.frontend == "audio_stub":
        out["tokens"] = _tok(shd, B, S)
        out["embeds"] = _emb(shd, B, cfg.frontend_tokens, cfg.d_model)
    else:
        out["tokens"] = _tok(shd, B, S)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, shd: Sharder) -> dict:
    B = shape.global_batch
    return {"tokens": _tok(shd, B, 1)}
