"""Input stand-ins for every (arch × shape) cell.

Port of ``repro/launch/inputs.py``: ``meta``-device tensors of the right
shapes and dtypes (no allocation) whose ``sharding`` attribute is their
placement on the Sharder's mesh (None without one), the counterpart of
the reference's ``ShapeDtypeStruct``s.  ``place_batch`` puts a host
batch on the mesh by the same logical axes.  Modality frontends are
stubs: vlm / audio cells receive precomputed patch / frame embeddings as
inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.parallel.sharding import Sharder, place

# Logical axes of every batch entry (tokens, labels, positions and
# embeds of the train, prefill and decode steps).
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "positions": ("batch", "seq"),
              "embeds": ("batch", "seq", "act_embed")}


def _tok(shd: Sharder, batch: int, seq: int):
    return shd.spec_tensor((batch, seq), BATCH_AXES["tokens"], torch.int32)


def _emb(shd: Sharder, batch: int, seq: int, d: int):
    return shd.spec_tensor((batch, seq, d), BATCH_AXES["embeds"],
                           torch.bfloat16)


def place_batch(batch: dict, shd: Sharder) -> dict:
    """A host batch (the same whole tensors on every rank) placed by
    ``BATCH_AXES``: tokens, labels, positions and embeds become DTensors
    on the mesh (the batch as it is without a mesh)."""
    return {k: place(v, shd.sharding(v.shape, BATCH_AXES[k]))
            for k, v in batch.items()}


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
