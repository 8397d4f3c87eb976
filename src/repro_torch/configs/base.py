"""Architecture configuration: the ``ArchConfig`` fields the KWS serving
path reads (a subset of ``repro/configs/base.py``'s ``ArchConfig``, with
the same names and meanings)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # kws (the LM families come later)
    d_model: int                     # ΔGRU hidden size
    vocab_size: int                  # FC head width (classes)
    delta_threshold: float = 0.0     # Δ_TH design point
    frontend: str = "none"           # iir_fex for the KWS model
    frontend_tokens: int = 0         # FEx channels per frame
