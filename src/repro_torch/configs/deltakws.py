"""The paper's own model: FEx(10ch) -> ΔGRU(64) -> FC(12). GSCD 11/12-class."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deltakws", family="kws", d_model=64, vocab_size=12,
    delta_threshold=0.2,                   # the paper's design point
    frontend="iir_fex", frontend_tokens=10,
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, d_model=16)
