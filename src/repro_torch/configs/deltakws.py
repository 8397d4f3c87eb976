"""The paper's own model: FEx(10ch) -> ΔGRU(64) -> FC(12). GSCD 11/12-class."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deltakws", family="kws",
    num_layers=1, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=12,
    use_delta=True, delta_threshold=0.2,   # the paper's design point
    frontend="iir_fex", frontend_tokens=10,
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, d_model=16)
