"""Gemma3-4B [hf:google/gemma-3 family]: 34L d2560 8H(kv4) ff10240, 5:1 local:global, 128k."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab_size=262144,
    window_size=1024, global_every=6,      # 5 local : 1 global
    mlp_act="geglu", rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, window_size=8, global_every=2,
    vocab_size=256, vocab_pad_multiple=32)
