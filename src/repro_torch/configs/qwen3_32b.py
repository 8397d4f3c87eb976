"""Qwen3-32B [hf:Qwen/Qwen3 family]: 64L d5120 64H(kv8) ff25600, qk-norm."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=256, vocab_pad_multiple=32)
