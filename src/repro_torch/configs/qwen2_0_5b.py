"""Qwen2-0.5B [arXiv:2407.10671]: 24L d896 14H(kv2) ff4864, QKV bias."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, vocab_pad_multiple=32)
