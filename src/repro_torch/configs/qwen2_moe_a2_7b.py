"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H(kv16) MoE 60e top-4 + 4 shared."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=151936,
    n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=96, moe_d_ff=96, n_experts=8, top_k=2, n_shared_experts=1,
    vocab_size=256, vocab_pad_multiple=32)
