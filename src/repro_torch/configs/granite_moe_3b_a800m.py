"""Granite-3.0 MoE 3b-a800m [hf:ibm-granite]: 32L d1536 24H(kv8) MoE 40e top-8, d_ff/expert=512."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, n_shared_experts=0, moe_d_ff=512,
    rope_theta=1e4,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, moe_d_ff=64, n_experts=8, top_k=2,
    vocab_size=256, vocab_pad_multiple=32)
