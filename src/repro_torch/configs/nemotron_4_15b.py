"""Nemotron-4-15B [arXiv:2402.16819]: 32L d6144 48H(kv8) ff24576, squared-ReLU, LN."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=256000,
    mlp_act="relu2", norm_type="layernorm", rope_theta=1e4,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=256, vocab_pad_multiple=32)
