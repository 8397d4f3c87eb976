"""Mamba2-370m [arXiv:2405.21060]: 48L d1024, SSD state 128, attn-free."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, conv_kernel=4,
    use_delta=True, delta_threshold=0.0,   # Δ-gated decode (paper technique)
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
    vocab_size=256, vocab_pad_multiple=32)
