"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba2 layers d2560 (state 64) + shared attention
block (32H kv32 d_head 80, ff 10240) applied every 6 layers."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, conv_kernel=4,
    shared_attn_every=6,
    use_delta=True, delta_threshold=0.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, ssm_state=16, ssm_headdim=16, shared_attn_every=2,
    vocab_size=256, vocab_pad_multiple=32)
