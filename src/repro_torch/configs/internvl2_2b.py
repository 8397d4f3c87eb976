"""InternVL2-2B [arXiv:2404.16821]: InternViT stub + InternLM2 24L d2048 16H(kv8) ff8192."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92553,
    frontend="vit_stub", frontend_tokens=1024,   # patch embeddings (stub)
    rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, vocab_pad_multiple=32, frontend_tokens=8)
