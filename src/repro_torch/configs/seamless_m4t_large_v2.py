"""SeamlessM4T-large-v2 [arXiv:2308.11596]: enc-dec, d1024 16H(kv16) ff8192, audio stub.
The assigned 24L is split 12 encoder + 12 decoder (see DESIGN.md)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206,
    enc_layers=12, dec_layers=12,
    frontend="audio_stub", frontend_tokens=4096,   # precomputed frame embeds
    norm_type="layernorm", mlp_act="gelu",
    use_delta=True, delta_threshold=0.0,           # Δ-encoded frame features
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, frontend_tokens=16,
    vocab_size=256, vocab_pad_multiple=32)
