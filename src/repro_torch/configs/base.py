"""Architecture & shape configuration system.

Port of ``repro/configs/base.py``: every ``ArchConfig`` field, default
and property of the reference, with ``dtype`` a torch dtype (bfloat16 by
default).  ``n_params`` / ``n_params_active`` call the port's cost model.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio|kws
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    # --- attention features ---
    qk_norm: bool = False
    qkv_bias: bool = False
    window_size: int = 0             # 0 = full attention
    global_every: int = 0            # gemma3: 1 global per N layers
    norm_type: str = "rmsnorm"
    mlp_act: str = "swiglu"
    rope_theta: float = 1e4
    logit_softcap: float = 0.0
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_kernel: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # shared attention block every N layers
    # --- enc-dec (seamless) ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"           # none|vit_stub|audio_stub|iir_fex
    frontend_tokens: int = 0         # positions supplied as embeddings
    # --- paper technique ---
    use_delta: bool = False
    delta_threshold: float = 0.0
    gru_backend: str = "xla"         # xla | pallas (the reference's names)
    # --- performance knobs ---
    remat_policy: str = "full"       # full | save_mlp (selective remat)
    # --- numerics ---
    dtype: Any = torch.bfloat16
    vocab_pad_multiple: int = 2048   # lcm(128, 16) with headroom

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Total parameter count (analytic, matches init)."""
        from repro_torch.launch import costmodel
        return costmodel.param_count(self)

    def n_params_active(self) -> int:
        from repro_torch.launch import costmodel
        return costmodel.param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train|prefill|decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Pure full-attention stacks skip long_500k (sub-quadratic required).
LONG_CONTEXT_ARCHS = {"mamba2-370m", "zamba2-2.7b", "gemma3-4b"}

ARCH_IDS = [
    "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "internvl2-2b", "mamba2-370m",
    "nemotron-4-15b", "qwen3-32b", "qwen2-0.5b", "gemma3-4b", "zamba2-2.7b",
    "seamless-m4t-large-v2",
]

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "internvl2-2b": "internvl2_2b",
    "mamba2-370m": "mamba2_370m",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "deltakws": "deltakws",
}


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE_CONFIG


def cells(include_skipped: bool = False):
    """All (arch_id, shape_name) cells honoring the skip policy."""
    out = []
    for arch in ARCH_IDS:
        for shape in LM_SHAPES:
            skip = (shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS)
            if include_skipped or not skip:
                out.append((arch, shape, skip))
    return out
