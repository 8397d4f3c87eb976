"""Architecture configs — one per architecture + the paper's own."""
from repro_torch.configs.base import (
    ARCH_IDS,
    LM_SHAPES,
    LONG_CONTEXT_ARCHS,
    ArchConfig,
    ShapeConfig,
    cells,
    get_config,
    get_smoke_config,
)
