"""Core ΔGRU, fixed-point quantization and the IC energy model.

The package-level names of the reference's ``repro.core``."""
from repro_torch.core.delta_gru import (
    DeltaGRUCell,
    DeltaGRUParams,
    DeltaState,
    DeltaStats,
    delta_encode,
    delta_gru_scan,
    dense_gru_scan,
    init_delta_gru,
    init_delta_state,
    temporal_sparsity,
)
from repro_torch.core.delta_dense import (DeltaStream, delta_matmul,
                                          init_delta_stream)
from repro_torch.core.fixed_point import (
    FexFormats,
    GruFormats,
    IntGruWeights,
    IntKwsBundle,
    fold_fex,
    int_forward,
    int_fex_scan,
    int_gru_scan,
    promote_kws,
)
from repro_torch.core.energy_model import (CostReport, cost_from_sparsity,
                                           frame_cost)
from repro_torch.core.quantize import (QFormat, qformat_for,
                                       quantize_weights_8b, ste_quantize)
from repro_torch.core.sparsity import (SparsityAccumulator,
                                       sparsity_at_threshold)
