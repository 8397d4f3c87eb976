"""FEx front end: IIR filter-bank design, the streaming feature extractor
and the energy VAD gate (the package-level names of the reference's
``repro.frontend``)."""
from repro_torch.frontend.fex import (FExConfig, FExState, FeatureExtractor,
                                      build_sos_bank, fex_scan,
                                      init_fex_state, quantize_sos)
from repro_torch.frontend.vad import (VAD_OFF, VADConfig, VADState,
                                      frame_energy, init_vad_state, vad_gate)
from repro_torch.frontend.filters import (
    design_butter_bandpass_sos,
    make_filterbank,
    mel_center_frequencies,
    sos_freq_response,
    sosfilt_np,
)
