"""Signal processing, the FIR half: counterpart of ``njw_tpu.signal``.

Windows, FIR design, ``fir_apply`` (whose causal batch branch launches the
banded-product tensor-core kernel ``ops/csrc/fir_band.cu``), ``FIRFilter``,
``MultirateFilter``, ``StreamingFIR``, and the four batch-FIR entry points
of ``fir_cuda`` (the counterparts of ``njw_tpu/signal/fir_pallas.py``).
IIR, adaptive and median filters, spectral analysis and time-frequency
analysis are not ported yet.
"""
from njw_tpu_torch.signal.filters import (
    FIRFilter, MultirateFilter, StreamingFIR, design_fir_bandpass,
    design_fir_equiripple, design_fir_highpass, design_fir_least_squares,
    design_fir_lowpass, fir_apply,
)
from njw_tpu_torch.signal.fir_cuda import (
    fir_batch, fir_batch_bf16, fir_batch_flat, fir_batch_lanes,
)
from njw_tpu_torch.signal.windows import WINDOWS, get_window

__all__ = [
    "FIRFilter", "MultirateFilter", "StreamingFIR", "WINDOWS",
    "design_fir_bandpass", "design_fir_equiripple", "design_fir_highpass",
    "design_fir_least_squares", "design_fir_lowpass", "fir_apply",
    "fir_batch", "fir_batch_bf16", "fir_batch_flat", "fir_batch_lanes",
    "get_window",
]
