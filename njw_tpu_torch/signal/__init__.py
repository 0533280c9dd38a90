"""Signal processing: counterpart of ``njw_tpu.signal``.

Windows; FIR design and ``fir_apply`` (whose causal batch branch launches
the banded-product tensor-core kernel ``ops/csrc/fir_band.cu``),
``FIRFilter``, ``MultirateFilter``, ``StreamingFIR`` and the four
batch-FIR entry points of ``fir_cuda`` (the counterparts of
``njw_tpu/signal/fir_pallas.py``); IIR design (Butterworth, Chebyshev I
and II, Bessel, elliptic) and application (``sos_apply``, ``IIRFilter``,
``StreamingIIR``), ``median_filter`` and ``AdaptiveFilter`` (LMS, NLMS,
block LMS, RLS); spectral analysis (``spectral``) and time-frequency
analysis (``tf``: STFT, CWT, DWT, WPT, MODWT, Wigner-Ville, EMD, mel,
MFCC). Only the FIR batch branch runs a kernel of the port: the JAX
package has Pallas kernels for that branch alone, and the rest runs on
PyTorch's own operations (cuFFT, cuBLAS in float32, elementwise).
"""
from njw_tpu_torch.signal.filters import (
    AdaptiveFilter, FIRFilter, IIRFilter, MultirateFilter, StreamingFIR,
    StreamingIIR, butterworth, chebyshev1, design_fir_bandpass,
    design_fir_equiripple, design_fir_highpass, design_fir_least_squares,
    design_fir_lowpass, fir_apply, median_filter, sos_apply,
)
from njw_tpu_torch.signal.fir_cuda import (
    fir_batch, fir_batch_bf16, fir_batch_flat, fir_batch_lanes,
)
from njw_tpu_torch.signal.spectral import (
    FFT, SpectralAnalyzer, cepstrum, compute_coherence, compute_psd,
    compute_spectrogram, detect_harmonics, detect_peaks, pitch_detect,
)
from njw_tpu_torch.signal.tf import (
    CWT, DWT, EMD, MODWT, STFT, WPT, WignerVille, mel_spectrogram, mfcc,
)
from njw_tpu_torch.signal.windows import WINDOWS, get_window

__all__ = [
    "AdaptiveFilter", "CWT", "DWT", "EMD", "FFT", "FIRFilter", "IIRFilter",
    "MODWT", "MultirateFilter", "STFT", "SpectralAnalyzer", "StreamingFIR",
    "StreamingIIR", "WINDOWS", "WPT", "WignerVille", "butterworth",
    "cepstrum", "chebyshev1", "compute_coherence", "compute_psd",
    "compute_spectrogram", "design_fir_bandpass", "design_fir_equiripple",
    "design_fir_highpass", "design_fir_least_squares", "design_fir_lowpass",
    "detect_harmonics", "detect_peaks", "fir_apply", "fir_batch",
    "fir_batch_bf16", "fir_batch_flat", "fir_batch_lanes", "get_window",
    "median_filter", "mel_spectrogram", "mfcc", "pitch_detect", "sos_apply",
]
