"""The main paths of the batched FIR filter and the analysis paths of the
rest of the signal package, defined once.

``chip_smoke.py`` drives these on the card and ``scripts/profile_torch.py
--model fir`` profiles fir_batch; both take them from here. Each is a run
the JAX package times, with a 101-tap Hamming lowpass at cutoff 0.25 and a
signal of standard normal samples made with ``np.random.default_rng(seed)``:

  fir_batch  FIRFilter(num_taps=101, cutoff=0.25).apply on (1000, 100000)
             float32: the reference's batch throughput row
             (scripts/measure_signal.py:173-181); fir_apply's batch branch
  fir_suite  the same filter on (16, 1000000) float32: the suite's
             SignalBenchmark (njw_tpu/bench/suite.py:229-251)
  fir_bf16   fir_batch_bf16(x, taps) on (1000, 100000) bf16, bf16 out
             (scripts/measure_signal.py:183-188)

``ANALYSIS_PATHS`` are the JAX package's other measured signal rows
(scripts/measure_signal.py:102-190), at their sizes, and one of the port's
own: the suite's FIR shape through MODWT, the one new path through a
ported kernel. ``chip_smoke.py`` phase 17 drives them on the card:

  iir_8th_1m        sos_apply(x, 8th-order Butterworth at 0.2, "parallel"),
                    2^20 samples (:117-122)
  lms_64_50k        AdaptiveFilter(64, "lms", mu=0.01).apply(x, d), the
                    parallel engine, 50000 samples (:124-128)
  blms_64_50k       AdaptiveFilter(64, "block_lms", mu=0.05,
                    block_size=256).apply(x, d), 50000 (:129-132)
  upsample_4x_1m    MultirateFilter(num_taps=64).interpolate(x, 4), 2^18
                    samples to 2^20 (:134-137)
  downsample_4x_1m  MultirateFilter(num_taps=64).decimate(x, 4), 2^20
                    (:138-139)
  median_11_1m      median_filter(x, 11), 2^20 (:141-142)
  fft_1024_x1k      FFT().forward(x), (1000, 1024) (:144-146)
  spectrogram_10s   compute_spectrogram(x, fs=44100.0, nperseg=1024),
                    441000 samples (:148-153)
  modwt_16x1m       MODWT("db4").decompose(x, level=4) on (16, 10^6): 8
                    fir_corr calls, each one fir_band launch (the fir_suite
                    shape, njw_tpu/bench/suite.py:229-251)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.signal.filters import (
    AdaptiveFilter, FIRFilter, IIRFilter, MultirateFilter, design_fir_lowpass,
    median_filter, sos_apply,
)
from njw_tpu_torch.signal.fir_cuda import fir_batch_bf16
from njw_tpu_torch.signal.spectral import FFT, compute_spectrogram
from njw_tpu_torch.signal.tf import MODWT


@dataclasses.dataclass(frozen=True)
class SignalPath:
    shape: tuple[int, int]       # (rows, samples)
    dtype: torch.dtype           # the signal's type
    kernel: str                  # the kernel the path launches, once a call
    num_taps: int = 101
    cutoff: float = 0.25
    warm: int = 3                # calls before a timed run
    calls: int = 20              # timed calls

    def taps(self) -> np.ndarray:
        return design_fir_lowpass(self.num_taps, self.cutoff)

    def signal(self, seed: int = 0, device="cuda") -> torch.Tensor:
        """The path's input on ``device``, made with NumPy from ``seed``."""
        x = np.random.default_rng(seed).standard_normal(self.shape,
                                                        dtype=np.float32)
        return torch.from_numpy(x).to(require_device(device), self.dtype)

    def call(self, device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
        """What a user calls on the signal, set up once (filter design)."""
        if self.dtype == torch.bfloat16:
            taps = self.taps()
            return lambda x: fir_batch_bf16(x, taps)
        return FIRFilter(num_taps=self.num_taps, cutoff=self.cutoff,
                         device=device).apply


MAIN_PATHS = {
    "fir_batch": SignalPath((1000, 100_000), torch.float32, "fir_band"),
    "fir_suite": SignalPath((16, 1_000_000), torch.float32, "fir_band"),
    "fir_bf16": SignalPath((1000, 100_000), torch.bfloat16, "fir_band_bf16"),
}


def _iir_8th(device):
    sos = IIRFilter(design="butterworth", order=8, cutoff=0.2,
                    device=device).sos
    return lambda x: sos_apply(x, sos, method="parallel")


def _multirate(method: str):
    def make(device):
        mr = MultirateFilter(num_taps=64, device=device)
        return lambda x: getattr(mr, method)(x, 4)
    return make


def _modwt(device):
    m = MODWT("db4", device=device)
    return lambda x: m.decompose(x, level=4)


@dataclasses.dataclass(frozen=True)
class AnalysisPath:
    shapes: tuple[tuple[int, ...], ...]   # each input's shape
    call: Callable   # device -> what a user calls on the inputs, set up
    #                  once (designs, taps)
    source: str                           # the row it reproduces
    fir_band: int = 0                     # fir_band launches a call
    warm: int = 3                         # calls before a timed run
    calls: int = 20                       # timed calls

    def inputs(self, seed: int = 0, device="cuda"):
        """Standard normal float32 inputs made with NumPy from ``seed``."""
        rng = np.random.default_rng(seed)
        dev = require_device(device)
        return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) for s in self.shapes]


_MEASURED = "scripts/measure_signal.py"
ANALYSIS_PATHS = {
    "iir_8th_1m": AnalysisPath(((1 << 20,),), _iir_8th,
                               f"{_MEASURED}:117-122"),
    "lms_64_50k": AnalysisPath(
        ((50_000,), (50_000,)),
        lambda dev: AdaptiveFilter(num_taps=64, method="lms", mu=0.01,
                                   device=dev).apply,
        f"{_MEASURED}:124-128"),
    "blms_64_50k": AnalysisPath(
        ((50_000,), (50_000,)),
        lambda dev: AdaptiveFilter(num_taps=64, method="block_lms", mu=0.05,
                                   block_size=256, device=dev).apply,
        f"{_MEASURED}:129-132"),
    "upsample_4x_1m": AnalysisPath(((1 << 18,),), _multirate("interpolate"),
                                   f"{_MEASURED}:134-137"),
    "downsample_4x_1m": AnalysisPath(((1 << 20,),), _multirate("decimate"),
                                     f"{_MEASURED}:138-139"),
    "median_11_1m": AnalysisPath(
        ((1 << 20,),), lambda dev: lambda x: median_filter(x, 11),
        f"{_MEASURED}:141-142"),
    "fft_1024_x1k": AnalysisPath(
        ((1000, 1024),), lambda dev: FFT(device=dev).forward,
        f"{_MEASURED}:144-146"),
    "spectrogram_10s": AnalysisPath(
        ((441_000,),),
        lambda dev: lambda x: compute_spectrogram(x, fs=44100.0,
                                                  nperseg=1024),
        f"{_MEASURED}:148-153"),
    "modwt_16x1m": AnalysisPath(
        ((16, 1_000_000),), _modwt,
        "njw_tpu/bench/suite.py:229-251 (the fir_suite shape)", fir_band=8),
}
