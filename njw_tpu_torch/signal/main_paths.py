"""The main paths of the batched FIR filter, defined once.

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.signal.filters import FIRFilter, design_fir_lowpass
from njw_tpu_torch.signal.fir_cuda import fir_batch_bf16


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
