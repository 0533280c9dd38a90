"""FIR filtering: design, application, multirate and streaming.

Counterpart of the FIR half of ``njw_tpu/signal/filters.py``. Design runs
on the host in NumPy, as there (window method, least squares,
equiripple); application is the hot path:

* a causal batch (at least 8 rows of at least 65536 samples, at most 128
  taps) goes to the banded-product kernel through ``fir_batch_lanes``
  (``signal/fir_cuda.py``): on a CUDA tensor it launches
  ``ops/csrc/fir_band.cu``, on a CPU tensor it runs the kernel's plain
  version. This is the branch the JAX package sends to its Pallas kernel
  on a TPU.
* other inputs with at most 128 taps: the framed product
  ``_fir_apply_mxu``, two (n/128, 128) x (128, 128) float32 matrix
  products with the in-frame and previous-frame band matrices (the JAX
  package leaves it to XLA; here it is ``torch.matmul``);
* longer filters: ``torch.nn.functional.conv1d``, in float32 (TF32 off).

The band matrices of a set of taps, and the bf16 terms the kernel reads,
are built once per device and cached (``fir_bands``): building them is a
Python loop of k ``np.diag`` calls and an upload.

Entry points given NumPy input put it on ``device`` ("cuda" unless the
caller says otherwise) and raise without CUDA; tensors stay on their own
device. IIR, adaptive, median and the streaming IIR filter are not
ported yet.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.signal.windows import get_window

FRAME = 128          # samples per frame of the banded product
BATCH_ROWS = 8       # fir_apply's batch branch: at least this many rows,
BATCH_SAMPLES = 1 << 16  # of at least this many samples


# ---------------------------------------------------------------------------
# FIR design (window method)
# ---------------------------------------------------------------------------


def _sinc_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Ideal lowpass impulse response; cutoff in (0, 1) Nyquist units."""
    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    return h


def design_fir_lowpass(num_taps: int, cutoff: float,
                       window: str = "hamming") -> np.ndarray:
    w = np.asarray(get_window(window, num_taps))
    h = _sinc_lowpass(num_taps, cutoff) * w
    return (h / h.sum()).astype(np.float32)


def design_fir_highpass(num_taps: int, cutoff: float,
                        window: str = "hamming") -> np.ndarray:
    if num_taps % 2 == 0:
        raise ValueError("highpass FIR needs odd num_taps")
    lp = design_fir_lowpass(num_taps, cutoff, window)
    h = -lp
    h[(num_taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def design_fir_bandpass(num_taps: int, low: float, high: float,
                        window: str = "hamming") -> np.ndarray:
    w = np.asarray(get_window(window, num_taps))
    h = (_sinc_lowpass(num_taps, high) - _sinc_lowpass(num_taps, low)) * w
    # normalize at band center
    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = (low + high) / 2.0
    gain = np.abs(np.sum(h * np.exp(-1j * np.pi * fc * m)))
    return (h / max(gain, 1e-12)).astype(np.float32)


def design_fir_least_squares(num_taps: int, bands, desired,
                             n_grid: int = 512) -> np.ndarray:
    """Least-squares linear-phase FIR design: minimizes the L2 error of the
    amplitude response over a dense frequency grid.

    bands: [(f0, f1), ...] in Nyquist units; desired: amplitude per band.
    """
    if num_taps % 2 == 0:
        raise ValueError("least-squares design needs odd num_taps")
    m = (num_taps - 1) // 2
    w_grid = []
    d_grid = []
    for (f0, f1), amp in zip(bands, desired):
        f = np.linspace(f0, f1, max(int(n_grid * (f1 - f0)), 8))
        w_grid.append(f)
        d_grid.append(np.full_like(f, amp))
    w = np.concatenate(w_grid) * np.pi
    d = np.concatenate(d_grid)
    # amplitude of a type-I filter: A(w) = c0 + 2 sum_k c_k cos(k w)
    A = np.ones((len(w), m + 1))
    for k in range(1, m + 1):
        A[:, k] = 2.0 * np.cos(k * w)
    c, *_ = np.linalg.lstsq(A, d, rcond=None)
    h = np.concatenate([c[:0:-1], [c[0]], c[1:]]).astype(np.float32)
    return h


def design_fir_equiripple(num_taps: int, bands, desired, weights=None,
                          n_iterations: int = 60,
                          n_grid: int = 1024) -> np.ndarray:
    """Equiripple linear-phase FIR design by Lawson-weighted iterative
    least squares: reweighting the L2 solution by |error| each iteration
    converges to the Chebyshev (minimax) solution."""
    if num_taps % 2 == 0:
        raise ValueError("equiripple design needs odd num_taps")
    m = (num_taps - 1) // 2
    w_grid, d_grid, base_w = [], [], []
    weights = weights or [1.0] * len(bands)
    for (f0, f1), amp, bw in zip(bands, desired, weights):
        f = np.linspace(f0, f1, max(int(n_grid * (f1 - f0)), 16))
        w_grid.append(f)
        d_grid.append(np.full_like(f, amp))
        base_w.append(np.full_like(f, bw))
    w = np.concatenate(w_grid) * np.pi
    d = np.concatenate(d_grid)
    lam = np.concatenate(base_w)

    A = np.ones((len(w), m + 1))
    for k in range(1, m + 1):
        A[:, k] = 2.0 * np.cos(k * w)

    wt = lam.copy()
    c = None
    for _ in range(n_iterations):
        sw = np.sqrt(wt)
        c, *_ = np.linalg.lstsq(A * sw[:, None], d * sw, rcond=None)
        err = np.abs(A @ c - d) * lam
        wt = wt * (err + 1e-12)
        wt = wt / wt.sum() * len(wt)
    h = np.concatenate([c[:0:-1], [c[0]], c[1:]]).astype(np.float32)
    return h


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------


def as_signal(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``: a tensor stays on its device; other
    input goes to ``device`` (CUDA unless given), which must exist."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    dev = require_device("cuda" if device is None else device)
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dtype)


def taps_array(taps) -> np.ndarray:
    """The taps as a 1-D float32 NumPy array."""
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return np.ascontiguousarray(taps, np.float32).reshape(-1)


def _fir_band_matrices(taps) -> tuple[np.ndarray, np.ndarray]:
    taps = np.asarray(taps, np.float32)
    k = taps.shape[0]
    F_ = FRAME
    h0 = np.zeros((F_, F_), np.float32)
    h1 = np.zeros((F_, F_), np.float32)
    for d in range(k):           # y[t] += h[d] * x[t - d]
        h0 += np.diag(np.full(F_ - d, taps[d], np.float32), d)
        if d > 0:
            h1 += np.diag(np.full(d, taps[d], np.float32), d - F_)
    return h0, h1


class FIRBands(NamedTuple):
    """The band matrices of one set of taps (k <= 128) on one device."""

    h0: torch.Tensor     # (128, 128) float32: in-frame band h[j - s]
    h1: torch.Tensor     # (128, 128) float32: previous-frame band
    terms: torch.Tensor  # (3, 256, 128) bfloat16: [H1; H0] = t0 + t1 + t2,
    #                      each term the bf16 rounding of what is left


def split_terms(a: torch.Tensor, count: int) -> list[torch.Tensor]:
    """``count`` bf16 terms of the float32 ``a``, each held in float32:
    t0 = bf16(a), t1 = bf16(a - t0), t2 = bf16(a - t0 - t1), the
    differences taken in float32, the roundings to nearest even."""
    out, rest = [], a
    for i in range(count):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        if i + 1 < count:
            rest = rest - t
    return out


@lru_cache(maxsize=64)
def _bands(key: bytes, device: str) -> FIRBands:
    taps = np.frombuffer(key, np.float32)
    h0, h1 = _fir_band_matrices(taps)
    dev = torch.device(device)
    hcat = torch.from_numpy(np.concatenate([h1, h0])).to(dev)
    terms = torch.stack([t.to(torch.bfloat16) for t in split_terms(hcat, 3)])
    return FIRBands(torch.from_numpy(h0).to(dev), torch.from_numpy(h1).to(dev),
                    terms.contiguous())


def fir_bands(taps, device) -> FIRBands:
    """The band matrices of ``taps`` on ``device``, built once and cached."""
    t = taps_array(taps)
    if t.shape[0] > FRAME:
        raise ValueError(f"taps must be <= {FRAME}")
    if t.shape[0] == 0:
        raise ValueError("need at least one tap")
    return _bands(t.tobytes(), str(torch.device(device)))


def _fir_apply_mxu(xb: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor,
                   mode: str, k: int) -> torch.Tensor:
    """Framed-product FIR: y-frame[j] = X[j] @ H0 + X[j-1] @ H1, float32."""
    b, n = xb.shape
    start = 0 if mode == "causal" else (k - 1) // 2
    nf = -(-(n + start) // FRAME)
    frames = F.pad(xb, (0, nf * FRAME - n)).reshape(b, nf, FRAME)
    prev = F.pad(frames[:, :-1, :], (0, 0, 1, 0))
    y = (frames @ h0 + prev @ h1).reshape(b, nf * FRAME)
    return y[:, start:start + n]


@contextlib.contextmanager
def _ieee_conv(device: torch.device):
    """cuDNN convolutions in full float32 (PyTorch's default is TF32)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _fir_apply_conv(xb: torch.Tensor, taps: np.ndarray, mode: str,
                    k: int) -> torch.Tensor:
    w = torch.from_numpy(taps[::-1].copy()).to(xb.device).view(1, 1, k)
    with _ieee_conv(xb.device):
        out = F.conv1d(xb[:, None, :], w, padding=k - 1)[:, 0, :]
    n = xb.shape[-1]
    start = 0 if mode == "causal" else (k - 1) // 2
    return out[:, start:start + n]


def fir_apply(x, taps, mode: str = "causal", *, device=None) -> torch.Tensor:
    """Apply FIR taps to (..., n) signals.

    mode='causal': y[i] = sum_k h[k] x[i-k], zero initial state.
    mode='same'  : centre-aligned (output i is the causal output at
    i + (k-1)//2).

    A causal batch of at least 8 rows of at least 65536 samples with at
    most 128 taps runs through the banded-product kernel
    (``fir_batch_lanes``); other inputs with at most 128 taps through the
    framed product; longer filters through a convolution.
    """
    x = as_signal(x, device)
    taps = taps_array(taps)
    if mode not in ("causal", "same"):
        raise ValueError(mode)
    squeeze = x.ndim == 1
    xb = x[None, :] if squeeze else x.reshape(-1, x.shape[-1])
    k = int(taps.shape[0])
    if k <= FRAME:
        if (mode == "causal" and not squeeze and xb.shape[0] >= BATCH_ROWS
                and xb.shape[-1] >= BATCH_SAMPLES):
            from njw_tpu_torch.signal.fir_cuda import fir_batch_lanes

            return fir_batch_lanes(xb, taps).reshape(x.shape)
        bands = fir_bands(taps, xb.device)
        y = _fir_apply_mxu(xb, bands.h0, bands.h1, mode, k)
    else:
        y = _fir_apply_conv(xb, taps, mode, k)
    return y[0] if squeeze else y.reshape(x.shape)


class FIRFilter:
    """FIR filter: design from (num_taps, cutoff, filter_type, window) or
    given taps, and application. NumPy input goes to ``device``."""

    def __init__(self, taps=None, *, num_taps: Optional[int] = None,
                 cutoff=None, filter_type: str = "lowpass",
                 window: str = "hamming", device="cuda"):
        if taps is None:
            if filter_type == "lowpass":
                taps = design_fir_lowpass(num_taps, cutoff, window)
            elif filter_type == "highpass":
                taps = design_fir_highpass(num_taps, cutoff, window)
            elif filter_type == "bandpass":
                taps = design_fir_bandpass(num_taps, *cutoff, window=window)
            elif filter_type == "bandstop":
                bp = design_fir_bandpass(num_taps, *cutoff, window=window)
                taps = -bp
                taps[(num_taps - 1) // 2] += 1.0
            else:
                raise ValueError(f"unknown filter_type {filter_type!r}")
        self.taps = taps_array(taps)
        self.device = device

    def apply(self, x, mode: str = "causal") -> torch.Tensor:
        return fir_apply(x, self.taps, mode=mode, device=self.device)

    __call__ = apply

    def frequency_response(self, n_points: int = 512):
        H = np.fft.rfft(self.taps, n=2 * n_points)
        freqs = np.linspace(0.0, 1.0, len(H))
        return freqs, H


class MultirateFilter:
    """Decimation, interpolation and rational resampling with windowed
    lowpass FIR filters. NumPy input goes to ``device``."""

    def __init__(self, *, num_taps: int = 64, window: str = "hamming",
                 device="cuda"):
        self.num_taps = num_taps
        self.window = window
        self.device = device

    def _taps(self, factor: int) -> np.ndarray:
        return design_fir_lowpass(self.num_taps, 1.0 / factor - 0.02,
                                  self.window)

    def decimate(self, x, factor: int) -> torch.Tensor:
        """Anti-alias lowpass then downsample by `factor`."""
        y = fir_apply(x, self._taps(factor), mode="same", device=self.device)
        return y[..., ::factor]

    def interpolate(self, x, factor: int) -> torch.Tensor:
        """Zero-stuff then image-reject lowpass (gain = factor)."""
        x = as_signal(x, self.device)
        up = x.new_zeros(x.shape[:-1] + (x.shape[-1] * factor,))
        up[..., ::factor] = x
        return fir_apply(up, self._taps(factor) * factor, mode="same")

    def resample(self, x, up: int, down: int) -> torch.Tensor:
        """Rational-rate resample up/down."""
        return self.decimate(self.interpolate(x, up), down)


class StreamingFIR:
    """Causal FIR over chunks: carries the last (taps-1) input samples.
    Chunks given as NumPy go to ``device``; the carried tail lives there."""

    def __init__(self, taps, *, device="cuda"):
        self.taps = taps_array(taps)
        self.device = require_device(device)
        self.reset()

    def reset(self):
        self._tail = torch.zeros(len(self.taps) - 1, dtype=torch.float32,
                                 device=self.device)

    def process(self, chunk) -> torch.Tensor:
        chunk = as_signal(chunk, self.device)
        k = len(self.taps)
        xx = torch.cat([self._tail, chunk])
        y = fir_apply(xx, self.taps, mode="causal")[k - 1:]
        if k > 1:
            self._tail = xx[-(k - 1):]
        return y
