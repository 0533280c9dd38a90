"""Spectral analysis: FFT, Welch PSD, CSD, coherence, spectrogram, peak
and harmonic detection, cepstrum and cepstral pitch.

Counterpart of ``njw_tpu/signal/spectral.py``. Every transform is a batched
``torch.fft`` call (cuFFT on the card); functions take (n,) or (batch, n)
signals. Overlapping windows are ``Tensor.unfold`` views, whose values
are those of both of the JAX package's framing branches. Peak and
harmonic picking run on the host in NumPy, as there, and return NumPy
arrays. NumPy input goes to ``device`` (CUDA unless the caller says
otherwise); tensors stay on their own device.

Two of the JAX package's conventions are kept as they are: the PSD and
CSD double the one-sided bins 1:-1 for an even ``nperseg`` and 1: for an
odd one, while the spectrogram doubles 1:-1 whatever the parity.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.signal.filters import as_signal
from njw_tpu_torch.signal.windows import get_window


def host(a) -> np.ndarray:
    """``a`` as a NumPy array (a tensor is copied from its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_input(x, device) -> torch.Tensor:
    """A complex tensor stays as it is, complex NumPy input becomes
    complex64 on ``device``; anything else is ``as_signal``'s float32."""
    if isinstance(x, torch.Tensor) and x.is_complex():
        return x
    if not isinstance(x, torch.Tensor) and np.iscomplexobj(x):
        dev = require_device("cuda" if device is None else device)
        return torch.from_numpy(np.array(x, np.complex64)).to(dev)
    return as_signal(x, device)


def hermitian_ends(S: torch.Tensor, n: int) -> torch.Tensor:
    """The one-sided spectrum ``S`` (last axis) with the imaginary parts of
    its DC bin, and of its Nyquist bin for an even length ``n``, set to 0:
    the values pocketfft's inverse real FFT reads. cuFFT's leaves the
    output undefined for a non-Hermitian DC or Nyquist bin."""
    ends = [0] + ([n // 2] if n % 2 == 0 and n // 2 < S.shape[-1] else [])
    S = S.clone()
    S[..., ends] = S[..., ends].real.to(S.dtype)
    return S


def irfft(S: torch.Tensor, n: int, dim: int = -1, norm=None) -> torch.Tensor:
    """``torch.fft.irfft`` with the DC and Nyquist bins made Hermitian."""
    S = hermitian_ends(S.movedim(dim, -1), n)
    return torch.fft.irfft(S, n=n, norm=norm).movedim(-1, dim)


class FFT:
    """1-D and 2-D FFT facade. NumPy input goes to ``device``."""

    def __init__(self, normalize: bool = False, device="cuda"):
        self.norm = "ortho" if normalize else None
        self.device = device

    def forward(self, x):
        return torch.fft.fft(_as_input(x, self.device), norm=self.norm)

    def inverse(self, X):
        return torch.fft.ifft(_as_input(X, self.device), norm=self.norm)

    def forward_real(self, x):
        return torch.fft.rfft(as_signal(x, self.device), norm=self.norm)

    def inverse_real(self, X, n: Optional[int] = None):
        X = _as_input(X, self.device)
        return irfft(X, 2 * (X.shape[-1] - 1) if n is None else n,
                     norm=self.norm)

    def forward2d(self, x):
        return torch.fft.fft2(_as_input(x, self.device), norm=self.norm)

    def inverse2d(self, X):
        return torch.fft.ifft2(_as_input(X, self.device), norm=self.norm)

    @staticmethod
    def magnitude(X):
        return X.abs()

    @staticmethod
    def phase(X):
        return X.angle()

    @staticmethod
    def power_db(X, floor_db: float = -200.0):
        p = X.abs() ** 2
        return (10.0 * torch.log10(p.clamp_min(1e-30))).clamp_min(floor_db)


def _frame(x: torch.Tensor, nperseg: int, step: int) -> torch.Tensor:
    """(..., n) -> (..., frames, nperseg) strided windows (a view). A
    signal shorter than one window raises (the JAX package returns NaN
    spectra from its empty frame stack)."""
    if x.shape[-1] < nperseg:
        raise ValueError(f"a signal of {x.shape[-1]} samples is shorter "
                         f"than one window of {nperseg}")
    return x.unfold(-1, nperseg, step)


def _window(window: str, nperseg: int, like: torch.Tensor) -> torch.Tensor:
    """The window on ``like``'s device, uploaded once per (window, length,
    device): an upload from pageable memory waits for the device."""
    return _window_on(window, nperseg, str(like.device))


@lru_cache(maxsize=64)
def _window_on(window: str, nperseg: int, device: str) -> torch.Tensor:
    return torch.from_numpy(np.array(get_window(window, nperseg),
                                     np.float32)).to(device)


def _one_sided(p: torch.Tensor, nperseg: int) -> torch.Tensor:
    """Double the one-sided bins: 1:-1 for an even nperseg, 1: for odd."""
    p = p.clone()
    if nperseg % 2 == 0:
        p[..., 1:-1] *= 2.0
    else:
        p[..., 1:] *= 2.0
    return p


def _rfftfreq(nperseg: int, fs: float, like: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftfreq(nperseg, d=1.0 / fs, device=like.device)


def compute_psd(x, fs: float = 1.0, nperseg: int = 256,
                noverlap: Optional[int] = None, window: str = "hann",
                detrend: bool = True, *, device=None):
    """Welch power spectral density. Returns (freqs, psd)."""
    x = as_signal(x, device)
    if noverlap is None:
        noverlap = nperseg // 2
    frames = _frame(x, nperseg, nperseg - noverlap)
    if detrend:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    w = _window(window, nperseg, x)
    spec = torch.fft.rfft(frames * w, dim=-1)
    scale = 1.0 / (fs * (w * w).sum())
    p = _one_sided(spec.abs() ** 2 * scale, nperseg)
    return _rfftfreq(nperseg, fs, x), p.mean(dim=-2)


def compute_csd(x, y, fs: float = 1.0, nperseg: int = 256,
                noverlap: Optional[int] = None, window: str = "hann", *,
                device=None):
    """Cross spectral density (one-sided, as ``compute_psd``)."""
    x = as_signal(x, device)
    y = as_signal(y, x.device)
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    w = _window(window, nperseg, x)
    X = torch.fft.rfft(_frame(x, nperseg, step) * w, dim=-1)
    Y = torch.fft.rfft(_frame(y, nperseg, step) * w, dim=-1)
    scale = 1.0 / (fs * (w * w).sum())
    csd = (X.conj() * Y).mean(dim=-2) * scale
    return _rfftfreq(nperseg, fs, x), _one_sided(csd, nperseg)


def compute_coherence(x, y, fs: float = 1.0, nperseg: int = 256,
                      noverlap: Optional[int] = None, window: str = "hann",
                      *, device=None):
    """Magnitude-squared coherence."""
    x = as_signal(x, device)
    y = as_signal(y, x.device)
    f, pxx = compute_psd(x, fs, nperseg, noverlap, window, detrend=False)
    _, pyy = compute_psd(y, fs, nperseg, noverlap, window, detrend=False)
    _, pxy = compute_csd(x, y, fs, nperseg, noverlap, window)
    return f, pxy.abs() ** 2 / (pxx * pyy).clamp_min(1e-30)


def compute_spectrogram(x, fs: float = 1.0, nperseg: int = 256,
                        noverlap: Optional[int] = None,
                        window: str = "hann", *, device=None):
    """(freqs, times, Sxx) power spectrogram; Sxx is (..., freqs, frames)."""
    x = as_signal(x, device)
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    w = _window(window, nperseg, x)
    spec = torch.fft.rfft(_frame(x, nperseg, step) * w, dim=-1)
    sxx = spec.abs() ** 2 / (fs * (w * w).sum())
    sxx[..., 1:-1] *= 2.0
    times = (torch.arange(sxx.shape[-2], device=x.device) * step
             + nperseg / 2) / fs
    return _rfftfreq(nperseg, fs, x), times, sxx.transpose(-1, -2)


def detect_peaks(spectrum, freqs=None, threshold_db: float = -40.0,
                 min_distance: int = 1, max_peaks: int = 16):
    """Local-maximum peak picking on a power spectrum, on the host.
    Returns (indices, values) as NumPy arrays (a variable count)."""
    p = host(spectrum).astype(np.float64)
    pdb = 10.0 * np.log10(np.maximum(p / max(p.max(), 1e-300), 1e-30))
    cand = np.where(
        (pdb >= threshold_db)
        & (p > np.roll(p, 1)) & (p >= np.roll(p, -1))
    )[0]
    cand = cand[(cand > 0) & (cand < len(p) - 1)]
    cand = cand[np.argsort(p[cand])[::-1]]
    chosen: list[int] = []
    for idx in cand:
        if all(abs(idx - c) >= min_distance for c in chosen):
            chosen.append(int(idx))
        if len(chosen) >= max_peaks:
            break
    chosen.sort()
    idxs = np.asarray(chosen, dtype=np.int64)
    if freqs is not None:
        return idxs, host(freqs)[idxs]
    return idxs, p[idxs]


def detect_harmonics(spectrum, freqs, f0_range=(20.0, 2000.0),
                     n_harmonics: int = 5, tolerance: float = 0.03):
    """The fundamental whose harmonic comb collects the most power (host)."""
    p = host(spectrum).astype(np.float64)
    freqs = host(freqs)
    idxs, _ = detect_peaks(p, threshold_db=-60.0, max_peaks=32)
    if len(idxs) == 0:
        return None
    best, best_score = None, -1.0
    for i in idxs:
        f0 = freqs[i]
        if not (f0_range[0] <= f0 <= f0_range[1]):
            continue
        score = 0.0
        for k in range(1, n_harmonics + 1):
            target = k * f0
            if target > freqs[-1]:
                break
            j = int(np.argmin(np.abs(freqs - target)))
            if abs(freqs[j] - target) <= tolerance * target + 1e-12:
                score += p[j]
        if score > best_score:
            best, best_score = f0, score
    return best


def cepstrum(x, kind: str = "real", *, device=None):
    """Real or power cepstrum, IFFT(log |FFT(x)|), along the last axis."""
    if kind not in ("real", "power"):
        raise ValueError("kind must be 'real' or 'power'")
    x = as_signal(x, device)
    logmag = torch.log(torch.fft.rfft(x, dim=-1).abs().clamp_min(1e-12))
    c = torch.fft.irfft(logmag, n=x.shape[-1], dim=-1)
    return c * c if kind == "power" else c


def pitch_detect(x, fs: float, fmin: float = 50.0, fmax: float = 800.0, *,
                 device=None):
    """Cepstral pitch estimate in Hz: the quefrency of the cepstral peak
    in the [1/fmax, 1/fmin] lag band."""
    return cepstral_pitch(cepstrum(x, device=device), fs, fmin, fmax)


def cepstral_pitch(c: torch.Tensor, fs: float, fmin: float = 50.0,
                   fmax: float = 800.0) -> torch.Tensor:
    """fs over the quefrency of the largest cepstral value ``c`` holds in
    the lag band; of equal values, the first (as ``jnp.argmax``)."""
    n = c.shape[-1]
    q_lo = max(int(fs / fmax), 1)
    q_hi = min(int(fs / fmin) + 1, n // 2)
    q = (torch.argmax(c[..., q_lo:q_hi], dim=-1) + q_lo).to(torch.float32)
    return torch.full_like(q, fs) / q        # one rounding, as fs / q in JAX


class SpectralAnalyzer:
    """The spectral functions with a fixed sample rate, window setting and
    device."""

    def __init__(self, fs: float = 1.0, nperseg: int = 256,
                 noverlap: Optional[int] = None, window: str = "hann",
                 device="cuda"):
        self.fs = fs
        self.nperseg = nperseg
        self.noverlap = nperseg // 2 if noverlap is None else noverlap
        self.window = window
        self.device = device

    def _args(self):
        return self.fs, self.nperseg, self.noverlap, self.window

    def psd(self, x):
        return compute_psd(x, *self._args(), device=self.device)

    def csd(self, x, y):
        return compute_csd(x, y, *self._args(), device=self.device)

    def coherence(self, x, y):
        return compute_coherence(x, y, *self._args(), device=self.device)

    def spectrogram(self, x):
        return compute_spectrogram(x, *self._args(), device=self.device)

    def find_peaks(self, x, **kw):
        f, p = self.psd(x)
        idx, _ = detect_peaks(p, **kw)
        return host(f)[idx], host(p)[idx]

    def fundamental(self, x, **kw):
        f, p = self.psd(x)
        return detect_harmonics(p, f, **kw)
