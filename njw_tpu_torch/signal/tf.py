"""Time-frequency analysis: STFT and its inverse, CWT, DWT, WPT, MODWT,
Wigner-Ville, EMD, mel spectrogram and MFCC.

Counterpart of ``njw_tpu/signal/tf.py``, on ``torch.fft`` and the port's
``fir_apply``:

* the wavelet transforms filter with ``fir_corr``, a causal
  ``fir_apply``; a batch of at least 8 rows of at least 65536 samples
  therefore runs on the banded-product kernel ``ops/csrc/fir_band.cu``
  on the card (a ``MODWT`` level of a (16, 10^6) batch is two launches);
* ``STFT.inverse`` adds the frames by shifted slices in a fixed order
  (no scatter with atomics), so the card's result is the same from run to
  run, and makes the DC and Nyquist bins Hermitian before its inverse
  FFT;
* ``CWT`` transforms every scale in one batched FFT;
* ``EMD``'s sifting and spline, and ``DWT.denoise``'s threshold, run on
  the host in NumPy, as in the JAX package.

NumPy input goes to ``device`` (CUDA unless the caller says otherwise);
tensors stay on their own device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.platform.precision import float32_products
from njw_tpu_torch.signal.filters import as_signal, fir_apply
from njw_tpu_torch.signal.spectral import _as_input, _frame, _window, irfft


# ---------------------------------------------------------------------------
# STFT / ISTFT
# ---------------------------------------------------------------------------


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum (..., F, n) frames placed ``hop`` apart into (..., n + (F-1) hop):
    each frame cut into ceil(n / hop) hop-long pieces (zero-padded), and
    piece c of every frame added to the output by one shifted slice, c in
    order. Deterministic on every device."""
    *batch, nf, n = frames.shape
    r = -(-n // hop)
    pieces = torch.nn.functional.pad(frames, (0, r * hop - n)).reshape(
        *batch, nf, r, hop)
    y = frames.new_zeros((*batch, nf + r - 1, hop))
    for c in range(r):
        y[..., c:c + nf, :] += pieces[..., c, :]
    return y.reshape(*batch, -1)[..., :n + (nf - 1) * hop]


class STFT:
    def __init__(self, n_fft: int = 256, hop: Optional[int] = None,
                 window: str = "hann", device="cuda"):
        self.n_fft = n_fft
        self.hop = hop or n_fft // 4
        self.window = window
        self.device = device

    def forward(self, x):
        """(..., n) -> (..., freqs, frames) complex."""
        x = as_signal(x, self.device)
        w = _window(self.window, self.n_fft, x)
        frames = _frame(x, self.n_fft, self.hop) * w
        return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)

    def inverse(self, S, length: Optional[int] = None):
        """Overlap-add inverse with window-square normalisation."""
        S = _as_input(S, self.device).transpose(-1, -2)  # (..., frames, freqs)
        w = _window(self.window, self.n_fft, S)
        frames = irfft(S, self.n_fft) * w
        y = overlap_add(frames, self.hop)
        norm = overlap_add((w * w).expand(frames.shape[-2], -1), self.hop)
        y = y / norm.clamp_min(1e-8)
        return y if length is None else y[..., :length]


# ---------------------------------------------------------------------------
# CWT
# ---------------------------------------------------------------------------


def _morlet(t, w0: float = 6.0):
    return (np.pi ** -0.25) * torch.exp(1j * w0 * t) * torch.exp(-0.5 * t * t)


def _ricker(t, w0: float = 6.0):
    a = 1.0
    return (2 / (float(np.float32(np.sqrt(3 * a))) * np.pi ** 0.25)
            * (1 - (t / a) ** 2) * torch.exp(-0.5 * (t / a) ** 2))


_CWT_WAVELETS = {"morlet": _morlet, "ricker": _ricker, "mexican_hat": _ricker}


class CWT:
    def __init__(self, wavelet: str = "morlet", w0: float = 6.0,
                 device="cuda"):
        if wavelet not in _CWT_WAVELETS:
            raise ValueError(f"unknown wavelet {wavelet!r}")
        self.wavelet = wavelet
        self.w0 = w0
        self.device = device

    def forward(self, x, scales):
        """(..., n) signal x, (S,) scales -> (S, ..., n) coefficients: an
        FFT convolution with every scale's wavelet at once."""
        x = as_signal(x, self.device)
        scales = torch.as_tensor(np.asarray(scales, np.float32)).to(x.device)
        n = x.shape[-1]
        nfft = int(2 ** np.ceil(np.log2(2 * n)))
        X = torch.fft.fft(x, n=nfft)
        t = torch.arange(-(nfft // 2), nfft // 2, dtype=torch.float32,
                         device=x.device)
        psi = _CWT_WAVELETS[self.wavelet](t / scales[:, None], self.w0)
        psi = torch.roll(psi, nfft // 2, dims=-1) / torch.sqrt(scales)[:, None]
        P = torch.fft.fft(torch.flip(psi, dims=[-1]).conj(), dim=-1)
        P = P.reshape((len(scales),) + (1,) * (x.ndim - 1) + (nfft,))
        return torch.fft.ifft(X * P)[..., :n]

    def scale_to_frequency(self, scales, fs: float = 1.0):
        center = self.w0 / (2 * np.pi) if self.wavelet == "morlet" else 0.25
        return center * fs / np.asarray(scales)


# ---------------------------------------------------------------------------
# DWT, WPT, MODWT
# ---------------------------------------------------------------------------

# Orthogonal wavelet lowpass decomposition coefficients (the published
# Daubechies values).
_DB = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [0.48296291314469025, 0.836516303737469,
            0.22414386804185735, -0.12940952255092145],
    "db4": [0.23037781330885523, 0.7148465705525415,
            0.6308807679295904, -0.02798376941698385,
            -0.18703481171888114, 0.030841381835986965,
            0.032883011666982945, -0.010597401784997278],
}


def _qmf(h):
    h = np.asarray(h, np.float32)
    g = h[::-1].copy()
    g[1::2] *= -1.0
    return g


def fir_corr(x, taps, *, device=None) -> torch.Tensor:
    """Valid-mode correlation along the last axis: a causal FIR with the
    reversed taps, less its first len(taps) - 1 outputs."""
    x = as_signal(x, device)
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    return fir_apply(x, taps[::-1], mode="causal")[..., k - 1:]


class DWT:
    """Single- and multi-level discrete wavelet transform, periodic
    extension. NumPy input goes to ``device``."""

    def __init__(self, wavelet: str = "db2", device="cuda"):
        if wavelet not in _DB:
            raise ValueError(
                f"unknown wavelet {wavelet!r}; available: {sorted(_DB)}")
        self.name = wavelet
        self.device = device
        self.dec_lo = np.asarray(_DB[wavelet], np.float32)
        self.dec_hi = _qmf(self.dec_lo)
        # orthogonal: the reconstruction filters are the time reverses
        self.rec_lo = self.dec_lo[::-1].copy()
        self.rec_hi = self.dec_hi[::-1].copy()

    def _analyze(self, x):
        k = len(self.dec_lo)
        xp = torch.cat([x, x[..., :k - 1]], dim=-1)          # periodic
        n2 = x.shape[-1] // 2
        lo = fir_corr(xp, self.dec_lo)[..., ::2]
        hi = fir_corr(xp, self.dec_hi)[..., ::2]
        return lo[..., :n2], hi[..., :n2]

    def decompose(self, x, level: int = 1):
        """Returns [cA_L, cD_L, ..., cD_1] (the wavedec layout)."""
        approx = as_signal(x, self.device)
        details = []
        for _ in range(level):
            approx, d = self._analyze(approx)
            details.append(d)
        return [approx] + details[::-1]

    def _synthesize(self, lo, hi):
        k = len(self.rec_lo)
        n2 = lo.shape[-1]
        up_lo = lo.new_zeros(lo.shape[:-1] + (2 * n2,))
        up_hi = torch.zeros_like(up_lo)
        up_lo[..., ::2] = lo
        up_hi[..., ::2] = hi
        # reconstruction is the adjoint of the periodized analysis,
        # x[j] = sum_k h[(j-2k) mod n] cA[k] + g[(j-2k) mod n] cD[k]:
        # circular convolutions, as correlations with the reversed filters
        pl = torch.cat([up_lo[..., -(k - 1):], up_lo], dim=-1)
        ph = torch.cat([up_hi[..., -(k - 1):], up_hi], dim=-1)
        y = fir_corr(pl, self.rec_lo) + fir_corr(ph, self.rec_hi)
        return y[..., :2 * n2]

    def reconstruct(self, coeffs):
        approx = coeffs[0]
        for d in coeffs[1:]:
            approx = self._synthesize(approx, d)
        return approx

    def denoise(self, x, level: int = 3, threshold: Optional[float] = None,
                mode: str = "soft"):
        """Wavelet shrinkage: the universal threshold from the finest
        detail's median absolute deviation (on the host) unless given."""
        x = as_signal(x, self.device)
        coeffs = self.decompose(x, level)
        if threshold is None:
            d1 = coeffs[-1].detach().cpu().numpy()
            sigma = np.median(np.abs(d1)) / 0.6745
            threshold = sigma * np.sqrt(2 * np.log(max(x.shape[-1], 2)))
        threshold = float(threshold)
        out = [coeffs[0]]
        for d in coeffs[1:]:
            if mode == "soft":
                d = torch.sign(d) * (d.abs() - threshold).clamp_min(0.0)
            else:
                d = torch.where(d.abs() > threshold, d, 0.0)
            out.append(d)
        return self.reconstruct(out)[..., :x.shape[-1]]


class WPT:
    """Wavelet packet transform: the full binary tree of DWT splits."""

    def __init__(self, wavelet: str = "db2", device="cuda"):
        self._dwt = DWT(wavelet, device=device)

    def decompose(self, x, level: int = 2):
        """The 2^level leaf subbands (natural order)."""
        nodes = [as_signal(x, self._dwt.device)]
        for _ in range(level):
            nodes = [band for node in nodes
                     for band in self._dwt._analyze(node)]
        return nodes

    def reconstruct(self, leaves):
        nodes = list(leaves)
        while len(nodes) > 1:
            nodes = [self._dwt._synthesize(nodes[i], nodes[i + 1])
                     for i in range(0, len(nodes), 2)]
        return nodes[0]

    def energy_map(self, x, level: int = 2) -> np.ndarray:
        """Energy of each subband (NumPy)."""
        return np.asarray([float((b * b).sum())
                           for b in self.decompose(x, level)])


class MODWT:
    """Maximal-overlap (undecimated) DWT: shift-invariant, every level of
    the input's length; the filters rescaled by 1/sqrt(2) and upsampled by
    2^(j-1) at level j."""

    def __init__(self, wavelet: str = "db2", device="cuda"):
        base = DWT(wavelet)
        self.device = device
        self.h = np.asarray(base.dec_lo, np.float64) / np.sqrt(2.0)
        self.g = np.asarray(base.dec_hi, np.float64) / np.sqrt(2.0)

    def _circ_filter(self, x, taps, upsample: int):
        """Circular correlation with the taps upsampled by ``upsample``."""
        n = x.shape[-1]
        full = np.zeros(len(taps) * upsample - (upsample - 1), np.float32)
        full[::upsample] = taps
        k = len(full)
        xp = torch.cat([x, x[..., :k - 1]], dim=-1)
        return fir_corr(xp, full)[..., :n]

    def decompose(self, x, level: int = 3):
        """[w1, ..., wL, vL]: the details of each level and the final
        smooth, all of the input's length."""
        v = as_signal(x, self.device)
        out = []
        for j in range(level):
            up = 2 ** j
            out.append(self._circ_filter(v, self.g, up))
            v = self._circ_filter(v, self.h, up)
        out.append(v)
        return out

    def energy_decomposition(self, x, level: int = 3) -> np.ndarray:
        return np.asarray([float((c * c).sum())
                           for c in self.decompose(x, level)])


# ---------------------------------------------------------------------------
# Wigner-Ville
# ---------------------------------------------------------------------------


class WignerVille:
    """Discrete pseudo Wigner-Ville distribution. ``forward`` builds the
    (n, 2 floor(n/2)) complex64 kernel matrix by gathers on the whole index
    grid at once: O(n^2) memory, 134 MB at n = 4096."""

    def __init__(self, device="cuda"):
        self.device = device

    def frequencies(self, n: int, fs: float = 1.0):
        """Frequency axis: the kernel x(t+tau) x*(t-tau) oscillates at
        2 f0, so bin k maps to f = k fs / (2 n)."""
        return np.arange(n) * fs / (2.0 * n)

    def forward(self, x):
        """(n,) real or complex -> (n_freq, n) distribution."""
        x = _as_input(x, self.device)
        if not x.is_complex():
            x = _analytic(x)
        n = x.shape[-1]
        half = n // 2
        taus = torch.arange(-half, half, device=x.device)
        t = torch.arange(n, device=x.device)[:, None]
        ip, im = t + taus, t - taus
        valid = (ip >= 0) & (ip < n) & (im >= 0) & (im < n)
        r = torch.where(valid, x[ip.clamp(0, n - 1)]
                        * x[im.clamp(0, n - 1)].conj(), 0.0)
        W = torch.fft.fft(torch.fft.ifftshift(r, dim=-1), dim=-1)
        return W.real.t()                             # (freq, time)


def _analytic(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal via the frequency-domain Hilbert transform."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float32, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(x) * h)


# ---------------------------------------------------------------------------
# EMD (host-side: data-dependent iteration counts)
# ---------------------------------------------------------------------------


class EMD:
    """Empirical mode decomposition with natural cubic-spline envelopes,
    sifted on the host in float64 NumPy. Returns NumPy arrays."""

    def __init__(self, max_imfs: int = 6, max_siftings: int = 50,
                 tol: float = 0.05):
        self.max_imfs = max_imfs
        self.max_siftings = max_siftings
        self.tol = tol

    @staticmethod
    def _envelope(x, idx):
        """Natural cubic spline through (idx, x[idx]) sampled everywhere."""
        t = np.arange(len(x), dtype=np.float64)
        xi, yi = t[idx], x[idx]
        if len(xi) < 2:
            return np.full_like(x, x.mean())
        if len(xi) < 4:
            return np.interp(t, xi, yi)
        return _cubic_spline(xi, yi, t)

    def decompose(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        residue = np.asarray(x, np.float64).copy()
        imfs = []
        for _ in range(self.max_imfs):
            h = residue.copy()
            for _ in range(self.max_siftings):
                maxima = _local_extrema(h, np.greater)
                minima = _local_extrema(h, np.less)
                if len(maxima) < 2 or len(minima) < 2:
                    break
                mean = 0.5 * (self._envelope(h, maxima)
                              + self._envelope(h, minima))
                h_new = h - mean
                if (np.sum(mean ** 2) / max(np.sum(h ** 2), 1e-30)) < self.tol:
                    h = h_new
                    break
                h = h_new
            imfs.append(h)
            residue = residue - h
            if len(_local_extrema(residue, np.greater)) < 2:
                break
        return imfs, residue


def _local_extrema(x, op):
    idx = np.where(op(x[1:-1], x[:-2]) & op(x[1:-1], x[2:]))[0] + 1
    return np.concatenate([[0], idx, [len(x) - 1]])


def _cubic_spline(xi, yi, t):
    """Natural cubic spline evaluation (tridiagonal solve, NumPy)."""
    n = len(xi)
    h = np.diff(xi)
    rhs = np.zeros(n)
    rhs[1:-1] = 3 * ((yi[2:] - yi[1:-1]) / h[1:]
                     - (yi[1:-1] - yi[:-2]) / h[:-1])
    # tridiagonal system for second derivatives (natural BC)
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    a[1:-1] = h[:-1]
    b[1:-1] = 2 * (h[:-1] + h[1:])
    c[1:-1] = h[1:]
    # Thomas algorithm
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = rhs[0] / b[0]
    for i in range(1, n):
        m = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / m
        dp[i] = (rhs[i] - a[i] * dp[i - 1]) / m
    m2 = np.zeros(n)
    m2[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        m2[i] = dp[i] - cp[i] * m2[i + 1]
    # evaluate
    j = np.clip(np.searchsorted(xi, t) - 1, 0, n - 2)
    dx = t - xi[j]
    dj = (yi[j + 1] - yi[j]) / h[j] - h[j] * (2 * m2[j] + m2[j + 1]) / 3
    return yi[j] + dj * dx + m2[j] * dx ** 2 + (
        (m2[j + 1] - m2[j]) / (3 * h[j])) * dx ** 3


# ---------------------------------------------------------------------------
# Mel / MFCC
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, fs: float,
                   fmin: float = 0.0, fmax: Optional[float] = None):
    """(n_mels, n_fft // 2 + 1) triangular filters, float32 NumPy."""
    fmax = fmax or fs / 2
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / fs).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > l:
            fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


def mel_spectrogram(x, fs: float = 16000.0, n_fft: int = 512,
                    hop: Optional[int] = None, n_mels: int = 40, *,
                    device=None):
    """(..., n_mels, frames) mel power spectrogram (float32 products)."""
    x = as_signal(x, device)
    S = STFT(n_fft=n_fft, hop=hop or n_fft // 4).forward(x).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, fs)).to(x.device)
    with float32_products():
        return fb @ S


def mfcc(x, fs: float = 16000.0, n_fft: int = 512,
         hop: Optional[int] = None, n_mels: int = 40, n_mfcc: int = 13, *,
         device=None):
    """(..., n_mfcc, frames): the orthonormal DCT-II of the log mel
    spectrogram."""
    M = mel_spectrogram(x, fs, n_fft, hop, n_mels, device=device)
    logM = torch.log(M.clamp_min(1e-10))
    k = torch.arange(n_mels, dtype=torch.float32, device=M.device)
    q = torch.arange(n_mfcc, dtype=torch.float32, device=M.device)
    basis = torch.cos(math.pi * (k[None, :] + 0.5) * q[:, None] / n_mels)
    basis = basis * float(np.float32(np.sqrt(2.0 / n_mels)))
    basis[0] *= float(np.float32(1.0 / np.sqrt(2.0)))
    with float32_products():
        return basis @ logM
