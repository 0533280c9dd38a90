"""Digital filtering: FIR, IIR, median, adaptive, multirate and streaming.

Counterpart of ``njw_tpu/signal/filters.py``. Design runs on the host in
NumPy, as there (window-method, least-squares and equiripple FIR; the
Butterworth, Chebyshev I and II and Bessel IIR families by analog
prototype, frequency transform and bilinear transform, float64, with the
same arithmetic, so the SOS arrays equal the JAX package's bit for bit);
application is the hot path:

* a causal FIR batch (at least 8 rows of at least 65536 samples, at most
  128 taps) goes to the banded-product kernel through ``fir_batch_lanes``
  (``signal/fir_cuda.py``): on a CUDA tensor it launches
  ``ops/csrc/fir_band.cu``, on a CPU tensor it runs the kernel's plain
  version. This is the branch the JAX package sends to its Pallas kernel
  on a TPU.
* other FIR inputs with at most 128 taps: the framed product
  ``_fir_apply_mxu``, two (n/128, 128) x (128, 128) float32 matrix
  products with the in-frame and previous-frame band matrices (the JAX
  package leaves it to XLA; here it is ``torch.matmul``);
* longer FIR filters: ``torch.nn.functional.conv1d``, in float32 (TF32
  off).
* ``sos_apply``: the doubling scan over each section's 2x2 state
  recurrence (``method="parallel"``, log2(n) passes of elementwise
  multiply-adds; the powers of the transition matrix in float64 NumPy) or
  the per-sample transposed direct form II (``method="scan"``, a host
  loop over samples, vectorised over the batch); ``StreamingIIR`` runs the
  same per-sample function over chunks, so its output equals the one-shot
  scan's bit for bit.
* ``AdaptiveFilter``: LMS and NLMS per sample, or exactly in parallel by
  the compact-WY chunk maps (``_lms_wy_parallel``: batched float32
  products and a doubling scan over the chunk maps); block LMS; RLS per
  sample. Every product here runs with TF32 off.

The band matrices of a set of taps, and the bf16 terms the kernel reads,
are built once per device and cached (``fir_bands``): building them is a
Python loop of k ``np.diag`` calls and an upload.

Entry points given NumPy input put it on ``device`` ("cuda" unless the
caller says otherwise) and raise without CUDA; tensors stay on their own
device. None of IIR, median or adaptive filtering launches a kernel of
the port: the JAX package has no Pallas kernel for them either.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.precision import float32_products
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


def _fir_apply_conv(xb: torch.Tensor, taps: np.ndarray, mode: str,
                    k: int) -> torch.Tensor:
    w = torch.from_numpy(taps[::-1].copy()).to(xb.device).view(1, 1, k)
    with float32_products():
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


# ---------------------------------------------------------------------------
# IIR design: analog prototype -> frequency transform -> bilinear -> SOS
# (float64 NumPy, the JAX package's arithmetic step for step)
# ---------------------------------------------------------------------------


def _butter_poles(order: int) -> np.ndarray:
    k = np.arange(order)
    theta = np.pi * (2 * k + order + 1) / (2 * order)
    return np.exp(1j * theta)


def _cheby1_poles(order: int, ripple_db: float) -> tuple[np.ndarray, float]:
    eps = np.sqrt(10 ** (ripple_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    # passband gain normalization handled by overall gain later
    gain = np.real(np.prod(-poles)) / (np.sqrt(1 + eps * eps)
                                       if order % 2 == 0 else 1.0)
    return poles, gain


def _bessel_poles(order: int) -> np.ndarray:
    """Poles of the reversed Bessel polynomial (delay-normalized)."""
    # Bessel polynomial coefficients a_k = (2n-k)! / (2^(n-k) k! (n-k)!)
    from math import factorial

    n = order
    coeffs = [
        factorial(2 * n - k) / (2 ** (n - k) * factorial(k) * factorial(n - k))
        for k in range(n + 1)
    ]
    # polynomial in s: sum_k a_k s^k -> numpy roots wants highest-first
    return np.roots(list(reversed(coeffs)))


def _zpk_bilinear(z, p, k, fs2: float = 2.0):
    """Bilinear s->z with prewarp factor folded into the cutoff transform."""
    z = np.atleast_1d(z)
    p = np.atleast_1d(p)
    degree = len(p) - len(z)
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(degree))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, kd


def _pair_roots(roots) -> list:
    """Conjugate pairs first (by real part), then reals two by two."""
    roots = sorted(roots, key=lambda r: (abs(r.imag) < 1e-10, r.real))
    used = [False] * len(roots)
    pairs = []
    for i, r in enumerate(roots):
        if used[i]:
            continue
        used[i] = True
        if abs(r.imag) > 1e-10:
            for j in range(i + 1, len(roots)):
                if not used[j] and abs(roots[j] - np.conj(r)) < 1e-6:
                    used[j] = True
                    pairs.append((r, roots[j]))
                    break
            else:
                pairs.append((r, np.conj(r)))
        else:
            mate = None
            for j in range(i + 1, len(roots)):
                if not used[j] and abs(roots[j].imag) < 1e-10:
                    mate = j
                    break
            if mate is not None:
                used[mate] = True
                pairs.append((r, roots[mate]))
            else:
                pairs.append((r, None))
    return pairs


def _zpk_to_sos(z, p, k) -> np.ndarray:
    """Pair conjugate roots into biquad sections (simple pairing)."""
    zp = _pair_roots(list(z))
    pp = _pair_roots(list(p))
    n_sections = max(len(zp), len(pp))
    zp += [(None, None)] * (n_sections - len(zp))
    pp += [(None, None)] * (n_sections - len(pp))

    def poly(rpair):
        a, b = rpair
        if a is None:
            return np.array([1.0, 0.0, 0.0])
        if b is None:
            return np.array([1.0, -a.real, 0.0])
        c = np.real(np.poly([a, b]))
        return np.pad(c, (0, 3 - len(c)))

    sos = []
    for i in range(n_sections):
        b = poly(zp[i])
        a = poly(pp[i])
        if i == 0:
            b = b * k
        sos.append(np.concatenate([b, a]))
    return np.asarray(sos, np.float64)


def _design_iir(kind: str, order: int, cutoff, btype: str,
                ripple_db: float = 1.0) -> np.ndarray:
    """Digital IIR as float32 SOS, each section normalised by a0. cutoff
    in Nyquist units (0, 1); btype lowpass|highpass|bandpass."""
    z = np.array([])
    if kind == "butterworth":
        p = _butter_poles(order)
        k = np.real(np.prod(-p))
    elif kind == "chebyshev1":
        p, k = _cheby1_poles(order, ripple_db)
    elif kind == "chebyshev2":
        # stopband form: transform cheby1 poles/zeros
        eps = 1.0 / np.sqrt(10 ** (ripple_db / 10.0) - 1.0)
        mu = np.arcsinh(1.0 / eps) / order
        kk = np.arange(order)
        theta = np.pi * (2 * kk + 1) / (2 * order)
        p1 = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
        p = 1.0 / p1
        z = 1j / np.cos(theta[np.abs(np.cos(theta)) > 1e-8])
        k = np.real(np.prod(-p) / np.prod(-z))
    elif kind == "bessel":
        p = _bessel_poles(order)
        # normalize to unit -3 dB-ish frequency (scale by |p| geometric mean)
        p = p / np.abs(np.prod(p)) ** (1.0 / order)
        k = np.real(np.prod(-p))
    else:
        raise ValueError(
            f"unsupported IIR family {kind!r} "
            "(available: butterworth, chebyshev1, chebyshev2, bessel)")

    # frequency transform on the analog prototype, with bilinear prewarp
    fs2 = 2.0
    if btype == "lowpass":
        wc = fs2 * np.tan(np.pi * cutoff / 2.0)
        z, p, k = z * wc, p * wc, k * wc ** (len(p) - len(z))
    elif btype == "highpass":
        wc = fs2 * np.tan(np.pi * cutoff / 2.0)
        k = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else (
            k / np.real(np.prod(-p)))
        z, p = wc / z if len(z) else z, wc / p
        z = np.append(z, np.zeros(len(p) - len(z)))
        if kind == "butterworth":
            k = 1.0
    elif btype == "bandpass":
        lo, hi = cutoff
        w1 = fs2 * np.tan(np.pi * lo / 2.0)
        w2 = fs2 * np.tan(np.pi * hi / 2.0)
        bw, w0 = w2 - w1, np.sqrt(w1 * w2)
        degree = len(p) - len(z)
        p = p * bw / 2.0
        z = z * bw / 2.0
        p = np.concatenate([p + np.sqrt(p ** 2 - w0 ** 2),
                            p - np.sqrt(p ** 2 - w0 ** 2)])
        z = np.concatenate([z + np.sqrt(z ** 2 - w0 ** 2),
                            z - np.sqrt(z ** 2 - w0 ** 2)]) if len(z) else z
        z = np.append(z, np.zeros(degree))
        k = k * bw ** degree
    else:
        raise ValueError(f"unsupported btype {btype!r}")

    zd, pd, kd = _zpk_bilinear(z, p, k, fs2)
    sos = _zpk_to_sos(zd, pd, kd)
    sos = sos / sos[:, [3]]
    return sos.astype(np.float32)


def butterworth(order: int, cutoff, btype: str = "lowpass") -> np.ndarray:
    return _design_iir("butterworth", order, cutoff, btype)


def chebyshev1(order: int, cutoff, btype: str = "lowpass",
               ripple_db: float = 1.0) -> np.ndarray:
    return _design_iir("chebyshev1", order, cutoff, btype, ripple_db)


# ---------------------------------------------------------------------------
# IIR application
# ---------------------------------------------------------------------------

SCAN_BELOW = 4096    # sos_apply(method="auto"): the per-sample scan below
SCAN_ROWS = 4096     # samples a per-sample loop takes from the host at once


def sos_array(sos) -> np.ndarray:
    """The sections as an (S, 6) float32 NumPy array of its own."""
    if isinstance(sos, torch.Tensor):
        sos = sos.detach().cpu().numpy()
    return np.array(sos, np.float32).reshape(-1, 6)


def _sos_state_scan(xb: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """The sections over (B, n) by the doubling scan.

    Each section is the affine recurrence s_t = M s_{t-1} + c x_t with
    the constant transition M = [[-a1, 1], [-a2, 0]] and
    c = [b1 - a1 b0, b2 - a2 b0]; then y_t = b0 x_t + s_{t-1}[0]. The
    passes u[t] += M^k u[t-k], k = 1, 2, 4, ... < n, solve it in log2(n)
    elementwise passes; M^k is squared in float64 and rounded to float32
    for each pass, and its 2x2 product is written out as multiply-adds
    (no matrix product, so no TF32)."""
    n = xb.shape[-1]
    y = xb
    for b0, b1, b2, _a0, a1, a2 in np.asarray(sos, np.float64):
        Mk = np.array([[-a1, 1.0], [-a2, 0.0]])
        c = np.array([b1 - a1 * b0, b2 - a2 * b0]).astype(np.float32)
        u0, u1 = y * float(c[0]), y * float(c[1])
        k = 1
        while k < n:
            m = [float(v) for v in Mk.astype(np.float32).reshape(-1)]
            s0, s1 = u0[:, :-k], u1[:, :-k]
            u0 = u0 + F.pad(s0 * m[0] + s1 * m[1], (k, 0))
            u1 = u1 + F.pad(s0 * m[2] + s1 * m[3], (k, 0))
            Mk = Mk @ Mk
            k *= 2
        y = float(np.float32(b0)) * y + F.pad(u0[:, :-1], (1, 0))
    return y


def _section_scan(xt: torch.Tensor, coef: torch.Tensor,
                  d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One section, transposed direct form II, sample by sample.

    ``xt`` is time-major (n, B), ``coef`` the section's six float32
    coefficients on its device, ``d`` the state (2, B) = (d1, d2). Each
    sample: y = b0 x + d1; d1 <- (b1 x - a1 y) + d2; d2 <- b2 x - a2 y,
    vectorised over the batch: three launches and no host sync. The rows
    are taken ``SCAN_ROWS`` at a time by ``unbind`` (cheaper on the host
    than indexing a row a sample). Returns (y (n, B), the final state
    (2, B))."""
    bx = xt[:, None, :] * coef[:3, None]         # (n, 3, B): b0 x, b1 x, b2 x
    na = -coef[4:6, None]                         # (2, 1): -a1, -a2
    y = torch.empty_like(xt)
    d1, d2 = d.unbind(0)
    for s in range(0, xt.shape[0], SCAN_ROWS):
        rows = zip(bx[s:s + SCAN_ROWS, 0].unbind(0),
                   bx[s:s + SCAN_ROWS, 1:].unbind(0),
                   y[s:s + SCAN_ROWS].unbind(0))
        for b0x, b12x, yt in rows:
            torch.add(b0x, d1, out=yt)
            e1, e2 = torch.addcmul(b12x, yt, na).unbind(0)
            d1, d2 = e1.add_(d2), e2
    return y, torch.stack([d1, d2])


def _sos_scan(xb: torch.Tensor, sos: torch.Tensor,
              z: Optional[torch.Tensor] = None):
    """The sections in order over (B, n) from the states ``z`` (S, 2, B),
    zero when None. Returns (y (B, n), the final states (S, 2, B))."""
    xt = xb.t().contiguous()
    if z is None:
        z = xt.new_zeros((sos.shape[0], 2, xt.shape[1]))
    finals = []
    for s in range(sos.shape[0]):
        xt, zs = _section_scan(xt, sos[s], z[s])
        finals.append(zs)
    return xt.t(), torch.stack(finals)


def sos_apply(x, sos, method: str = "auto", *, device=None) -> torch.Tensor:
    """Apply second-order sections (transposed DF-II) along the last axis.

    method='scan'     the per-sample recurrence (the streaming order)
    method='parallel' the doubling scan (the same filter; the float sums
                      are reordered)
    method='auto'     parallel from 4096 samples, scan below
    """
    x = as_signal(x, device)
    if method == "auto":
        method = "parallel" if x.shape[-1] >= SCAN_BELOW else "scan"
    if method not in ("parallel", "scan"):
        raise ValueError(f"unknown method {method!r}")
    squeeze = x.ndim == 1
    xb = x[None, :] if squeeze else x.reshape(-1, x.shape[-1])
    if method == "parallel":
        yb = _sos_state_scan(xb, sos_array(sos))
    else:
        yb = _sos_scan(xb, sections_on(sos, xb.device))[0]
    return yb[0] if squeeze else yb.reshape(x.shape)


@lru_cache(maxsize=64)
def _sections(key: bytes, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(key, np.float32).reshape(-1, 6)
                            .copy()).to(device)


def sections_on(sos, device) -> torch.Tensor:
    """The sections as a float32 (S, 6) tensor on ``device``, uploaded once
    per set of sections and device and cached (an upload from pageable
    memory waits for the device)."""
    return _sections(sos_array(sos).tobytes(), str(torch.device(device)))


def median_filter(x, size: int = 5, *, device=None) -> torch.Tensor:
    """Sliding-window median along the last axis, edge-replicated: the
    middle of a sort of ``size`` shifted slices stacked on a leading
    axis."""
    if size % 2 == 0:
        raise ValueError("median size must be odd")
    x = as_signal(x, device)
    h = size // 2
    n = x.shape[-1]
    edge = x.shape[:-1] + (h,)
    xp = torch.cat([x[..., :1].expand(edge), x, x[..., -1:].expand(edge)],
                   dim=-1)
    stack = torch.stack([xp[..., i:i + n] for i in range(size)])
    return torch.sort(stack, dim=0).values[h]


class IIRFilter:
    """IIR filter from given sections or a design (butterworth,
    chebyshev1, chebyshev2, elliptic, bessel). ``sos`` is the float32
    (S, 6) NumPy array. NumPy input goes to ``device``."""

    def __init__(self, sos=None, *, design: str = "butterworth",
                 order: int = 4, cutoff=0.25, btype: str = "lowpass",
                 ripple_db: float = 1.0, stopband_db: float = 40.0,
                 device="cuda"):
        if sos is None:
            if design == "elliptic":
                from njw_tpu_torch.signal.elliptic import elliptic_sos

                sos = elliptic_sos(order, cutoff, btype, rp=ripple_db,
                                   rs=stopband_db)
            else:
                sos = _design_iir(design, order, cutoff, btype, ripple_db)
        self.sos = sos_array(sos)
        self.device = device

    def apply(self, x) -> torch.Tensor:
        return sos_apply(x, self.sos, device=self.device)

    __call__ = apply

    def frequency_response(self, n_points: int = 512):
        w = np.linspace(0, np.pi, n_points)
        z = np.exp(1j * w)
        H = np.ones_like(z)
        for b0, b1, b2, a0, a1, a2 in self.sos:
            H = H * (b0 + b1 / z + b2 / z ** 2) / (a0 + a1 / z + a2 / z ** 2)
        return w / np.pi, H


class StreamingIIR:
    """SOS cascade over chunks with carried section states (transposed
    DF-II), (S, 2, B): the per-sample function of
    ``sos_apply(method="scan")``, so the chunks' outputs equal the
    one-shot scan's bit for bit. Chunks given as NumPy go to ``device``;
    the sections and the state live there."""

    def __init__(self, sos, batch: int = 1, *, device="cuda"):
        self.device = require_device(device)
        self.sos = sections_on(sos, self.device)
        self.batch = batch
        self.reset()

    def reset(self):
        self._z = torch.zeros((self.sos.shape[0], 2, self.batch),
                              dtype=torch.float32, device=self.device)

    def process(self, chunk) -> torch.Tensor:
        chunk = as_signal(chunk, self.device)
        squeeze = chunk.ndim == 1
        xb = chunk[None, :] if squeeze else chunk
        yb, self._z = _sos_scan(xb, self.sos, self._z)
        return yb[0] if squeeze else yb


# ---------------------------------------------------------------------------
# Adaptive filters
# ---------------------------------------------------------------------------


def adaptive_frames(x: torch.Tensor, L: int) -> torch.Tensor:
    """The (n, L) windows of a 1-D signal, newest first:
    frames[t, j] = x[t - j], zero before the start."""
    return F.pad(x, (L - 1, 0)).unfold(0, L, 1).flip(1)


def _inclusive_scan_maps(A: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps w -> A_i w + b_i, map 0 applied
    first: the i-th result is map i after map i-1 ... after map 0. A
    Hillis-Steele doubling over the stacked maps, one batched product a
    pass."""
    k = 1
    nb = A.shape[0]
    while k < nb:
        b = torch.cat([b[:k], (A[k:] @ b[:-k, :, None])[..., 0] + b[k:]])
        A = torch.cat([A[:k], A[k:] @ A[:-k]])
        k *= 2
    return A, b


def _lms_wy_parallel(frames: torch.Tensor, d: torch.Tensor, mu: float,
                     eps: float, chunk: int, nlms: bool):
    """Exact per-sample LMS/NLMS, in parallel (compact-WY form).

    The per-sample update w_{t+1} = (I - mu_t f_t f_t^T) w_t + mu_t d_t f_t
    is affine in w, and a product of C such rank-1-perturbed identities is
    P = I - X^T T X, T = (I + D S)^{-1} D, with X the chunk's frames
    (C, L), S the strict-lower Gram S[t, i] = f_t . f_i (i < t) and
    D = diag(mu_t). D S is strictly lower triangular (nilpotent), so the
    inverse is the finite Neumann product (I + M)(I + M^2)(I + M^4)...
    with M = -D S. With w the chunk-start weights and a = X w:

        per-sample outputs  y = a - S T (a - d)
        chunk offset        q = X^T T d,   chunk map  A = I - X^T T X

    Three levels: batched products over the chunks, an inclusive scan of
    the chunk maps (``_inclusive_scan_maps``), batched per-sample outputs.
    The same recurrence as the scan engine; only the float summation order
    differs. The caller runs it under ``float32_products`` (no TF32)."""
    n, L = frames.shape
    C = chunk
    nb = -(-n // C)
    pad = nb * C - n
    # zero rows f_t = 0 are exact no-ops for both the weights and y
    X = F.pad(frames, (0, 0, 0, pad)).reshape(nb, C, L)
    dc = F.pad(d, (0, pad)).reshape(nb, C)
    Xt = X.transpose(1, 2)
    G = X @ Xt                                            # Gram
    if nlms:
        den = torch.diagonal(G, dim1=1, dim2=2) + eps
        mu_t = torch.full_like(den, mu) / den
    else:
        mu_t = torch.full((nb, C), mu, dtype=X.dtype, device=X.device)
    S = torch.tril(G, diagonal=-1)
    M = -(mu_t[:, :, None] * S)                           # -D S
    eye_c = torch.eye(C, dtype=X.dtype, device=X.device)
    P = eye_c + M
    Mk = M
    j = 1
    while (1 << j) < C:
        Mk = Mk @ Mk
        P = P @ (eye_c + Mk)
        j += 1
    T = P * mu_t[:, None, :]                              # (I+DS)^-1 D
    A = torch.eye(L, dtype=X.dtype, device=X.device) - Xt @ (T @ X)
    q = (Xt @ (T @ dc[:, :, None]))[..., 0]
    _, bp = _inclusive_scan_maps(A, q)
    # w at each chunk start (w0 = 0): the exclusive prefix offsets
    w_start = torch.cat([bp.new_zeros((1, L)), bp[:-1]])
    a = (X @ w_start[:, :, None])[..., 0]
    r = a - dc
    y = a - (S @ (T @ r[:, :, None]))[..., 0]
    yf = y.reshape(-1)[:n]
    return yf, d - yf, bp[-1]


def _lms_scan(frames, d, mu: float, eps: float, nlms: bool):
    """Per-sample LMS/NLMS: a host loop, no host sync inside."""
    n, L = frames.shape
    w = frames.new_zeros(L)
    y = frames.new_empty(n)
    e = frames.new_empty(n)
    if nlms:
        den = (frames * frames).sum(dim=1) + eps
    for t in range(n):
        f = frames[t]
        yt = torch.dot(w, f, out=y[t])
        et = torch.sub(d[t], yt, out=e[t])
        g = (et * mu) * f
        if nlms:
            g = g / den[t]
        w = w + g
    return y, e, w


def _rls_scan(frames, d, lam: float, eps: float):
    """Per-sample RLS with the (L, L) inverse covariance."""
    n, L = frames.shape
    w = frames.new_zeros(L)
    P = torch.eye(L, dtype=frames.dtype, device=frames.device) / eps
    y = frames.new_empty(n)
    e = frames.new_empty(n)
    for t in range(n):
        f = frames[t]
        Pf = P @ f
        k = Pf / (lam + torch.dot(f, Pf))
        yt = torch.dot(w, f, out=y[t])
        et = torch.sub(d[t], yt, out=e[t])
        w = w + k * et
        P = (P - torch.outer(k, Pf)) / lam
    return y, e, w


def _block_lms(frames, d, mu: float, B: int):
    """Block LMS: the weights move once a block by the block-averaged
    gradient; a ragged tail runs at the final weights."""
    n, L = frames.shape
    nb = n // B
    w = frames.new_zeros(L)
    ys, es = [], []
    fb = frames[:nb * B].reshape(nb, B, L)
    db = d[:nb * B].reshape(nb, B)
    for i in range(nb):
        y = fb[i] @ w
        e = db[i] - y
        w = w + (mu / B) * (e @ fb[i])
        ys.append(y)
        es.append(e)
    if nb * B < n:                                 # ragged tail, frozen w
        yt = frames[nb * B:] @ w
        ys.append(yt)
        es.append(d[nb * B:] - yt)
    return torch.cat(ys), torch.cat(es), w


class AdaptiveFilter:
    """method='lms'/'nlms'/'rls': per-sample adaptation.
    method='block_lms': the weights update once per ``block_size``
    samples with the block-averaged gradient.

    engine='parallel' (the default for lms/nlms from 1024 samples)
    evaluates the per-sample recurrence exactly by chunked compact-WY
    affine maps (``_lms_wy_parallel``); engine='scan' runs it sample by
    sample (RLS always: its covariance update is not affine in the
    state). NumPy input goes to ``device``."""

    def __init__(self, num_taps: int = 32, method: str = "lms",
                 mu: float = 0.01, eps: float = 1e-6,
                 forgetting: float = 0.99, block_size: int = 256,
                 engine: str = "auto", chunk: int = 128, device="cuda"):
        self.num_taps = num_taps
        self.method = method
        self.mu = mu
        self.eps = eps
        self.forgetting = forgetting
        self.block_size = block_size
        self.engine = engine
        self.chunk = chunk
        self.device = device

    def apply(self, x, d):
        """Adapt so that y = w . x_window tracks d. Returns (y, e, w_final)."""
        x = as_signal(x, self.device)
        d = as_signal(d, x.device)
        frames = adaptive_frames(x, self.num_taps)
        with float32_products():
            if self.method == "block_lms":
                return _block_lms(frames, d, self.mu, self.block_size)
            if self.method in ("lms", "nlms"):
                nlms = self.method == "nlms"
                engine = self.engine
                if engine == "auto":
                    engine = "parallel" if x.shape[0] >= 1024 else "scan"
                if engine == "parallel":
                    return _lms_wy_parallel(frames, d, self.mu, self.eps,
                                            self.chunk, nlms)
                return _lms_scan(frames, d, self.mu, self.eps, nlms)
            if self.method == "rls":
                return _rls_scan(frames, d, self.forgetting, self.eps)
        raise ValueError(f"unknown adaptive method {self.method!r}")
