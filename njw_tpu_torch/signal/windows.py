"""Window functions, in NumPy.

Counterpart of ``njw_tpu/signal/windows.py``, kept as the port's own copy
(the port imports nothing of the JAX package). Windows are small static
arrays keyed by (name, n); the filter designers read them with NumPy and
hand the taps to the device once.
"""
from __future__ import annotations

import numpy as np


def _rectangular(n):
    return np.ones(n, np.float32)


def _hann(n):
    k = np.arange(n, dtype=np.float32)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))


def _hamming(n):
    k = np.arange(n, dtype=np.float32)
    return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))


def _blackman(n):
    k = np.arange(n, dtype=np.float32)
    x = 2 * np.pi * k / (n - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)


def _blackman_harris(n):
    k = np.arange(n, dtype=np.float32)
    x = 2 * np.pi * k / (n - 1)
    return (0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
            - 0.01168 * np.cos(3 * x))


def _bartlett(n):
    k = np.arange(n, dtype=np.float32)
    return 1.0 - np.abs((k - (n - 1) / 2) / ((n - 1) / 2))


def _flattop(n):
    k = np.arange(n, dtype=np.float32)
    x = 2 * np.pi * k / (n - 1)
    return (0.21557895 - 0.41663158 * np.cos(x) + 0.277263158 * np.cos(2 * x)
            - 0.083578947 * np.cos(3 * x) + 0.006947368 * np.cos(4 * x))


def _kaiser(n, beta=8.6):
    k = np.arange(n, dtype=np.float32)
    x = beta * np.sqrt(1.0 - ((2 * k / (n - 1)) - 1.0) ** 2)
    return _i0(x) / _i0(np.asarray(beta, np.float32))


def _i0(x):
    """Modified Bessel I0 via its power series (converged for |x|<~20)."""
    x = np.asarray(x, np.float32)
    half2 = (x / 2.0) ** 2
    term = np.ones_like(x)
    total = np.ones_like(x)
    for k in range(1, 25):
        term = term * half2 / (k * k)
        total = total + term
    return total


WINDOWS = {
    "rectangular": _rectangular,
    "boxcar": _rectangular,
    "hann": _hann,
    "hanning": _hann,
    "hamming": _hamming,
    "blackman": _blackman,
    "blackman_harris": _blackman_harris,
    "bartlett": _bartlett,
    "flattop": _flattop,
    "kaiser": _kaiser,
}


def get_window(name: str, n: int, **kwargs) -> np.ndarray:
    try:
        return WINDOWS[name](n, **kwargs)
    except KeyError:
        raise ValueError(
            f"unknown window {name!r}; available: {sorted(set(WINDOWS))}"
        ) from None
