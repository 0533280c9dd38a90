"""Spectral Poisson and Helmholtz solves on periodic grids.

Counterpart of ``njw_tpu/ops/spectral.py``. The wavenumbers whose symbol
matches the 5-point finite-difference Laplacian (``kind='laplacian5'``)
make the spectral inversion and the stencils of the barotropic core
consistent. The transforms are ``torch.fft.fft2`` / ``ifft2`` in
complex64 (cuFFT on the card), as the JAX package leaves them to XLA's
FFT: they are library calls, not kernels of this package.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device


@lru_cache(maxsize=64)
def _fd_wavenumbers_np(n: int, d: float, kind: str) -> np.ndarray:
    """Effective wavenumbers for a length-n periodic axis, float32.

    kind='spectral'  : exact k = 2 pi m / (n d)
    kind='central'   : sin(k d)/d, the central difference's symbol
    kind='laplacian5': 2(1 - cos(k d))/d^2, the 3-point second
                       difference's symbol (returned as k^2)
    """
    k = 2.0 * np.pi * np.fft.fftfreq(n, d=d)
    if kind == "spectral":
        out = k
    elif kind == "central":
        out = np.sin(k * d) / d
    elif kind == "laplacian5":
        out = 2.0 * (1.0 - np.cos(k * d)) / (d * d)
    else:
        raise ValueError(kind)
    return out.astype(np.float32)


def fd_wavenumbers(n: int, d: float, kind: str = "central",
                   device="cuda") -> torch.Tensor:
    """``_fd_wavenumbers_np`` as a tensor on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    return torch.from_numpy(_fd_wavenumbers_np(n, float(d), kind)).to(
        require_device(device))


@lru_cache(maxsize=16)
def _denominator(ny: int, nx: int, dx: float, dy: float, alpha: float,
                 beta: float, kind: str, device: str) -> torch.Tensor:
    """beta - alpha (kx^2 + ky^2), computed in float32 and held as
    complex64 (the type the division promotes it to, as in the JAX
    package), (ny, nx), with the singular k = 0 entry set to 1 for the
    Poisson case (beta = 0). Cached per shape and device, so that a solve
    neither rebuilds nor converts it."""
    kx2 = fd_wavenumbers(nx, dx, kind, device)[None, :]
    ky2 = fd_wavenumbers(ny, dy, kind, device)[:, None]
    if kind != "laplacian5":
        kx2, ky2 = kx2 * kx2, ky2 * ky2
    denom = beta - alpha * (kx2 + ky2)  # the Laplacian's symbol is -(k^2)
    if beta == 0.0:
        denom[0, 0] = 1.0
    return denom.to(torch.complex64)


def helmholtz_solve(rhs: torch.Tensor, dx: float, dy: float, alpha=1.0,
                    beta=1.0, kind: str = "laplacian5") -> torch.Tensor:
    """Solve (beta + alpha Laplacian) phi = rhs on a periodic grid.

    With beta = 0 (Poisson) the k = 0 mode is set to zero (zero-mean
    gauge), as in the JAX package. Returns a contiguous tensor of
    ``rhs``'s dtype."""
    ny, nx = rhs.shape[-2:]
    denom = _denominator(ny, nx, float(dx), float(dy), float(alpha),
                         float(beta), kind, str(rhs.device))
    phi_hat = torch.fft.fft2(rhs) / denom
    if beta == 0.0:
        phi_hat[..., 0, 0].zero_()  # a fill on the device, no host copy
    return torch.fft.ifft2(phi_hat).real.to(rhs.dtype).contiguous()


def poisson_solve(rhs: torch.Tensor, dx: float, dy: float,
                  kind: str = "laplacian5") -> torch.Tensor:
    """Solve Laplacian(phi) = rhs, periodic, zero-mean."""
    return helmholtz_solve(rhs, dx, dy, alpha=1.0, beta=0.0, kind=kind)
