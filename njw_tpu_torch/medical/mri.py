"""MRI reconstruction: Cartesian and non-Cartesian, iterative, parallel
imaging, partial Fourier.

Counterpart of ``njw_tpu/medical/mri.py``:

* ``reconstruct_kspace``       centred inverse 2-D FFT (cuFFT);
* ``grid_noncartesian``        bilinear gridding;
* ``gridding_reconstruct``     Kaiser-Bessel convolution gridding with
  Pipe-Menon density compensation and deapodization;
* ``reconstruct_cg``           CG-SENSE on (multi-coil) Cartesian k-space;
* ``reconstruct_primal_dual``  TV-regularised Chambolle-Pock;
* ``reconstruct_compressed_sensing``  FISTA with Haar soft thresholds;
* ``reconstruct_partial_fourier``     homodyne reconstruction;
* ``MRIReconstructor``         the class facade.

The scatter-adds of gridding are one ``index_add_`` of all kernel taps
over a flat index, on the real and imaginary parts as float pairs; on the
CPU it adds in the taps' order, as XLA's sequential scatters do, and on
CUDA by atomics in no fixed order. The iterative solvers run a fixed
count of host iterations with no host read (their state lives on the
device: CG's step sizes, FISTA's t), so a whole solve can be captured in
a CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.platform.tensors import (
    as_complex, as_tensor, device_of,
)

_SQRT2 = float(np.sqrt(np.float32(2.0)))   # jnp.sqrt(2.0) in float32


def reconstruct_kspace(kspace, *, device=None):
    """Cartesian: centred inverse 2-D FFT -> magnitude image (k-space
    centred, DC in the middle)."""
    k = as_complex(kspace, device)
    img = torch.fft.ifft2(torch.fft.ifftshift(k, dim=(-2, -1)))
    return torch.abs(img)


def _ifft_c(k):
    """Centred unitary inverse FFT (complex output)."""
    return torch.fft.ifft2(torch.fft.ifftshift(k, dim=(-2, -1)),
                           norm="ortho")


def _fft_c(img):
    """Centred unitary forward FFT."""
    return torch.fft.fftshift(torch.fft.fft2(img, norm="ortho"),
                              dim=(-2, -1))


def _scatter_add(n_cells: int, idx, vals):
    """A flat grid of n_cells with vals added at idx (complex values as
    float pairs)."""
    if vals.is_complex():
        out = torch.zeros((n_cells, 2), dtype=torch.float32,
                          device=vals.device)
        out.index_add_(0, idx, torch.view_as_real(vals))
        return torch.view_as_complex(out)
    out = torch.zeros(n_cells, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def _samples(samples, device):
    """JAX's asarray: complex input complex64, real input float32."""
    if isinstance(samples, torch.Tensor):
        return samples.to(torch.complex64 if samples.is_complex()
                          else torch.float32)
    if np.iscomplexobj(samples):
        return as_complex(samples, device)
    return as_tensor(samples, device)


def grid_noncartesian(samples, coords, grid_size: int,
                      oversampling: float = 1.0, *, device=None):
    """Bilinear-gridded recon. samples: (M,) complex; coords: (M, 2) in
    [-0.5, 0.5) k-space units (corner-phase convention)."""
    dev = device_of(samples, coords, device=device)
    samples = _samples(samples, dev)
    coords = as_tensor(coords, dev)
    n = int(grid_size * oversampling)
    pos = (coords + 0.5) * (n - 1)
    p0 = torch.floor(pos).long()
    frac = pos - p0
    idx, vals, wts = [], [], []
    for dy in (0, 1):
        for dx in (0, 1):
            w = ((1 - frac[:, 0] if dy == 0 else frac[:, 0])
                 * (1 - frac[:, 1] if dx == 0 else frac[:, 1]))
            yy = (p0[:, 0] + dy).clamp(0, n - 1)
            xx = (p0[:, 1] + dx).clamp(0, n - 1)
            idx.append(yy * n + xx)
            vals.append(samples * w)
            wts.append(w)
    idx = torch.cat(idx)
    grid = _scatter_add(n * n, idx, torch.cat(vals)).reshape(n, n)
    weight = _scatter_add(n * n, idx, torch.cat(wts)).reshape(n, n)
    grid = grid / torch.clamp_min(weight, 1e-6)
    img = reconstruct_kspace(grid)
    if n != grid_size:
        c = (n - grid_size) // 2
        img = img[c:c + grid_size, c:c + grid_size]
    return img


# ---------------------------------------------------------------------------
# Kaiser-Bessel convolution gridding (the standard NUFFT adjoint).
# ---------------------------------------------------------------------------

def _kb_beta(width: int, oversampling: float) -> float:
    """Beatty et al. (2005) optimal Kaiser-Bessel shape parameter."""
    w, os = float(width), float(oversampling)
    return float(np.pi * np.sqrt((w / os * (os - 0.5)) ** 2 - 0.8))


def _kb_kernel(r, width: int, beta: float):
    """Kaiser-Bessel kernel value at |r| (grid units), support |r|<=w/2."""
    x = torch.clamp_min(1.0 - (2.0 * r / width) ** 2, 0.0)
    val = torch.special.i0(beta * torch.sqrt(x))
    i0_beta = torch.special.i0(torch.full((), beta, dtype=torch.float32,
                                          device=r.device))
    return torch.where(torch.abs(r) <= width / 2.0, val, 0.0) / i0_beta


def _kb_apodization(n: int, width: int, beta: float) -> np.ndarray:
    """Image-space apodization of the KB kernel (1-D, length n): the
    analytic Fourier transform sinh(sqrt(b^2-(pi w u)^2))/sqrt(...)."""
    u = (np.arange(n) - n / 2) / n  # cycles/sample
    arg = beta ** 2 - (np.pi * width * u) ** 2
    s = np.sqrt(np.abs(arg))
    ap = np.where(arg > 0, np.sinh(s) / np.maximum(s, 1e-12),
                  np.sinc(s / np.pi))
    return (ap / ap.max()).astype(np.float32)


def _kb_taps(coords, n: int, width: int, beta: float):
    """[(flat index, weight)] of the width^2 kernel taps, (oy, ox) in
    row-major order, each over all M samples."""
    pos = (coords + 0.5) * n  # grid units
    base = torch.floor(pos - width / 2.0 + 0.5).long()
    taps = []
    for oy in range(width):
        yy = base[:, 0] + oy
        wy = _kb_kernel(yy.to(torch.float32) - pos[:, 0], width, beta)
        yc = torch.remainder(yy, n)
        for ox in range(width):
            xx = base[:, 1] + ox
            wx = _kb_kernel(xx.to(torch.float32) - pos[:, 1], width, beta)
            taps.append((yc * n + torch.remainder(xx, n), wy * wx))
    return taps


def _kb_grid(samples, coords, weights, n: int, width: int, beta: float):
    """Scatter weighted samples onto an (n, n) grid with the KB kernel;
    coords in [-0.5, 0.5). Returns complex (n, n)."""
    vals = samples * weights
    taps = _kb_taps(coords, n, width, beta)
    idx = torch.cat([i for i, _ in taps])
    return _scatter_add(n * n, idx, torch.cat([vals * w for _, w in taps])
                        ).reshape(n, n)


def _kb_degrid(grid, coords, n: int, width: int, beta: float):
    """Interpolate grid values at scattered coords, the adjoint of
    _kb_grid: (M,) complex, the taps added in turn."""
    flat = grid.reshape(-1)
    out = torch.zeros(coords.shape[0], dtype=torch.complex64,
                      device=grid.device)
    for i, w in _kb_taps(coords, n, width, beta):
        out = out + flat[i] * w
    return out


def pipe_menon_dcf(coords, grid_size: int, *, oversampling: float = 2.0,
                   width: int = 4, n_iterations: int = 10, device=None):
    """Pipe-Menon density compensation: w <- w / (G^H G w), n_iterations
    times. Returns (M,) float32 weights."""
    coords = as_tensor(coords, device)
    n = int(grid_size * oversampling)
    beta = _kb_beta(width, oversampling)
    m = coords.shape[0]
    ones = torch.ones(m, dtype=torch.float32, device=coords.device)
    w = ones
    for _ in range(n_iterations):
        g = _kb_grid(w.to(torch.complex64), coords, ones, n, width, beta)
        conv = torch.real(_kb_degrid(g, coords, n, width, beta))
        w = w / torch.clamp_min(conv, 1e-8)
    return w


def gridding_reconstruct(samples, coords, grid_size: int, *,
                         oversampling: float = 2.0, width: int = 4,
                         dcf=None, device=None):
    """Non-Cartesian recon: KB convolution gridding with density
    compensation (Pipe-Menon where dcf is None) and deapodization.
    samples: (M,) complex; coords: (M, 2) in [-0.5, 0.5)."""
    dev = device_of(samples, coords, device=device)
    coords = as_tensor(coords, dev)
    n = int(grid_size * oversampling)
    beta = _kb_beta(width, oversampling)
    if dcf is None:
        dcf = pipe_menon_dcf(coords, grid_size, oversampling=oversampling,
                             width=width)
    grid = _kb_grid(as_complex(samples, dev), coords, as_tensor(dcf, dev),
                    n, width, beta)
    # centred IDFT: sample phases are relative to the image centre
    img = torch.fft.fftshift(_ifft_c(grid), dim=(-2, -1))
    ap = _kb_apodization(n, width, beta)
    img = img / torch.from_numpy(np.outer(ap, ap)).to(dev)
    c = (n - grid_size) // 2
    img = img[c:c + grid_size, c:c + grid_size]
    scale = torch.max(torch.abs(img))
    return torch.abs(img) / torch.clamp_min(scale, 1e-12) * scale


# ---------------------------------------------------------------------------
# CG-SENSE: iterative parallel-imaging recon on Cartesian k-space.
# ---------------------------------------------------------------------------

def _sense_forward(x, mask, sens):
    """A x: coil-wise FFT of the sens-weighted image, masked."""
    return mask[None] * _fft_c(sens * x[None])


def _sense_adjoint(y, mask, sens):
    """A^H y: sum of conj(sens) * IFFT of the masked coil k-space."""
    return torch.sum(torch.conj(sens) * _ifft_c(mask[None] * y), dim=0)


def _vdot_re(a, b):
    return torch.real(torch.vdot(a.reshape(-1), b.reshape(-1)))


def _cg_solve(rhs, mask, sens, lam, num_iterations: int):
    def normal_op(x):
        return _sense_adjoint(_sense_forward(x, mask, sens), mask, sens) \
            + lam * x

    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs = _vdot_re(rhs, rhs)
    for _ in range(num_iterations):
        ap = normal_op(p)
        alpha = rs / torch.clamp_min(_vdot_re(p, ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot_re(r, r)
        p = r + (rs_new / torch.clamp_min(rs, 1e-20)) * p
        rs = rs_new
    return x


def _mask_for(y, mask):
    if mask is None:
        return (torch.abs(y) > 0).to(torch.float32)
    return as_tensor(mask, y.device)


def reconstruct_cg(kspace, mask=None, sensitivity_maps=None, *,
                   num_iterations: int = 10, lam: float = 0.0, device=None):
    """CG-SENSE (Pruessmann et al. 2001): solve (A^H A + lam I) x = A^H y.
    kspace: (ny, nx) or (C, ny, nx) complex, centred, zeros where not
    sampled; mask: (ny, nx) (from the nonzeros where None);
    sensitivity_maps: (C, ny, nx) (uniform where None)."""
    y = as_complex(kspace, device)
    if y.ndim == 2:
        y = y[None]
    c, ny, nx = y.shape
    if mask is None:
        mask = (torch.abs(y).sum(dim=0) > 0).to(torch.float32)
    else:
        mask = as_tensor(mask, y.device)
    if sensitivity_maps is None:
        sens = torch.ones((c, ny, nx), dtype=torch.complex64,
                          device=y.device) / np.sqrt(c)
    else:
        sens = as_complex(sensitivity_maps, y.device)
    rhs = _sense_adjoint(y, mask, sens)
    lam_t = torch.full((), lam, dtype=torch.float32, device=y.device)
    return torch.abs(_cg_solve(rhs, mask, sens, lam_t, num_iterations))


# ---------------------------------------------------------------------------
# TV-regularised primal-dual (Chambolle-Pock).
# ---------------------------------------------------------------------------

def _grad2d(x):
    gx = torch.roll(x, -1, dims=-1) - x
    gy = torch.roll(x, -1, dims=-2) - x
    return torch.stack([gy, gx])


def _div2d(g):
    gy, gx = g[0], g[1]
    return (gy - torch.roll(gy, 1, dims=-2)) + (gx - torch.roll(gx, 1,
                                                                dims=-1))


def _pd_solve(y, mask, weight, num_iterations: int):
    tau, sigma = 0.25, 0.5
    x = _ifft_c(y)
    xbar = x
    p = torch.zeros((2,) + tuple(y.shape), dtype=x.dtype, device=x.device)
    q = torch.zeros_like(y)
    for _ in range(num_iterations):
        # dual ascent: TV dual p (pointwise projection), data dual q
        p = p + sigma * _grad2d(xbar)
        pn = torch.sqrt(torch.sum(torch.abs(p) ** 2, dim=0, keepdim=True))
        p = p / torch.clamp_min(pn / weight, 1.0)
        q = (q + sigma * (mask * _fft_c(xbar) - y)) / (1.0 + sigma)
        # primal descent
        x_new = x + tau * _div2d(p) - tau * _ifft_c(mask * q)
        xbar = 2.0 * x_new - x
        x = x_new
    return x


def reconstruct_primal_dual(kspace, mask=None, *, num_iterations: int = 50,
                            tv_weight: float = 0.05, device=None):
    """TV-regularised recon by Chambolle-Pock:
    min_x ||M F x - y||^2 / 2 + w TV(x)."""
    y = as_complex(kspace, device)
    mask = _mask_for(y, mask)
    w = torch.full((), tv_weight, dtype=torch.float32, device=y.device)
    return torch.abs(_pd_solve(y, mask, w, num_iterations))


# ---------------------------------------------------------------------------
# Compressed sensing: FISTA with orthogonal Haar-wavelet soft threshold.
# ---------------------------------------------------------------------------

def _haar2_fwd(x, levels: int):
    coeffs = []
    a = x
    for _ in range(levels):
        lo = (a[..., ::2] + a[..., 1::2]) / _SQRT2
        hi = (a[..., ::2] - a[..., 1::2]) / _SQRT2
        ll = (lo[..., ::2, :] + lo[..., 1::2, :]) / _SQRT2
        lh = (lo[..., ::2, :] - lo[..., 1::2, :]) / _SQRT2
        hl = (hi[..., ::2, :] + hi[..., 1::2, :]) / _SQRT2
        hh = (hi[..., ::2, :] - hi[..., 1::2, :]) / _SQRT2
        coeffs.append((lh, hl, hh))
        a = ll
    return a, coeffs


def _haar2_inv(a, coeffs):
    for lh, hl, hh in reversed(coeffs):
        ll = a
        lo = torch.stack([(ll + lh) / _SQRT2, (ll - lh) / _SQRT2], dim=-2)
        lo = lo.reshape(ll.shape[:-2] + (ll.shape[-2] * 2, ll.shape[-1]))
        hi = torch.stack([(hl + hh) / _SQRT2, (hl - hh) / _SQRT2], dim=-2)
        hi = hi.reshape(lo.shape)
        a = torch.stack([(lo + hi) / _SQRT2, (lo - hi) / _SQRT2], dim=-1)
        a = a.reshape(lo.shape[:-1] + (lo.shape[-1] * 2,))
    return a


def _soft(z, t):
    mag = torch.abs(z)
    return z * torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag, 1e-12)


def _fista_solve(y, mask, lam, num_iterations: int, levels: int):
    def prox(x, t):
        a, cs = _haar2_fwd(x, levels)
        cs = [tuple(_soft(c, t) for c in band) for band in cs]
        return _haar2_inv(a, cs)   # approximation band left unthresholded

    def grad(x):
        return _ifft_c(mask * (mask * _fft_c(x) - y))

    x = _ifft_c(y)
    z = x
    t = torch.ones((), dtype=torch.float32, device=y.device)
    for _ in range(num_iterations):
        x_new = prox(z - grad(z), lam)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def reconstruct_compressed_sensing(kspace, mask=None, *,
                                   num_iterations: int = 30,
                                   lam: float = 0.02, levels: int = 3,
                                   device=None):
    """CS recon: FISTA on min ||M F x - y||^2 / 2 + lam ||W x||_1 with an
    orthogonal Haar wavelet W."""
    y = as_complex(kspace, device)
    mask = _mask_for(y, mask)
    n = y.shape[-1]
    levels = min(levels, int(np.log2(n)) - 2)
    lam_t = torch.full((), lam, dtype=torch.float32, device=y.device)
    return torch.abs(_fista_solve(y, mask, lam_t, num_iterations, levels))


# ---------------------------------------------------------------------------
# Partial Fourier: homodyne reconstruction.
# ---------------------------------------------------------------------------

def reconstruct_partial_fourier(kspace, fraction: float, *,
                                transition: int = 8, device=None):
    """Homodyne recon of partial-Fourier k-space (fraction in (0.5, 1]):
    rows ky >= fraction * ny unacquired (zero); returns the real-part
    magnitude image (Noll et al. 1991)."""
    y = as_complex(kspace, device)
    ny = y.shape[-2]
    n_acq = int(round(fraction * ny))
    center = ny // 2
    k0 = n_acq - 1 - center     # symmetric half-width beyond DC

    ky = torch.arange(ny, dtype=torch.float32,
                      device=y.device)[:, None] - center
    # low-pass window for the phase estimate: the band |ky| <= k0, Hamming
    lp = (torch.abs(ky) <= k0).to(torch.float32)
    lp = lp * (0.54 + 0.46 * torch.cos(np.pi * ky / max(k0, 1)))
    # homodyne pre-weighting: 2 where the conjugate partner is missing,
    # 1 at DC, 0 at the acquisition edge
    w = torch.clamp(1.0 - ky / max(k0, 1), 0.0, 2.0)
    w = torch.where(ky + center >= n_acq, 0.0, w)

    phase_img = _ifft_c(y * lp)
    phase = torch.exp(-1j * torch.angle(phase_img))
    img = _ifft_c(y * w)
    return torch.abs(torch.real(img * phase))


# ---------------------------------------------------------------------------
# Facade.
# ---------------------------------------------------------------------------

class MRIReconstructor:
    """The reconstructor class: method / num_iterations /
    acceleration_factor / sensitivity_maps as attributes; process(kspace)
    dispatches to the functions above. NumPy input goes to ``device``."""

    METHODS = ("fft", "cg_sense", "iterative_primal_dual",
               "compressed_sensing", "partial_fourier")

    def __init__(self, method: str = "iterative_primal_dual",
                 num_iterations: int = 10, acceleration_factor: int = 1,
                 sensitivity_maps=None, device="cuda"):
        self.method = method
        self.num_iterations = num_iterations
        self.acceleration_factor = acceleration_factor
        self.sensitivity_maps = sensitivity_maps
        self.device = device

    def undersampling_mask(self, ny: int, nx: int, *,
                           center_fraction: float = 0.08):
        """Equispaced ky undersampling at the acceleration factor, with a
        fully sampled centre band."""
        r = max(int(self.acceleration_factor), 1)
        mask = np.zeros((ny, nx), np.float32)
        mask[::r, :] = 1.0
        c = int(ny * center_fraction / 2)
        mask[ny // 2 - c:ny // 2 + c, :] = 1.0
        return as_tensor(mask, self.device)

    def process(self, kspace, mask=None, **kw):
        m = self.method
        dev = device_of(kspace, device=self.device)
        if m == "fft":
            return reconstruct_kspace(kspace, device=dev)
        if m == "cg_sense":
            return reconstruct_cg(
                kspace, mask, self.sensitivity_maps,
                num_iterations=self.num_iterations, device=dev, **kw)
        if m == "iterative_primal_dual":
            return reconstruct_primal_dual(
                kspace, mask, num_iterations=max(self.num_iterations, 30),
                device=dev, **kw)
        if m == "compressed_sensing":
            return reconstruct_compressed_sensing(
                kspace, mask, num_iterations=max(self.num_iterations, 20),
                device=dev, **kw)
        if m == "partial_fourier":
            return reconstruct_partial_fourier(kspace, device=dev, **kw)
        if m == "deep_learning":
            raise NotImplementedError(
                "deep-learning recon needs trained weights; the reference "
                "declares the name but ships no model either: use "
                "cg_sense / iterative_primal_dual")
        raise ValueError(f"unknown method {m!r}; available: {self.METHODS}")

