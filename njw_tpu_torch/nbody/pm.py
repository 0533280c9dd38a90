"""Particle-mesh (PM) and P3M gravity for N >> 10^5.

Counterpart of ``njw_tpu/nbody/pm.py``: deposit the masses on a periodic
mesh (cloud in cell), solve Poisson's equation in k-space, difference or
differentiate the potential spectrally, and interpolate the field back to
the particles. P3M smears the mesh mass with a Gaussian and restores the
short range with the exact erfc-screened pair force over the MD cell
list's neighbours (``njw_tpu_torch.md.neighbors``).

Two points where PyTorch needs care:

* Every inverse real transform goes through ``_irfftn``: a complex
  inverse over the first two axes, the imaginary parts of the last axis's
  bins 0 and mesh/2 set to 0, then a C2R transform over the last axis.
  That is what the JAX package's transform computes on the CPU
  (pocketfft), and P3M's spectral gradient ``-1j k phi_k`` is not
  Hermitian at those bins, where cuFFT's C2R leaves the result undefined.
* The deposit adds with ``index_add_``: in index order on the CPU, by
  atomics in no fixed order on the card, so the card agrees with the CPU
  to rounding, not to bits.
"""
from __future__ import annotations

import math

import torch


def _cic_weights(pos, mesh: int, box: float):
    """Cloud-in-cell base cells and weights; pos (N, 3) in [0, box)."""
    x = pos * (mesh / box)
    i0 = torch.floor(x - 0.5)               # the cell whose centre is left
    f = x - 0.5 - i0                        # in [0, 1)
    return i0.to(torch.int64), f


def _corners(pos, mesh: int, box: float):
    """The 8 (flat mesh index, wx, wy, wz) of each particle, in the JAX
    package's order (dx, then dy, then dz)."""
    i0, f = _cic_weights(pos, mesh, box)
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        ix = torch.remainder(i0[:, 0] + dx, mesh)
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            iy = torch.remainder(i0[:, 1] + dy, mesh)
            for dz in (0, 1):
                wz = (1.0 - f[:, 2]) if dz == 0 else f[:, 2]
                iz = torch.remainder(i0[:, 2] + dz, mesh)
                yield (ix * mesh + iy) * mesh + iz, wx, wy, wz


def cic_deposit(pos, mass, mesh: int, box: float):
    """(N, 3) positions and (N,) masses to an (M, M, M) mass grid."""
    rho = torch.zeros(mesh ** 3, dtype=torch.float32, device=pos.device)
    for flat, wx, wy, wz in _corners(pos, mesh, box):
        rho.index_add_(0, flat, mass * wx * wy * wz)
    return rho.view(mesh, mesh, mesh)


def cic_gather(field, pos, mesh: int, box: float):
    """Trilinear interpolation of an (M, M, M) or (C, M, M, M) field at
    pos: (N,) or (C, N)."""
    flat_field = field.reshape(*field.shape[:-3], mesh ** 3)
    out = 0.0
    for flat, wx, wy, wz in _corners(pos, mesh, box):
        out = out + flat_field[..., flat] * (wx * wy * wz)
    return out


def _irfftn(x, mesh: int):
    """The inverse of ``rfftn`` over the last three axes, computed as the
    JAX package's CPU transform does for any input (see the module
    docstring)."""
    y = torch.fft.ifftn(x, dim=(-3, -2))
    y[..., 0] = y[..., 0].real
    y[..., mesh // 2] = y[..., mesh // 2].real
    return torch.fft.irfft(y, n=mesh, dim=-1)


def _wavenumbers(mesh: int, h: float, device):
    """(kx, ky, kz) broadcastable to the rfft grid (M, M, M/2 + 1)."""
    k1 = 2.0 * math.pi * torch.fft.fftfreq(mesh, d=h, device=device)
    kz = torch.fft.rfftfreq(mesh, d=h, device=device) * 2.0 * math.pi
    return k1[:, None, None], k1[None, :, None], kz[None, None, :]


def _density_k(pos, mass, mesh: int, box: float):
    """Wrapped positions, float32 masses, the mesh spacing, the density's
    transform and the wavenumbers."""
    pos = torch.remainder(pos.to(torch.float32), box)
    mass = mass.to(torch.float32)
    h = box / mesh
    rho = cic_deposit(pos, mass, mesh, box) / (h ** 3)
    return pos, mass, h, torch.fft.rfftn(rho), _wavenumbers(mesh, h,
                                                            pos.device)


def _potential(pos, mass, mesh: int, box: float, G):
    """phi on the mesh: phi_k = -4 pi G rho_k / k^2, the mean mode 0."""
    pos, mass, h, rho_k, (kx, ky, kz) = _density_k(pos, mass, mesh, box)
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    phi_k = torch.where(k2 > 0, -4.0 * math.pi * G * rho_k / k2, 0.0)
    return pos, mass, h, _irfftn(phi_k, mesh)


def pm_accelerations(pos, mass, *, mesh: int = 64, box: float = 1.0,
                     G: float = 1.0):
    """PM gravitational accelerations (N, 3) for periodic positions."""
    pos, _, h, phi = _potential(pos, mass, mesh, box, G)

    def grad(axis):
        return (torch.roll(phi, -1, axis) - torch.roll(phi, 1, axis)) / (2 * h)

    gfield = torch.stack([-grad(0), -grad(1), -grad(2)])   # (3, M, M, M)
    return cic_gather(gfield, pos, mesh, box).T


def pm_potential_energy(pos, mass, *, mesh: int = 64, box: float = 1.0,
                        G: float = 1.0):
    """Total PM potential energy (for conservation diagnostics)."""
    pos, mass, _, phi = _potential(pos, mass, mesh, box, G)
    return 0.5 * (mass * cic_gather(phi, pos, mesh, box)).sum()


def _short_range_accel(pos, mass, box: float, alpha: float, r_cut: float,
                       G, nc, capacity: int):
    """erfc-screened direct pair accelerations over the 27 neighbouring
    cells:
    a_i = G sum_j m_j [erfc(a r)/r^2 + 2a/sqrt(pi) exp(-a^2 r^2)/r] r_ij/r
    (NaN on a cell past its capacity)."""
    from njw_tpu_torch.md.neighbors import (
        build_cell_table, neighbor_candidates,
    )

    n = pos.shape[0]
    dev = pos.device
    box3 = torch.full((3,), box, dtype=torch.float32, device=dev)
    table, coords, occ = build_cell_table(pos, box3, nc, capacity)
    cand = neighbor_candidates(table, coords, nc)        # (N, M)

    pos_pad = torch.cat([pos, torch.full((1, 3), 1e9, device=dev)])
    mass_pad = torch.cat([mass, torch.zeros(1, device=dev)])

    d = pos_pad[cand] - pos[:, None, :]
    d = d - box * torch.round(d / box)                   # minimum image
    r2 = (d * d).sum(-1)
    i_idx = torch.arange(n, device=dev)[:, None]
    mask = (cand != n) & (cand != i_idx) & (r2 < r_cut * r_cut)
    r2 = torch.where(mask, r2, 1.0)
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    kernel = (torch.special.erfc(alpha * r) * inv_r
              + (2.0 * alpha / math.sqrt(math.pi))
              * torch.exp(-(alpha * r) ** 2)) * (inv_r * inv_r)
    w = torch.where(mask, mass_pad[cand] * kernel, 0.0)  # (N, M)
    acc = G * (w[..., None] * d).sum(1)                  # toward neighbours
    return torch.where(occ <= capacity, 1.0, math.nan) * acc


def _sinc(x):
    """sin(x) / x, 1 at 0: the unnormalised sinc (``torch.sinc`` is the
    normalised one)."""
    big = torch.abs(x) > 1e-8
    return torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0)


def p3m_accelerations(pos, mass, *, mesh: int = 64, box: float = 1.0,
                      G=1.0, alpha: float = 0.0, r_cut: float = 0.0):
    """P3M gravitational accelerations (N, 3), periodic box.

    Defaults: r_cut = 5 mesh cells, alpha = 2.5 / r_cut. Exact in the far
    field through the smeared mesh and at short range through the erfc
    pair force; the residual error is ~1-3% around r_cut."""
    h = box / mesh
    r_cut = r_cut or 5.0 * h
    alpha = alpha or 2.5 / r_cut
    pos, mass, h, rho_k, (kx, ky, kz) = _density_k(pos, mass, mesh, box)

    # long range: PM with a Gaussian-smeared Green's function
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    smear = torch.exp(-k2 / (4.0 * alpha * alpha))
    # CIC deconvolution: deposit and gather each convolve with the CIC
    # window W(k) = prod sinc^2(k_i h / 2); divide by W^2
    w_cic = (_sinc(kx * h / 2.0) * _sinc(ky * h / 2.0)
             * _sinc(kz * h / 2.0)) ** 2
    deconv = 1.0 / torch.clamp(w_cic * w_cic, min=0.05)
    phi_k = torch.where(k2 > 0,
                        -4.0 * math.pi * G * rho_k * smear * deconv / k2, 0.0)
    # spectral gradient g = -ik phi: 3 inverse transforms
    gfield = _irfftn(torch.stack([-1j * kx * phi_k, -1j * ky * phi_k,
                                  -1j * kz * phi_k]), mesh)
    acc_long = cic_gather(gfield, pos, mesh, box).T

    # short range over cells sized to r_cut
    from njw_tpu_torch.md.neighbors import cell_grid, pick_capacity

    nc = cell_grid([box] * 3, r_cut)
    cap = pick_capacity(pos.shape[0], [box] * 3, nc)
    return acc_long + _short_range_accel(pos, mass, box, alpha, r_cut, G,
                                         nc, cap)
