"""Spherical-harmonic transform (SHT) on a Gaussian grid.

Counterpart of ``njw_tpu/ops/sht.py``:

* Set-up (Gaussian nodes and weights, the associated Legendre tables)
  runs once in float64 NumPy on the host, with the stable three-term
  recurrences; the tables go to the device as float32 (or bf16, opt-in).
* At run time a transform is an ``rfft`` along longitude and one batched
  matrix product over latitude per Legendre table: ``torch.bmm`` batched
  over the zonal wavenumber m, with the table in its stored (m, n, lat)
  layout. The complex operand is split into a real (2q, ...) stack
  (real parts, then imaginary parts), so the real table is never upcast
  to complex or copied: the tables are the bytes a step reads.
* The products are float32 throughout: each contraction runs under
  ``torch.get_float32_matmul_precision() == "highest"`` (no TF32),
  whatever the process has set, and restores the setting after.

Conventions: triangular truncation T; coefficients packed as a complex
array ``a[m, n]`` of shape (T+1, T+2), valid for m <= n <= T (the column
n = T+1 exists only inside the derivative tables). Legendre functions are
orthonormal: ``0.5 * sum_j w_j Pbar[m,n,j] Pbar[m,n',j] = delta(n,n')``,
alias-free up to the quadratic truncation ``T = (2*nlat - 1) // 3``. The
real field is ``f = sum_m Re(F_m e^{im lambda})`` by ``irfft``; Fourier
coefficients carry 1/nlon from the analysis.

The parity fold: Pbar[m,n](-mu) = (-1)^(n-m) Pbar(mu), and H has the
opposite parity, so each contraction can run as two half-size products
over the northern hemisphere with n split by parity; on by default from
nlat = 512 (even nlat), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.precision import float32_products

# Hemispheric parity of each runtime table; the quadrature weights and
# 1/cos^2 factors are even in mu
_TABLE_PARITY = {"P": +1, "Pw": +1, "Pw_over_c2": +1,
                 "H": -1, "Hw_over_c2": -1}
TABLES = ("P", "H", "Pw", "Pw_over_c2", "Hw_over_c2")


def gaussian_grid(nlat: int):
    """Gaussian latitudes (ascending mu = sin(lat)) and quadrature weights."""
    return np.polynomial.legendre.leggauss(nlat)


def legendre_tables(trunc: int, mu: np.ndarray):
    """Orthonormal associated Legendre Pbar[m, n, j] and the derivative
    table H[m, n, j] = (1 - mu^2) dPbar/dmu, n up to trunc + 1, float64."""
    nlat = mu.size
    nmax = trunc + 1  # P at n = trunc+1 for H at n = trunc
    P = np.zeros((trunc + 1, nmax + 1, nlat))
    sin2 = 1.0 - mu * mu

    pmm = np.ones(nlat)  # Pbar_0^0 = 1 under 0.5 * int P^2 dmu = 1
    for m in range(trunc + 1):
        if m > 0:
            pmm = pmm * np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * np.sqrt(sin2)
        P[m, m] = pmm
        if m + 1 <= nmax:
            P[m, m + 1] = np.sqrt(2.0 * m + 3.0) * mu * pmm
        for n in range(m + 2, nmax + 1):
            e_n = np.sqrt((n * n - m * m) / (4.0 * n * n - 1.0))
            e_n1 = np.sqrt(((n - 1) ** 2 - m * m)
                           / (4.0 * (n - 1) ** 2 - 1.0))
            P[m, n] = (mu * P[m, n - 1] - e_n1 * P[m, n - 2]) / e_n

    # H_n^m = -n eps_{n+1}^m P_{n+1}^m + (n+1) eps_n^m P_{n-1}^m
    H = np.zeros((trunc + 1, nmax + 1, nlat))
    for m in range(trunc + 1):
        for n in range(m, nmax):
            e_np1 = np.sqrt(((n + 1) ** 2 - m * m)
                            / (4.0 * (n + 1) ** 2 - 1.0))
            h = -n * e_np1 * P[m, n + 1]
            if n - 1 >= m:
                e_n = np.sqrt((n * n - m * m) / (4.0 * n * n - 1.0))
                h = h + (n + 1) * e_n * P[m, n - 1]
            H[m, n] = h
    return P, H


def _split(z: torch.Tensor) -> torch.Tensor:
    """(q, ...) complex -> (2q, ...) real: real parts, then imaginary."""
    return torch.cat([z.real, z.imag])


def _join(r: torch.Tensor, cdtype) -> torch.Tensor:
    q = r.shape[0] // 2
    return torch.complex(r[:q], r[q:]).to(cdtype)


class SphericalHarmonicTransform:
    """Forward and inverse SHT and the spectral operators of the spectral
    cores.

    nlat: Gaussian latitudes; nlon = 2 nlat. trunc: triangular truncation,
    (2 nlat - 1) // 3 by default. radius: sphere radius (m). table_dtype:
    the tables' storage type (float32 by default; bf16 halves their bytes
    and is upcast to float32 at each product: a table-sized copy a call,
    which only a fused kernel would save). fold_parity: None = on from
    nlat 512 with even nlat. device: CUDA unless 'cpu'.
    """

    def __init__(self, nlat: int, trunc: int | None = None,
                 radius: float = 6.371e6, dtype=torch.float32,
                 table_dtype=None, fold_parity: bool | None = None,
                 device="cuda"):
        self.device = require_device(device)
        self.nlat = int(nlat)
        self.nlon = 2 * self.nlat
        self.trunc = int(trunc) if trunc is not None else \
            (2 * self.nlat - 1) // 3
        if self.trunc + 1 > self.nlat:
            raise ValueError("truncation too high for nlat (need T+1<=nlat)")
        self.radius = float(radius)

        mu, w = gaussian_grid(self.nlat)
        P, H = legendre_tables(self.trunc, mu)
        self.mu = mu                      # (nlat,) ascending, float64
        self.lats = np.arcsin(mu)
        self.lons = 2.0 * np.pi * np.arange(self.nlon) / self.nlon
        self.quad_w = w

        self.dtype = dtype
        self.cdtype = (torch.complex64 if dtype == torch.float32
                       else torch.complex128)
        self.table_dtype = table_dtype if table_dtype is not None else dtype
        npdt = np.float32 if dtype == torch.float32 else np.float64

        def dev(a, dt=dtype):
            # converted in NumPy, then moved
            t = torch.from_numpy(np.ascontiguousarray(a, npdt))
            return t.to(device=self.device, dtype=dt)

        nt = self.trunc + 2
        c2 = 1.0 - mu * mu
        full = {
            "P": P[:, :nt, :],
            "Pw": 0.5 * w * P[:, :nt, :],
            "H": H[:, :nt, :],
            "Hw_over_c2": 0.5 * (w / c2) * H[:, :nt, :],
            "Pw_over_c2": 0.5 * (w / c2) * P[:, :nt, :],
        }
        # runtime tables (m, n, lat): P for synthesis, 0.5 w P for
        # analysis, H and 0.5 w H / (1 - mu^2) for the winds and the
        # divergence; folded, only their halves are kept (every
        # contraction runs folded)
        if fold_parity is None:
            fold_parity = self.nlat >= 512 and self.nlat % 2 == 0
        self.fold_parity = bool(fold_parity)
        self.tables = self.folded = None
        if self.fold_parity:
            if self.nlat % 2:
                raise ValueError("fold_parity requires even nlat")
            jn = self.nlat // 2  # northern half: mu ascending -> j >= jn
            self.folded = {k: (dev(X[:, 0::2, jn:], self.table_dtype),
                               dev(X[:, 1::2, jn:], self.table_dtype))
                           for k, X in full.items()}
        else:
            self.tables = {k: dev(X, self.table_dtype)
                           for k, X in full.items()}
        del full, P, H

        n = np.arange(nt)
        m = np.arange(self.trunc + 1)
        valid = (n[None, :] >= m[:, None]) & (n[None, :] <= self.trunc)
        self.valid = torch.from_numpy(valid).to(self.device)
        lap = -n * (n + 1.0) / self.radius ** 2
        self.lap = dev(np.where(valid, lap[None, :], 0.0))
        inv_lap = np.zeros_like(lap)
        inv_lap[1:] = -self.radius ** 2 / (n[1:] * (n[1:] + 1.0))
        self.inv_lap = dev(np.where(valid, inv_lap[None, :], 0.0))
        self.m = dev(m)
        self.im = (1j * self.m.to(self.cdtype))
        # (-1)^m, the fold's sign, as a (1, 1, m) factor
        self.sgn_m = dev((1.0 - 2.0 * (m % 2))[None, None, :])
        self.mu_grid = dev(np.broadcast_to(mu[:, None],
                                           (self.nlat, self.nlon)))
        self.cos_lat_grid = dev(np.broadcast_to(
            np.sqrt(1.0 - mu ** 2)[:, None], (self.nlat, self.nlon)))
        self.spec_shape = (self.trunc + 1, nt)

    # -- Fourier transforms along longitude --------------------------------

    def fourier(self, f: torch.Tensor) -> torch.Tensor:
        """Grid (..., lat, nlon) -> truncated Fourier coefficients
        (..., lat, m), with the 1/nlon factor."""
        F = torch.fft.rfft(f.to(self.dtype), dim=-1) / self.nlon
        return F[..., : self.trunc + 1]

    def to_grid(self, F: torch.Tensor) -> torch.Tensor:
        """Fourier coefficients (..., lat, m) -> the real grid."""
        G = torch.zeros(F.shape[:-1] + (self.nlon // 2 + 1,),
                        dtype=F.dtype, device=F.device)
        G[..., : F.shape[-1]] = F * self.nlon
        # a real field's m = 0 bin is real: pocketfft (the CPU) ignores its
        # imaginary part, and cuFFT's C2R is undefined on it; zero it so
        # that both compute the same transform
        torch.view_as_real(G)[..., 0, 1] = 0.0
        return torch.fft.irfft(G, n=self.nlon, dim=-1).to(self.dtype)

    # -- the Legendre contractions -----------------------------------------

    def _table(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.dtype == self.dtype else t.to(self.dtype)

    def syn_stack(self, a_stack: torch.Tensor, which: str = "P"
                  ) -> torch.Tensor:
        """Stacked spectral -> Fourier: (q, m, n) -> (q, lat, m), reading
        the table once. Folded: two half-size products over the north, the
        south by symmetry, F_S = p (-1)^m (Se - So)."""
        ri = _split(a_stack).transpose(0, 1)        # (m, 2q, n)
        with float32_products():
            if self.folded is not None:
                Xe, Xo = self.folded[which]
                Se = torch.bmm(ri[..., 0::2], self._table(Xe))
                So = torch.bmm(ri[..., 1::2], self._table(Xo))
                sgn = float(_TABLE_PARITY[which]) * self.sgn_m.view(-1, 1, 1)
                north = Se + So
                south = sgn * (Se - So)
                out = torch.cat([south.flip(-1), north], dim=-1)
            else:
                out = torch.bmm(ri, self._table(self.tables[which]))
        # (m, 2q, lat) -> (2q, lat, m)
        return _join(out.permute(1, 2, 0), self.cdtype)

    def anal_stack(self, F_stack: torch.Tensor, which: str) -> torch.Tensor:
        """Stacked Fourier -> spectral quadrature against one table:
        (q, lat, m) -> (q, m, n), unmasked (the caller applies ``valid``).
        Folded: quadrature over the north against F_N +- p (-1)^m F_S."""
        ri = _split(F_stack).permute(2, 1, 0)       # (m, lat, 2q)
        with float32_products():
            if self.folded is not None:
                jn = self.nlat // 2
                Xe, Xo = self.folded[which]
                f_n = ri[:, jn:]
                f_s = ri[:, :jn].flip(1)            # aligned with the north
                sgn = float(_TABLE_PARITY[which]) * self.sgn_m.view(-1, 1, 1)
                ae = torch.bmm(self._table(Xe), f_n + sgn * f_s)
                ao = torch.bmm(self._table(Xo), f_n - sgn * f_s)
                out = torch.zeros((ri.shape[0], self.trunc + 2, ri.shape[2]),
                                  dtype=ri.dtype, device=ri.device)
                out[:, 0::2] = ae
                out[:, 1::2] = ao
            else:
                out = torch.bmm(self._table(self.tables[which]), ri)
        # (m, n, 2q) -> (2q, m, n)
        return _join(out.permute(2, 0, 1), self.cdtype)

    def masked(self, a: torch.Tensor) -> torch.Tensor:
        return torch.where(self.valid, a, torch.zeros((), dtype=a.dtype,
                                                      device=a.device))

    # -- transforms -----------------------------------------------------------

    def analysis(self, f: torch.Tensor) -> torch.Tensor:
        """Grid (..., nlat, nlon) -> packed spectral (..., T+1, T+2)."""
        lead = f.shape[:-2]
        F = self.fourier(f)
        a = self.anal_stack(F.reshape((-1,) + F.shape[-2:]), "Pw")
        return self.masked(a).reshape(lead + self.spec_shape)

    def synthesis(self, a: torch.Tensor) -> torch.Tensor:
        """Packed spectral (..., T+1, T+2) -> grid (..., nlat, nlon)."""
        lead = a.shape[:-2]
        F = self.syn_stack(a.reshape((-1,) + self.spec_shape), "P")
        return self.to_grid(F).reshape(lead + (F.shape[-2], self.nlon))

    # -- differential operators --------------------------------------------

    def laplacian(self, a):
        return a * self.lap

    def inverse_laplacian(self, a):
        """psi with Lap psi = a; the n = 0 mode set to zero."""
        return a * self.inv_lap

    def d_dlon(self, a):
        return a * self.im[:, None]

    def uv_from_psi_chi(self, psi, chi):
        """Pseudo-winds U = u cos(lat), V = v cos(lat) on the grid from
        spectral streamfunction and velocity potential:
        U = (1/a)[dchi/dlon - (1-mu^2) dpsi/dmu],
        V = (1/a)[dpsi/dlon + (1-mu^2) dchi/dmu]."""
        inv_a = 1.0 / self.radius
        Fp = self.syn_stack(torch.stack([self.d_dlon(chi),
                                         self.d_dlon(psi)]), "P")
        Fh = self.syn_stack(torch.stack([psi, chi]), "H")
        G = self.to_grid(torch.stack([(Fp[0] - Fh[0]) * inv_a,
                                      (Fp[1] + Fh[1]) * inv_a]))
        return G[0], G[1]

    def divergence_of(self, A, B):
        """Spectral divergence of the true vector field (X, Y) from its
        pseudo-vector A = X cos(lat), B = Y cos(lat):
        (1/a) sum_j w_j/(1-mu^2) [im A P - B H] / 2."""
        FA, FB = self.fourier(A), self.fourier(B)
        d = (self.anal_stack((FA * self.im)[None], "Pw_over_c2")[0]
             - self.anal_stack(FB[None], "Hw_over_c2")[0])
        return self.masked(d / self.radius)

    def curl_of(self, A, B):
        """Spectral k . curl(X, Y) for the same pseudo-vector convention."""
        FA, FB = self.fourier(A), self.fourier(B)
        c = (self.anal_stack((FB * self.im)[None], "Pw_over_c2")[0]
             + self.anal_stack(FA[None], "Hw_over_c2")[0])
        return self.masked(c / self.radius)

    # -- helpers ---------------------------------------------------------------

    def grid_of_mu(self):
        """(nlat, nlon) broadcast of mu = sin(lat)."""
        return self.mu_grid

    def cos_lat(self):
        return self.cos_lat_grid

    def spectral_mode(self, m: int, n: int, amplitude: float = 1.0):
        """Packed coefficients of amplitude * Re(Y_n^m) as a real field."""
        a = torch.zeros(self.spec_shape, dtype=self.cdtype,
                        device=self.device)
        a[m, n] = amplitude if m == 0 else amplitude / 2.0
        return a

    def global_mean(self, f):
        w = torch.as_tensor(self.quad_w, dtype=self.dtype, device=f.device)
        return torch.sum(w[:, None] * f.to(self.dtype)) / (2.0 * self.nlon)

    def table_bytes(self, which: str) -> int:
        """The bytes one contraction against table ``which`` reads."""
        if self.folded is not None:
            return sum(t.numel() * t.element_size()
                       for t in self.folded[which])
        t = self.tables[which]
        return t.numel() * t.element_size()
