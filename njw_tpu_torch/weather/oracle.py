"""NumPy oracles of the three planar cores (``--validate`` and the tests).

A copy of ``njw_tpu/weather/oracle.py`` (the package keeps its own copy
rather than import the JAX package): ``_shift``, ``swe_tendencies_np``,
``diagnostics_np`` and ``SWEOracle`` for shallow water;
``pe_tendencies_np`` and ``PEOracle`` for the primitive equations;
``invert_vorticity_np``, ``arakawa_jacobian_np``,
``barotropic_tendency_np`` and ``BarotropicOracle`` for the barotropic
core. Written directly against NumPy, independent of ``dynamics.py``,
``barotropic.py`` and ``primitive.py``, so that a fault in the torch path
cannot hide in a shared helper. Float32 throughout.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def _shift(f: np.ndarray, delta: int, axis: int, bc: str,
           edge_sign: float = 1.0) -> np.ndarray:
    """g[i] = f[i+delta] with boundary handling. Scalar ghost rule:
    'clamped'/'outflow'/'reflective' all clamp the edge cell (see
    dynamics.scalar_bc); edge_sign=-1 applies the reflective wall-normal
    velocity sign flip."""
    if bc == "periodic":
        return np.roll(f, -delta, axis=axis)
    g = np.empty_like(f)
    src = [slice(None)] * f.ndim
    dst = [slice(None)] * f.ndim
    edge = [slice(None)] * f.ndim
    n = f.shape[axis]
    if delta == 1:
        dst[axis] = slice(0, n - 1)
        src[axis] = slice(1, n)
        edge[axis] = slice(n - 1, n)
        g[tuple(dst)] = f[tuple(src)]
        g[tuple(edge)] = F(edge_sign) * f[tuple(edge)]
    else:
        dst[axis] = slice(1, n)
        src[axis] = slice(0, n - 1)
        edge[axis] = slice(0, 1)
        g[tuple(dst)] = f[tuple(src)]
        g[tuple(edge)] = F(edge_sign) * f[tuple(edge)]
    return g


def d_dx(f, dx, bc):
    return (_shift(f, 1, -1, bc) - _shift(f, -1, -1, bc)) * F(0.5 / dx)


def d_dy(f, dy, bc):
    return (_shift(f, 1, -2, bc) - _shift(f, -1, -2, bc)) * F(0.5 / dy)


def laplacian(f, dx, dy, bc):
    fxx = (_shift(f, 1, -1, bc) - F(2.0) * f + _shift(f, -1, -1, bc)) / F(dx * dx)
    fyy = (_shift(f, 1, -2, bc) - F(2.0) * f + _shift(f, -1, -2, bc)) / F(dy * dy)
    return fxx + fyy


def swe_tendencies_np(u, v, h, *, dx, dy, bc, gravity, coriolis_f,
                      beta=0.0, viscosity=0.0):
    """du/dt, dv/dt, dh/dt per ref: weather_simulation.cpp:530-537."""
    u = u.astype(F, copy=False)
    v = v.astype(F, copy=False)
    h = h.astype(F, copy=False)
    bc_s = "clamped" if bc in ("clamped", "outflow", "reflective") else bc
    if bc == "reflective":
        # wall-normal velocity ghosts flip sign (no-flux walls)
        cxs = F(0.5 / dx)
        cys = F(0.5 / dy)
        u_x = (_shift(u, 1, -1, bc_s, -1.0)
               - _shift(u, -1, -1, bc_s, -1.0)) * cxs
        v_y = (_shift(v, 1, -2, bc_s, -1.0)
               - _shift(v, -1, -2, bc_s, -1.0)) * cys
        u_y = d_dy(u, dy, bc_s)
        v_x = d_dx(v, dx, bc_s)
    else:
        u_x, u_y = d_dx(u, dx, bc_s), d_dy(u, dy, bc_s)
        v_x, v_y = d_dx(v, dx, bc_s), d_dy(v, dy, bc_s)
    h_x, h_y = d_dx(h, dx, bc_s), d_dy(h, dy, bc_s)
    reflective = bc == "reflective"
    bc = bc_s

    ny = u.shape[-2]
    y_norm = (np.arange(ny, dtype=F)[:, None] / F(max(ny - 1, 1)))
    f = F(coriolis_f) + F(beta) * (y_norm - F(0.5))
    g = F(gravity)

    du = -u * u_x - v * u_y - g * h_x + f * v
    dv = -u * v_x - v * v_y - g * h_y - f * u
    dh = -h * (u_x + v_y) - u * h_x - v * h_y
    if viscosity:
        nu = F(viscosity)
        if reflective:
            # velocity laplacians use the same flipped wall-normal ghosts
            def lap_signed(a, sx, sy):
                axx = (_shift(a, 1, -1, bc, sx) - F(2.0) * a
                       + _shift(a, -1, -1, bc, sx)) / F(dx * dx)
                ayy = (_shift(a, 1, -2, bc, sy) - F(2.0) * a
                       + _shift(a, -1, -2, bc, sy)) / F(dy * dy)
                return axx + ayy

            du = du + nu * lap_signed(u, -1.0, 1.0)
            dv = dv + nu * lap_signed(v, 1.0, -1.0)
        else:
            du = du + nu * laplacian(u, dx, dy, bc)
            dv = dv + nu * laplacian(v, dx, dy, bc)
    return du, dv, dh


def diagnostics_np(u, v, *, dx, dy, bc):
    """vorticity = dv/dx - du/dy; divergence = du/dx + dv/dy
    (ref: weather_grid.cpp:82-121)."""
    return (
        d_dx(v, dx, bc) - d_dy(u, dy, bc),
        d_dx(u, dx, bc) + d_dy(v, dy, bc),
    )


class SWEOracle:
    """Step-loop oracle with euler / rk2 / rk4 / adams_bashforth."""

    def __init__(self, *, dx=1.0, dy=1.0, bc="periodic", gravity=9.81,
                 coriolis_f=0.0, beta=0.0, viscosity=0.0):
        self.kw = dict(dx=dx, dy=dy, bc=bc, gravity=gravity,
                       coriolis_f=coriolis_f, beta=beta, viscosity=viscosity)
        self._t_prev = None  # AB2 history

    def tendency(self, state):
        u, v, h = state
        return swe_tendencies_np(u, v, h, **self.kw)

    @staticmethod
    def _axpy(a, k, s):
        a = F(a)
        return tuple(si + a * ki for si, ki in zip(s, k))

    def step(self, state, dt, method="rk4"):
        s = tuple(np.asarray(f, dtype=F) for f in state)
        dt = float(dt)
        if method == "euler":
            return self._axpy(dt, self.tendency(s), s)
        if method == "rk2":
            k1 = self.tendency(s)
            k2 = self.tendency(self._axpy(0.5 * dt, k1, s))
            return self._axpy(dt, k2, s)
        if method == "rk4":
            k1 = self.tendency(s)
            k2 = self.tendency(self._axpy(0.5 * dt, k1, s))
            k3 = self.tendency(self._axpy(0.5 * dt, k2, s))
            k4 = self.tendency(self._axpy(dt, k3, s))
            incr = tuple(
                (a + F(2.0) * b + F(2.0) * c + d) * F(1.0 / 6.0)
                for a, b, c, d in zip(k1, k2, k3, k4)
            )
            return self._axpy(dt, incr, s)
        if method == "adams_bashforth":
            t_now = self.tendency(s)
            t_prev = self._t_prev if self._t_prev is not None else t_now
            incr = tuple(F(1.5) * a - F(0.5) * b for a, b in zip(t_now, t_prev))
            self._t_prev = t_now
            return self._axpy(dt, incr, s)
        raise ValueError(f"unknown method {method!r}")

    def run(self, state, dt, n_steps, method="rk4"):
        self._t_prev = None
        s = tuple(np.asarray(f, dtype=F) for f in state)
        for _ in range(n_steps):
            s = self.step(s, dt, method)
        return s


# ---------------------------------------------------------------------------
# Primitive-equations oracle (independent NumPy implementation of
# weather/primitive.py; see that module's docstring for the continuous
# equations).
# ---------------------------------------------------------------------------

_R_DRY = np.float32(287.04)
_KAPPA = np.float32(287.04 / 1004.64)


def pe_tendencies_np(u, v, T, q, ps, *, dx, dy, bc, coriolis_f=0.0,
                     phi_s=None):
    """Returns (du, dv, dT, dq, dps); shapes (L,ny,nx) x4 + (ny,nx).
    phi_s: optional (ny, nx) surface geopotential (terrain)."""
    u, v, T, q, ps = (np.asarray(a, dtype=F) for a in (u, v, T, q, ps))
    L = u.shape[0]
    dsig = F(1.0 / L)
    sig = ((np.arange(L, dtype=F) + F(0.5)) / F(L))[:, None, None]
    sig_half = (np.arange(L + 1, dtype=F) / F(L))[:, None, None]
    fcor = F(coriolis_f)

    reflective = bc == "reflective"
    bc_s = "clamped" if reflective else bc
    ddx = lambda a: d_dx(a, dx, bc_s)
    ddy = lambda a: d_dy(a, dy, bc_s)
    if reflective:
        # wall-normal velocity ghosts flip sign (u at x walls, v at y
        # walls) — including inside the ps*u / ps*v fluxes, matching the
        # jnp path which flips the PADDED velocity before any product.
        ddx_n = lambda a: (_shift(a, 1, -1, bc_s, -1.0)
                           - _shift(a, -1, -1, bc_s, -1.0)) * F(0.5 / dx)
        ddy_n = lambda a: (_shift(a, 1, -2, bc_s, -1.0)
                           - _shift(a, -1, -2, bc_s, -1.0)) * F(0.5 / dy)
    else:
        ddx_n, ddy_n = ddx, ddy

    lnps = np.log(ps)
    flux_div = ddx_n(ps * u) + ddy_n(ps * v)
    dps = -(flux_div.sum(axis=0)) * dsig
    cum = np.cumsum(flux_div, axis=0) * dsig
    sdot_ps = -sig_half[1:-1] * dps[None] - cum[:-1]
    sdot_half = np.concatenate(
        [np.zeros_like(sdot_ps[:1]), sdot_ps / ps[None],
         np.zeros_like(sdot_ps[:1])], axis=0)

    def vadv(X):
        dX = X[1:] - X[:-1]
        upper = sdot_half[1:-1] * dX
        pad = np.zeros_like(X[:1])
        return (np.concatenate([upper, pad], axis=0)
                + np.concatenate([pad, upper], axis=0)) * F(0.5 / dsig)

    # hydrostatic geopotential
    ln_ratio = np.log(sig[1:, 0, 0] / sig[:-1, 0, 0]).astype(F)
    phi_bot = _R_DRY * T[-1] * F(-np.log(sig[-1, 0, 0]))
    if phi_s is not None:
        phi_bot = phi_bot + np.asarray(phi_s, F)
    thick = _R_DRY * F(0.5) * (T[:-1] + T[1:]) * ln_ratio[:, None, None]
    below = np.cumsum(thick[::-1], axis=0)[::-1]
    phi = np.concatenate([phi_bot[None] + below, phi_bot[None]], axis=0)

    lnps_x, lnps_y = ddx(lnps), ddy(lnps)
    du = (-u * ddx_n(u) - v * ddy(u) - vadv(u) + fcor * v
          - ddx(phi) - _R_DRY * T * lnps_x)
    dv = (-u * ddx(v) - v * ddy_n(v) - vadv(v) - fcor * u
          - ddy(phi) - _R_DRY * T * lnps_y)

    dlnps_adv = dps / ps + u * lnps_x + v * lnps_y
    sdot_full = F(0.5) * (sdot_half[:-1] + sdot_half[1:])
    omega_over_p = sdot_full / sig + dlnps_adv
    dT = -u * ddx(T) - v * ddy(T) - vadv(T) + _KAPPA * T * omega_over_p
    dq = -u * ddx(q) - v * ddy(q) - vadv(q)
    return du, dv, dT, dq, dps


class PEOracle:
    """Step-loop RK4 oracle for the primitive equations — the BASELINE
    "allclose after 1000 steps" bar for the PE core (BASELINE.md:49-50),
    mirroring SWEOracle. State: (u, v, T, q, ps)."""

    def __init__(self, *, dx=1.0, dy=1.0, bc="periodic", coriolis_f=0.0,
                 phi_s=None):
        self.kw = dict(dx=dx, dy=dy, bc=bc, coriolis_f=coriolis_f,
                       phi_s=phi_s)

    def tendency(self, state):
        u, v, T, q, ps = state
        return pe_tendencies_np(u, v, T, q, ps, **self.kw)

    @staticmethod
    def _axpy(a, k, s):
        a = F(a)
        return tuple(si + a * ki for si, ki in zip(s, k))

    def step(self, state, dt):
        s = tuple(np.asarray(f, dtype=F) for f in state)
        dt = float(dt)
        k1 = self.tendency(s)
        k2 = self.tendency(self._axpy(0.5 * dt, k1, s))
        k3 = self.tendency(self._axpy(0.5 * dt, k2, s))
        k4 = self.tendency(self._axpy(dt, k3, s))
        incr = tuple(
            (a + F(2.0) * b + F(2.0) * c + d) * F(1.0 / 6.0)
            for a, b, c, d in zip(k1, k2, k3, k4)
        )
        return self._axpy(dt, incr, s)

    def run(self, state, dt, n_steps):
        s = tuple(np.asarray(f, dtype=F) for f in state)
        for _ in range(n_steps):
            s = self.step(s, dt)
        return s


# ---------------------------------------------------------------------------
# Barotropic vorticity oracle (independent NumPy implementation of
# weather/barotropic.py: spectral Poisson inversion with the laplacian5
# symbol + Arakawa (1966) Jacobian).
# ---------------------------------------------------------------------------


def _lap5_k2_np(n: int, d: float) -> np.ndarray:
    """Modified wavenumber^2 of the 3-point second difference:
    2(1 - cos(k d)) / d^2 (matches ops.spectral 'laplacian5')."""
    k = 2.0 * np.pi * np.fft.fftfreq(n, d=d)
    return (2.0 * (1.0 - np.cos(k * d)) / (d * d)).astype(np.float64)


def invert_vorticity_np(zeta: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """psi with Laplacian5(psi) = zeta; periodic, zero-mean gauge."""
    ny, nx = zeta.shape
    k2 = _lap5_k2_np(nx, dx)[None, :] + _lap5_k2_np(ny, dy)[:, None]
    denom = -k2
    denom[0, 0] = 1.0
    phat = np.fft.fft2(np.asarray(zeta, F)) / denom
    phat[0, 0] = 0.0
    return np.real(np.fft.ifft2(phat)).astype(F)


def arakawa_jacobian_np(p: np.ndarray, z: np.ndarray, dx: float,
                        dy: float) -> np.ndarray:
    """Arakawa J = (J1+J2+J3)/3, periodic (energy/enstrophy conserving)."""
    p = np.asarray(p, F)
    z = np.asarray(z, F)
    sh = lambda f, sx, sy: np.roll(np.roll(f, -sx, axis=-1), -sy, axis=-2)
    pE, pW, pN, pS = sh(p, 1, 0), sh(p, -1, 0), sh(p, 0, 1), sh(p, 0, -1)
    pNE, pNW = sh(p, 1, 1), sh(p, -1, 1)
    pSE, pSW = sh(p, 1, -1), sh(p, -1, -1)
    zE, zW, zN, zS = sh(z, 1, 0), sh(z, -1, 0), sh(z, 0, 1), sh(z, 0, -1)
    zNE, zNW = sh(z, 1, 1), sh(z, -1, 1)
    zSE, zSW = sh(z, 1, -1), sh(z, -1, -1)
    j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW)
    j2 = (pE * (zNE - zSE) - pW * (zNW - zSW)
          - pN * (zNE - zNW) + pS * (zSE - zSW))
    j3 = (zN * (pNE - pNW) - zS * (pSE - pSW)
          - zE * (pNE - pSE) + zW * (pNW - pSW))
    return ((j1 + j2 + j3) / F(12.0 * dx * dy)).astype(F)


def barotropic_tendency_np(zeta, *, dx, dy, beta=0.0,
                           viscosity=0.0) -> np.ndarray:
    """d zeta/dt = -J(psi, zeta) - beta v + nu Laplacian(zeta)."""
    zeta = np.asarray(zeta, F)
    psi = invert_vorticity_np(zeta, dx, dy)
    dz = -arakawa_jacobian_np(psi, zeta, dx, dy)
    if beta:
        dz = dz - F(beta) * d_dx(psi, dx, "periodic")
    if viscosity:
        dz = dz + F(viscosity) * laplacian(zeta, dx, dy, "periodic")
    return dz


class BarotropicOracle:
    """Step-loop RK4 oracle for the barotropic vorticity core — the
    BASELINE 1000-step bar for the third dynamical core."""

    def __init__(self, *, dx=1.0, dy=1.0, beta=0.0, viscosity=0.0):
        self.kw = dict(dx=dx, dy=dy, beta=beta, viscosity=viscosity)

    def tendency(self, zeta):
        return barotropic_tendency_np(zeta, **self.kw)

    def step(self, zeta, dt):
        z = np.asarray(zeta, F)
        dt = F(dt)
        k1 = self.tendency(z)
        k2 = self.tendency(z + F(0.5) * dt * k1)
        k3 = self.tendency(z + F(0.5) * dt * k2)
        k4 = self.tendency(z + dt * k3)
        return z + dt * (k1 + F(2) * k2 + F(2) * k3 + k4) * F(1.0 / 6.0)

    def run(self, zeta, dt, n_steps):
        z = np.asarray(zeta, F)
        for _ in range(n_steps):
            z = self.step(z, dt)
        return z
