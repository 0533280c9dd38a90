"""Arakawa C-grid shallow-water core (Sadourny 1975, enstrophy form).

Counterpart of ``njw_tpu/weather/staggered.py``. Every variable is an
(ny, nx) periodic array, index [j, i]:

    h[j, i]   at cell centres          (x_i,        y_j)
    u[j, i]   at east faces            (x_i + dx/2, y_j)
    v[j, i]   at north faces           (x_i,        y_j + dy/2)
    q[j, i]   at corners               (x_i + dx/2, y_j + dy/2)

    U = hbar^x u,  V = hbar^y v            mass fluxes
    q = (dv/dx - du/dy + f) / hbar^xy      potential vorticity at corners
    du/dt = +qbar^y Vbar^xy - d/dx (g h + K)
    dv/dt = -qbar^x Ubar^xy - d/dy (g h + K)
    dh/dt = -(dU/dx + dV/dy)
    K = (u^2bar^x + v^2bar^y) / 2          at centres

The flux-form continuity telescopes (mass is conserved exactly), the
scheme has no checkerboard mode, and the advective term conserves
potential enstrophy. Every shift is a periodic roll; the tendency has the
same pure contract as the A-grid core, so every integrator and
``Simulation`` take it unchanged. No kernel of the port runs it: the fused
RK4 kernel is an A-grid kernel.
"""
from __future__ import annotations

import math

import torch

from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState

_X, _Y = -1, -2


def _roll(f, d, axis):
    return torch.roll(f, -d, dims=axis)


def _dx(f, dx):    # forward difference to the +x staggered location
    return (_roll(f, 1, _X) - f) / dx


def _dy(f, dy):
    return (_roll(f, 1, _Y) - f) / dy


def _dxm(f, dx):   # backward difference to the -x staggered location
    return (f - _roll(f, -1, _X)) / dx


def _dym(f, dy):
    return (f - _roll(f, -1, _Y)) / dy


def _avx(f):       # average to the +x staggered location
    return 0.5 * (f + _roll(f, 1, _X))


def _avy(f):
    return 0.5 * (f + _roll(f, 1, _Y))


def _avxm(f):      # average to the -x staggered location
    return 0.5 * (f + _roll(f, -1, _X))


def _avym(f):
    return 0.5 * (f + _roll(f, -1, _Y))


def swe_tendencies_cgrid(s: WeatherState, grid: GridSpec,
                         params: PhysicsParams) -> WeatherState:
    """Sadourny enstrophy-conserving C-grid SWE tendencies (periodic)."""
    u, v, h = s.u, s.v, s.h
    g = params.gravity
    f = params.coriolis_f
    dx, dy = grid.dx, grid.dy

    U = _avx(h) * u                 # mass fluxes at u and v points
    V = _avy(h) * v

    # corner quantities: zeta and q at (i+1/2, j+1/2)
    zeta = _dx(v, dx) - _dy(u, dy)
    h_corner = _avy(_avx(h))
    q = (zeta + f) / torch.clamp(h_corner, min=1e-12)

    # kinetic energy at centres, the squares averaged back from the faces
    K = 0.5 * (_avxm(u * u) + _avym(v * v))
    phi = g * h + K

    # V from v points (i, j+1/2) to the u point (i+1/2, j): x (+), y (-)
    V_at_u = _avx(_avym(V))
    U_at_v = _avy(_avxm(U))
    du = _avym(q) * V_at_u - _dx(phi, dx)
    dv = -_avxm(q) * U_at_v - _dy(phi, dy)

    # continuity with backward differences: exact telescoping
    dh = -(_dxm(U, dx) + _dym(V, dy))

    nu = params.viscosity
    if nu != 0.0:
        def lap(a):
            return ((_roll(a, 1, _X) - 2 * a + _roll(a, -1, _X)) / dx ** 2
                    + (_roll(a, 1, _Y) - 2 * a + _roll(a, -1, _Y)) / dy ** 2)

        du = du + nu * lap(u)
        dv = dv + nu * lap(v)
    return WeatherState(u=du, v=dv, h=dh)


def potential_enstrophy(s: WeatherState, grid: GridSpec,
                        params: PhysicsParams) -> torch.Tensor:
    """Z = sum(q^2 h_corner) / 2, the invariant the scheme conserves (up
    to time-truncation error)."""
    zeta = _dx(s.v, grid.dx) - _dy(s.u, grid.dy)
    h_corner = _avy(_avx(s.h))
    q = (zeta + params.coriolis_f) / torch.clamp(h_corner, min=1e-12)
    return 0.5 * torch.sum(q * q * h_corner)


def total_energy(s: WeatherState, grid: GridSpec,
                 params: PhysicsParams) -> torch.Tensor:
    """E = sum(h K + g h^2 / 2) on the C-grid."""
    K = 0.5 * (_avxm(s.u * s.u) + _avym(s.v * s.v))
    return torch.sum(s.h * K + 0.5 * params.gravity * s.h * s.h)


def geostrophic_balance_state(grid: GridSpec, params: PhysicsParams, *,
                              amplitude: float = 0.1,
                              mean_depth: float = 10.0,
                              device="cuda") -> WeatherState:
    """A state balanced for the discrete C-grid operators: h a smooth
    periodic bump, and u, v from the discrete geostrophic relations
    f u = -g dh/dy|_(u point), f v = +g dh/dx|_(v point), with the
    staggered differences the core uses."""
    y, x = grid.coords(device)
    ky = 2.0 * math.pi / grid.ny
    kx = 2.0 * math.pi / grid.nx
    h = mean_depth + amplitude * (torch.sin(ky * y) * torch.sin(kx * x))
    g = params.gravity
    f = params.coriolis_f
    dh_dy_at_u = _avx(_avym(_dy(h, grid.dy)))
    dh_dx_at_v = _avy(_avxm(_dx(h, grid.dx)))
    return WeatherState(u=-(g / f) * dh_dy_at_u, v=(g / f) * dh_dx_at_v, h=h)
