"""Initial conditions: a registry of functions ``ic(grid, device, ...)``.

Counterpart of ``njw_tpu/weather/ics.py``: the same nine names, default
parameters, operation order and float32 arithmetic, so that the
deterministic conditions agree with the JAX package to rounding. ``random``
draws from a ``torch.Generator`` and cannot reproduce JAX's threefry bits.

Coordinate convention: normalised coordinates scale by (n - 1), radii by
min(nx, ny).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from njw_tpu_torch.weather.grid import GridSpec, WeatherState

IC_REGISTRY: dict[str, Callable] = {}


def register_ic(name: str):
    def deco(fn):
        IC_REGISTRY[name] = fn
        return fn

    return deco


def make_initial_state(name: str, grid: GridSpec, *, device,
                       generator: Optional[torch.Generator] = None,
                       **params) -> WeatherState:
    """Build an initial state by IC name on ``device``."""
    try:
        fn = IC_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown initial condition {name!r}; available: {sorted(IC_REGISTRY)}"
        ) from None
    return fn(grid, torch.device(device), generator=generator, **params)


def _xy_norm(grid: GridSpec, device):
    """Normalised [0, 1] coordinates, (ny, 1) and (1, nx), /(n - 1)."""
    y, x = grid.coords(device)
    return y / max(grid.ny - 1, 1), x / max(grid.nx - 1, 1)


def _zeros(grid: GridSpec, device) -> torch.Tensor:
    return torch.zeros(grid.shape, dtype=torch.float32, device=device)


@register_ic("uniform")
def uniform(grid, device, generator=None, u=0.0, v=0.0, h=10.0, p=1000.0,
            t=300.0, q=0.0):
    """Uniform fields."""
    full = torch.ones(grid.shape, dtype=torch.float32, device=device)
    return WeatherState(
        u=u * full, v=v * full, h=h * full, p=p * full, T=t * full, q=q * full
    )


@register_ic("random")
def random(grid, device, generator=None, amplitude=1.0, seed=0):
    """u, v ~ U(-a, a), h = 10 + U(-a, a). Drawn on the CPU from
    ``generator`` (or one seeded with ``seed``), so a seed gives the same
    fields on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)

    def unif():
        return torch.empty(grid.shape, dtype=torch.float32).uniform_(
            -amplitude, amplitude, generator=generator).to(device)

    u, v, dh = unif(), unif(), unif()
    return WeatherState(u=u, v=v, h=10.0 + dh)


@register_ic("zonal_flow")
def zonal_flow(grid, device, generator=None, u_max=10.0, h_mean=10.0,
               beta=0.1):
    """u = u_max sin(pi y), h = h_mean - f u^2 / (2 g) with
    f = 1e-4 + beta (y - 1/2)."""
    y_norm, _ = _xy_norm(grid, device)
    u = u_max * torch.sin(math.pi * y_norm)
    f = 1.0e-4 + beta * (y_norm - 0.5)
    h = h_mean - 0.5 * f * u * u / 9.81
    ones_row = torch.ones((1, grid.nx), dtype=torch.float32, device=device)
    return WeatherState(u=u * ones_row, v=_zeros(grid, device),
                        h=h * ones_row)


@register_ic("vortex")
def vortex(grid, device, generator=None, x_center=0.5, y_center=0.5,
           radius=0.1, strength=10.0, h_mean=10.0):
    """Vortex in cyclostrophic balance: inside r <= R,
    w = s r_n exp(1 - r_n^2), h = h_mean - w^2 / (2 * 9.81),
    (u, v) = w (-dy, dx) / max(r, 1e-6)."""
    y, x = grid.coords(device)
    xc = x_center * (grid.nx - 1)
    yc = y_center * (grid.ny - 1)
    rg = radius * min(grid.nx, grid.ny)
    dx = x - xc
    dy = y - yc
    r = torch.sqrt(dx * dx + dy * dy)
    r_n = r / rg
    inside = (r > 0.0) & (r <= rg)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    w = torch.where(inside, strength * r_n * torch.exp(1.0 - r_n * r_n), zero)
    h = torch.where(inside, h_mean - 0.5 * w * w / 9.81, zero + h_mean)
    r_safe = torch.clamp_min(r, 1.0e-6)
    u = -w * dy / r_safe
    v = w * dx / r_safe
    return WeatherState(u=u, v=v, h=h)


@register_ic("jet_stream")
def jet_stream(grid, device, generator=None, y_center=0.5, width=0.1,
               strength=10.0, h_mean=10.0):
    """Gaussian jet u = s exp(-dy^2 / 2w^2) with geostrophic height tilt
    h = h_mean - (1e-4 u / 9.81) dy."""
    y, _ = grid.coords(device)
    yc = y_center * (grid.ny - 1)
    wg = width * grid.ny
    dy = y - yc
    u = strength * torch.exp(-(dy * dy) / (2.0 * wg * wg))
    h = h_mean + (-1.0e-4 * u / 9.81) * dy
    ones_row = torch.ones((1, grid.nx), dtype=torch.float32, device=device)
    return WeatherState(u=u * ones_row, v=_zeros(grid, device),
                        h=h * ones_row)


@register_ic("breaking_wave")
def breaking_wave(grid, device, generator=None, amplitude=1.0,
                  wavelength=0.2, h_mean=10.0):
    """Zonal flow plus a meridionally confined wave perturbation."""
    y_norm, _ = _xy_norm(grid, device)
    _, x = grid.coords(device)
    wave_k = 2.0 * math.pi / (wavelength * grid.nx)
    u_base = 5.0 * torch.sin(math.pi * y_norm)
    phase = wave_k * x - 0.1 * y_norm
    amp = amplitude * torch.exp(-((y_norm - 0.5) ** 2) / 0.05)
    u = u_base + amp * torch.sin(phase)
    v = amp * torch.cos(phase)
    h = h_mean + amp * torch.cos(phase)
    return WeatherState(u=u, v=v, h=h)


@register_ic("front")
def front(grid, device, generator=None, y_position=0.5, width=0.05,
          temp_difference=10.0, wind_shear=5.0):
    """Temperature front with wind shear: tanh transition in T, u, p."""
    y, _ = grid.coords(device)
    yc = y_position * (grid.ny - 1)
    wg = width * grid.ny
    trans = torch.tanh((y - yc) / wg)
    T = 288.15 + 0.5 * temp_difference * trans
    u = 0.5 * wind_shear * trans
    p = 1013.25 - 0.1 * temp_difference * trans
    ones_row = torch.ones((1, grid.nx), dtype=torch.float32, device=device)
    return WeatherState(
        u=u * ones_row,
        v=_zeros(grid, device),
        h=torch.full(grid.shape, 10.0, dtype=torch.float32, device=device),
        p=p * ones_row,
        T=T * ones_row,
    )


@register_ic("mountain")
def mountain(grid, device, generator=None, x_center=0.3, y_center=0.5,
             radius=0.1, height=1.0, u_base=5.0):
    """Bell mountain in the height field with diverted base flow."""
    y, x = grid.coords(device)
    xc = x_center * (grid.nx - 1)
    yc = y_center * (grid.ny - 1)
    rg = radius * min(grid.nx, grid.ny)
    dx = x - xc
    dy = y - yc
    r = torch.sqrt(dx * dx + dy * dy)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    profile = torch.where(
        r <= 2.0 * rg, height * torch.exp(-(r * r) / (rg * rg)), zero
    )
    h = 10.0 + profile
    reduction = torch.where(r <= 3.0 * rg, 0.7 * profile / height, zero)
    u = u_base * (1.0 - reduction)
    v = torch.where(
        r > 0.0, -0.5 * reduction * u_base * dy / torch.clamp_min(r, 1e-12),
        zero)
    return WeatherState(u=u, v=v, h=h)


# Analytic latitude profiles: T decreasing poleward, subtropical jet in u.
_PROFILES = {
    #              T_eq     dT_pole  p0       q_eq   jet_u  jet_lat
    "standard": (298.0, 30.0, 1013.0, 0.8, 12.0, 0.55),
    "tropical": (302.0, 12.0, 1010.0, 0.9, 8.0, 0.45),
    "polar": (275.0, 25.0, 1016.0, 0.5, 15.0, 0.60),
}


@register_ic("atmospheric_profile")
def atmospheric_profile(grid, device, generator=None,
                        profile_name="standard"):
    """Latitude-dependent T/p/q/u profile with small zonal variation
    (T +/-2, p +/-2, q +/-0.02)."""
    if profile_name not in _PROFILES:
        profile_name = "standard"
    T_eq, dT, p0, q_eq, jet_u, jet_lat = _PROFILES[profile_name]
    y_norm, x_norm = _xy_norm(grid, device)
    T_base = T_eq - dT * y_norm
    p_base = p0 - 4.0 * y_norm
    q_base = q_eq * (1.0 - 0.6 * y_norm)
    u_base = jet_u * torch.exp(-((y_norm - jet_lat) ** 2) / 0.02)
    v_base = torch.sin(2.0 * math.pi * y_norm)

    T = T_base + 2.0 * torch.sin(2.0 * math.pi * x_norm)
    p = p_base + 2.0 * torch.cos(2.0 * math.pi * x_norm)
    q = q_base + 0.02 * torch.sin(4.0 * math.pi * x_norm)
    ones = torch.ones(grid.shape, dtype=torch.float32, device=device)
    return WeatherState(
        u=u_base * ones, v=v_base * ones, h=10.0 * ones,
        p=p * ones, T=T * ones, q=q * ones,
    )
