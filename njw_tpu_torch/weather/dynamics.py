"""Shallow-water tendencies in plain PyTorch (the port's "plain" path).

Counterpart of ``njw_tpu/weather/dynamics.py`` for the shallow-water core
on the cartesian A-grid:

    du/dt = -u du/dx - v du/dy - g dh/dx + f v           (+ nu lap u)
    dv/dt = -u dv/dx - v dv/dy - g dh/dy - f u           (+ nu lap v)
    dh/dt = -h (du/dx + dv/dy) - u dh/dx - v dh/dy

with central differences, a beta-plane Coriolis f = f0 + beta (y_n - 1/2)
and the four boundary conditions. The physics is written once against a
``shift(f, dxi, dyi)`` accessor (``swe_tendencies_from_shifts``), as in the
JAX package. Tendency functions are pure: ``T(state) -> d(state)/dt``.
``make_tendency_fn`` also hands out the C-grid core's tendencies
(``staggered.py``) and the barotropic and primitive-equation cores'
(``barotropic.py``, ``primitive.py``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState

Tensor = torch.Tensor

_X, _Y = -1, -2  # axis convention: fields are (..., ny, nx)


def scalar_bc(bc: str) -> str:
    """The ghost-cell rule for scalar fields under each BC: 'outflow'
    (zero gradient) and 'reflective' (symmetric about the wall face) both
    reduce to edge clamping for halo-1 stencils; reflective additionally
    flips the wall-normal velocity's ghost sign (in ``swe_tendencies``)."""
    return "clamped" if bc in ("clamped", "outflow", "reflective") else bc


def _shift(f: Tensor, delta: int, axis: int, bc: str) -> Tensor:
    """g with g[i] = f[i + delta] along ``axis`` under boundary ``bc``
    (scalar-field ghost rule; see scalar_bc)."""
    bc = scalar_bc(bc)
    if bc == "periodic":
        return torch.roll(f, -delta, dims=axis)
    n = f.shape[axis]
    if delta == 1:
        return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                         dim=axis)
    if delta == -1:
        return torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                         dim=axis)
    raise ValueError(f"unsupported shift {delta}")


def pad_and_shift(bc: str, ny: int, nx: int, halo: int = 1):
    """Pad-once + slice-view shift accessor for whole-domain fields.
    Returns (pad_fn, shift_fn, crop_fn) for ``swe_tendencies_from_shifts``."""
    hw = halo
    mode = "circular" if scalar_bc(bc) == "periodic" else "replicate"

    def pad(f: Tensor) -> Tensor:
        # torch pads the last two dims of a 3-D or 4-D input only
        lead = f.shape[:-2]
        f3 = f.reshape((-1,) + tuple(f.shape[-2:]))
        out = F.pad(f3, (hw, hw, hw, hw), mode=mode)
        return out.reshape(lead + out.shape[-2:])

    def shift(fp: Tensor, dxi: int = 0, dyi: int = 0) -> Tensor:
        return fp[..., hw + dyi: hw + dyi + ny, hw + dxi: hw + dxi + nx]

    def crop(fp: Tensor) -> Tensor:
        return fp[..., hw: hw + ny, hw: hw + nx]

    return pad, shift, crop


def make_shift_fn(bc: str):
    """shift(f, dxi, dyi) -> f offset by (dxi, dyi) grid cells under
    ``bc`` (roll or edge clamp on whole-domain fields; the clamped rules
    take offsets of one cell)."""

    def shift(f: Tensor, dxi: int = 0, dyi: int = 0) -> Tensor:
        out = f
        if dxi:
            out = _shift(out, dxi, _X, bc)
        if dyi:
            out = _shift(out, dyi, _Y, bc)
        return out

    return shift


def d_dx(f: Tensor, dx: float, bc: str) -> Tensor:
    """Central difference along x."""
    return (_shift(f, 1, _X, bc) - _shift(f, -1, _X, bc)) * (0.5 / dx)


def d_dy(f: Tensor, dy: float, bc: str) -> Tensor:
    """Central difference along y."""
    return (_shift(f, 1, _Y, bc) - _shift(f, -1, _Y, bc)) * (0.5 / dy)


def laplacian(f: Tensor, dx: float, dy: float, bc: str) -> Tensor:
    """5-point Laplacian (the viscosity terms)."""
    fxx = (_shift(f, 1, _X, bc) - 2.0 * f + _shift(f, -1, _X, bc)) / (dx * dx)
    fyy = (_shift(f, 1, _Y, bc) - 2.0 * f + _shift(f, -1, _Y, bc)) / (dy * dy)
    return fxx + fyy


def swe_tendencies_from_shifts(u, v, h, shift, grid: GridSpec,
                               params: PhysicsParams, interior=None):
    """SWE tendencies given a neighbour-shift accessor. ``interior`` crops
    a (possibly padded) field to the output shape; identity by default.
    ``params.coriolis_f`` may be a float or a (ny, 1) tensor."""
    crop = interior if interior is not None else (lambda f: f)
    cx = 0.5 / grid.dx
    cy = 0.5 / grid.dy

    u_x = (shift(u, 1, 0) - shift(u, -1, 0)) * cx
    u_y = (shift(u, 0, 1) - shift(u, 0, -1)) * cy
    v_x = (shift(v, 1, 0) - shift(v, -1, 0)) * cx
    v_y = (shift(v, 0, 1) - shift(v, 0, -1)) * cy
    h_x = (shift(h, 1, 0) - shift(h, -1, 0)) * cx
    h_y = (shift(h, 0, 1) - shift(h, 0, -1)) * cy

    uc, vc, hc = crop(u), crop(v), crop(h)
    f = params.coriolis_f
    g = params.gravity

    du = -uc * u_x - vc * u_y - g * h_x + f * vc
    dv = -uc * v_x - vc * v_y - g * h_y - f * uc
    dh = -hc * (u_x + v_y) - uc * h_x - vc * h_y

    nu = params.viscosity
    if nu != 0.0:
        idx2 = 1.0 / (grid.dx * grid.dx)
        idy2 = 1.0 / (grid.dy * grid.dy)

        def lap(fld, cen):
            return (shift(fld, 1, 0) - 2.0 * cen + shift(fld, -1, 0)) * idx2 + (
                shift(fld, 0, 1) - 2.0 * cen + shift(fld, 0, -1)) * idy2

        du = du + nu * lap(u, uc)
        dv = dv + nu * lap(v, vc)
    return du, dv, dh


def coriolis_field(grid: GridSpec, params: PhysicsParams, device) -> Tensor:
    """f = f0 + beta (y_norm - 1/2), shape (ny, 1)."""
    y, _ = grid.coords(device)
    y_norm = y / max(grid.ny - 1, 1)
    return params.coriolis_f + params.beta * (y_norm - 0.5)


def swe_tendencies(s: WeatherState, grid: GridSpec,
                   params: PhysicsParams) -> WeatherState:
    """Nonlinear SWE tendencies on whole-domain fields."""
    p = params
    if params.beta != 0.0:
        p = params.replace(coriolis_f=coriolis_field(grid, params, s.device))
    pad, shift, crop = pad_and_shift(grid.bc, grid.ny, grid.nx)
    up, vp, hp = pad(s.u), pad(s.v), pad(s.h)
    if grid.bc == "reflective":
        # wall-normal velocity ghost flips sign (no-flux wall): u at the x
        # walls, v at the y walls; corners get one flip per component.
        up[..., :, 0] *= -1.0
        up[..., :, -1] *= -1.0
        vp[..., 0, :] *= -1.0
        vp[..., -1, :] *= -1.0
    du, dv, dh = swe_tendencies_from_shifts(
        up, vp, hp, shift, grid, p, interior=crop
    )
    return WeatherState(u=du, v=dv, h=dh)


def diagnostics(s: WeatherState, grid: GridSpec) -> dict[str, Tensor]:
    """vorticity = dv/dx - du/dy, divergence = du/dx + dv/dy."""
    return {
        "vorticity": d_dx(s.v, grid.dx, grid.bc) - d_dy(s.u, grid.dy, grid.bc),
        "divergence": d_dx(s.u, grid.dx, grid.bc) + d_dy(s.v, grid.dy, grid.bc),
    }


def make_tendency_fn(model: str, grid: GridSpec, params: PhysicsParams
                     ) -> Callable[[WeatherState], WeatherState]:
    grid.validate()
    if model in ("shallow_water", "general"):
        if grid.grid_type == "staggered":
            from njw_tpu_torch.weather.staggered import swe_tendencies_cgrid

            return lambda s: swe_tendencies_cgrid(s, grid, params)
        return lambda s: swe_tendencies(s, grid, params)
    if model == "barotropic":
        from njw_tpu_torch.weather.barotropic import barotropic_tendencies

        return lambda s: barotropic_tendencies(s, grid, params)
    if model == "primitive":
        from njw_tpu_torch.weather.primitive import pe_tendencies

        return lambda s: pe_tendencies(s, grid, params)
    raise ValueError(f"unknown model: {model!r}")
