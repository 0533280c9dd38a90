"""Barotropic vorticity core in plain PyTorch.

Counterpart of ``njw_tpu/weather/barotropic.py``:

    d zeta / dt = -J(psi, zeta) - beta v + nu Laplacian(zeta)
    Laplacian(psi) = zeta,   u = -dpsi/dy,  v = dpsi/dx

J is Arakawa's (1966) energy- and enstrophy-conserving 9-point Jacobian;
the streamfunction comes from the spectral Poisson solve whose symbol is
the 5-point Laplacian's (``ops/spectral.py``). The state is zeta alone,
(ny, nx), periodic; everything else is diagnosed.
"""
from __future__ import annotations

from typing import ClassVar

import torch

from njw_tpu_torch.ops.spectral import poisson_solve
from njw_tpu_torch.utils import profiling
from njw_tpu_torch.utils.pytree import pytree_dataclass
from njw_tpu_torch.weather.dynamics import d_dx, d_dy, diagnostics, laplacian
from njw_tpu_torch.weather.grid import FieldState, GridSpec, PhysicsParams


@pytree_dataclass
class BarotropicState(FieldState):
    FIELDS: ClassVar[tuple[str, ...]] = ("zeta",)

    zeta: torch.Tensor  # relative vorticity (ny, nx)


def _sh(f: torch.Tensor, dx_: int, dy_: int) -> torch.Tensor:
    """f[j + dy_, i + dx_] with periodic wrap (x is the minor axis)."""
    out = f
    if dx_:
        out = torch.roll(out, -dx_, dims=-1)
    if dy_:
        out = torch.roll(out, -dy_, dims=-2)
    return out


def arakawa_jacobian(p: torch.Tensor, z: torch.Tensor, dx: float,
                     dy: float) -> torch.Tensor:
    """J(p, z) = dp/dx dz/dy - dp/dy dz/dx as Arakawa's (J1 + J2 + J3)/3."""
    pE, pW = _sh(p, 1, 0), _sh(p, -1, 0)
    pN, pS = _sh(p, 0, 1), _sh(p, 0, -1)
    pNE, pNW = _sh(p, 1, 1), _sh(p, -1, 1)
    pSE, pSW = _sh(p, 1, -1), _sh(p, -1, -1)
    zE, zW = _sh(z, 1, 0), _sh(z, -1, 0)
    zN, zS = _sh(z, 0, 1), _sh(z, 0, -1)
    zNE, zNW = _sh(z, 1, 1), _sh(z, -1, 1)
    zSE, zSW = _sh(z, 1, -1), _sh(z, -1, -1)

    j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW)
    j2 = (pE * (zNE - zSE) - pW * (zNW - zSW)
          - pN * (zNE - zNW) + pS * (zSE - zSW))
    j3 = (zN * (pNE - pNW) - zS * (pSE - pSW)
          - zE * (pNE - pSE) + zW * (pNW - pSW))
    return (j1 + j2 + j3) / (12.0 * dx * dy)


def invert_vorticity(zeta: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """psi with Laplacian(psi) = zeta (periodic, zero mean)."""
    return poisson_solve(zeta, grid.dx, grid.dy, kind="laplacian5")


def velocities(psi: torch.Tensor, grid: GridSpec):
    return -d_dy(psi, grid.dy, "periodic"), d_dx(psi, grid.dx, "periodic")


def barotropic_tendencies(s: BarotropicState, grid: GridSpec,
                          params: PhysicsParams) -> BarotropicState:
    if grid.bc != "periodic":
        raise NotImplementedError("barotropic core requires periodic BC")
    zeta = s.zeta
    psi = invert_vorticity(zeta, grid)
    dzeta = -arakawa_jacobian(psi, zeta, grid.dx, grid.dy)
    if params.beta != 0.0:
        dzeta = dzeta - params.beta * d_dx(psi, grid.dx, "periodic")
    if params.viscosity != 0.0:
        dzeta = dzeta + params.viscosity * laplacian(zeta, grid.dx, grid.dy,
                                                     "periodic")
    return BarotropicState(zeta=dzeta)


def make_barotropic_sim(sim_cls, config, initial_condition: str, *, device,
                        **ic_params):
    """A ``Simulation`` whose state is a ``BarotropicState``.

    zeta0 is diagnosed from the named IC's velocities (dv/dx - du/dy), so
    every SWE initial condition can start the core."""
    from njw_tpu_torch.ops.baro_stencil import (
        baro_kernel_supported, make_baro_kernel_rk4_stepper,
    )
    from njw_tpu_torch.weather.ics import make_initial_state
    from njw_tpu_torch.weather.model import kernel_stepper_factory

    grid = config.grid_spec()
    params = config.physics()
    if config.integration_method == "semi_implicit":
        raise ValueError(
            "semi_implicit applies to models with fast gravity-wave "
            "modes (shallow_water, primitive); the barotropic vorticity "
            "equation has none, and its CFL limit is already advective. "
            "Use rk4/rk2/adams_bashforth.")
    with profiling.span("sim.build.state"):
        gen = torch.Generator().manual_seed(config.random_seed)
        full0 = make_initial_state(initial_condition, grid, device=device,
                                   generator=gen, **ic_params)
        state0 = BarotropicState(zeta=diagnostics(full0, grid)["vorticity"])

    factory = kernel_stepper_factory(
        config, device,
        baro_kernel_supported(grid, params)
        and config.integration_method == "rk4",
        lambda: make_baro_kernel_rk4_stepper(grid, params, config.dt),
        "barotropic + rk4 + periodic BC + numeric beta and viscosity")

    def output_fn(s):
        psi = invert_vorticity(s.zeta, grid)
        u, v = velocities(psi, grid)
        return {"zeta": s.zeta, "psi": psi, "u": u, "v": v}

    sim = sim_cls(state0, lambda s: barotropic_tendencies(s, grid, params),
                  dt=config.dt, method=config.integration_method, grid=grid,
                  stepper_factory=factory, output_fn=output_fn)
    sim.config = config
    return sim
