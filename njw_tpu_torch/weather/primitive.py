"""Primitive-equations core (multi-level, sigma coordinates) in plain PyTorch.

Counterpart of ``njw_tpu/weather/primitive.py``: the hydrostatic primitive
equations on an f-plane in sigma = p/ps coordinates, L equally spaced full
levels sigma_k = (k + 1/2)/L (k = 0 at the model top), an optional terrain
lower boundary (surface geopotential ``phi_s``):

  continuity   dps/dt = -sum_k div(ps u_k) dsig
  sigma-dot    (sigdot ps)_{k+1/2} = -sig_{k+1/2} dps/dt
                                     - sum_{j<=k} div(ps u_j) dsig
  momentum     du/dt = -u u_x - v u_y - sigdot du/dsig + f v
                       - dPhi/dx - R T dlnps/dx          (v analogous)
  thermo       dT/dt = -u.grad(T) - sigdot dT/dsig
                       + kappa T (sigdot/sigma + D lnps/Dt)
  moisture     dq/dt = -u.grad(q) - sigdot dq/dsig
  hydrostatic  Phi_k = Phi_{k+1} + R (T_k + T_{k+1})/2 ln(sig_{k+1}/sig_k),
               Phi_{L-1} = phi_s + R T_{L-1} ln(1/sig_{L-1})

Central differences horizontally, written once against a shift accessor
(``pe_tendencies_from_shifts``) as in the JAX package; vertical advection
in interface form with sigdot = 0 at sigma = 0, 1. Shapes: u, v, T, q are
(L, ny, nx), ps is (ny, nx).
"""
from __future__ import annotations

from typing import Callable, ClassVar, Optional

import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.utils.pytree import pytree_dataclass
from njw_tpu_torch.weather.dynamics import pad_and_shift
from njw_tpu_torch.weather.grid import FieldState, GridSpec, PhysicsParams

R_DRY = 287.04      # J / (kg K)
CP_DRY = 1004.64    # J / (kg K)
KAPPA = R_DRY / CP_DRY

PE_ICS = ("baroclinic", "default", "uniform", "resting")


@pytree_dataclass
class PEState(FieldState):
    FIELDS: ClassVar[tuple[str, ...]] = ("u", "v", "T", "q", "ps")

    u: torch.Tensor   # (L, ny, nx)
    v: torch.Tensor
    T: torch.Tensor
    q: torch.Tensor
    ps: torch.Tensor  # (ny, nx)


def sigma_levels(L: int, device="cuda"):
    """Full levels (k + 1/2)/L (k = 0 at the top) and interfaces k/L, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = require_device(device)
    full = (torch.arange(L, dtype=torch.float32, device=device) + 0.5) / L
    half = torch.arange(L + 1, dtype=torch.float32, device=device) / L
    return full, half


def hydrostatic_geopotential(T: torch.Tensor, L: int,
                             phi_s=None) -> torch.Tensor:
    """Phi at full levels, integrated upward from the bottom level L-1;
    ``phi_s`` is the surface geopotential (None: a flat lower boundary)."""
    sig, _ = sigma_levels(L, T.device)
    ln_ratio = torch.log(sig[1:] / sig[:-1])        # ln(sig_{k+1}/sig_k)
    phi_bot = R_DRY * T[-1] * (-torch.log(sig[-1]))
    if phi_s is not None:
        phi_bot = phi_bot + phi_s
    thick = R_DRY * 0.5 * (T[:-1] + T[1:]) * ln_ratio[:, None, None]
    below = torch.flip(torch.cumsum(torch.flip(thick, (0,)), 0), (0,))
    return torch.cat([phi_bot[None] + below, phi_bot[None]], dim=0)


def pe_tendencies_from_shifts(s: PEState, shift: Callable, grid: GridSpec,
                              params: PhysicsParams,
                              interior: Optional[Callable] = None,
                              phi_s=None) -> PEState:
    """PE tendencies given a neighbour-shift accessor (it broadcasts over
    the leading level axis). ``phi_s``: the surface geopotential padded
    like the state fields, or None."""
    crop = interior if interior is not None else (lambda f: f)
    L = s.u.shape[0]
    dsig = 1.0 / L
    sig, sig_half = sigma_levels(L, s.u.device)
    cx = 0.5 / grid.dx
    cy = 0.5 / grid.dy
    f = params.coriolis_f

    def ddx(a):
        return (shift(a, 1, 0) - shift(a, -1, 0)) * cx

    def ddy(a):
        return (shift(a, 0, 1) - shift(a, 0, -1)) * cy

    u, v, T, q, ps = s.u, s.v, s.T, s.q, s.ps
    uc, vc, Tc, qc = crop(u), crop(v), crop(T), crop(q)
    psc = crop(ps)
    lnps = torch.log(ps)

    # continuity and sigma-dot
    flux_div = ddx(ps * u) + ddy(ps * v)             # (L, ly, lx)
    dps = -torch.sum(flux_div, dim=0) * dsig
    cum = torch.cumsum(flux_div, dim=0) * dsig       # sum_{j<=k}
    sdot_ps_int = -sig_half[1:-1, None, None] * dps[None] - cum[:-1]
    sdot_int = sdot_ps_int / psc[None]               # interfaces 1..L-1
    zeros = torch.zeros_like(sdot_int[:1])
    sdot_half = torch.cat([zeros, sdot_int, zeros], dim=0)  # (L+1, ...)

    def vadv(X):
        # (sigdot dX/dsig)_k ~ [sd_{k+1/2}(X_{k+1} - X_k)
        #                      + sd_{k-1/2}(X_k - X_{k-1})] / (2 dsig)
        upper = sdot_half[1:-1] * (X[1:] - X[:-1])
        pad = torch.zeros_like(X[:1])
        return (torch.cat([upper, pad], dim=0)
                + torch.cat([pad, upper], dim=0)) * (0.5 / dsig)

    # geopotential and pressure-gradient force
    phi = hydrostatic_geopotential(T, L, phi_s=phi_s)
    phi_x, phi_y = ddx(phi), ddy(phi)
    lnps_x, lnps_y = ddx(lnps), ddy(lnps)

    du = (-uc * ddx(u) - vc * ddy(u) - vadv(uc)
          + f * vc - phi_x - R_DRY * Tc * lnps_x)
    dv = (-uc * ddx(v) - vc * ddy(v) - vadv(vc)
          - f * uc - phi_y - R_DRY * Tc * lnps_y)

    # omega/p = sigdot/sig + D lnps/Dt, with the level's own advection
    dlnps_adv = dps[None] / psc[None] + uc * lnps_x + vc * lnps_y
    sdot_full = 0.5 * (sdot_half[:-1] + sdot_half[1:])
    omega_over_p = sdot_full / sig[:, None, None] + dlnps_adv
    dT = -uc * ddx(T) - vc * ddy(T) - vadv(Tc) + KAPPA * Tc * omega_over_p
    dq = -uc * ddx(q) - vc * ddy(q) - vadv(qc)

    nu = params.viscosity
    if nu != 0.0:
        idx2, idy2 = 1.0 / grid.dx ** 2, 1.0 / grid.dy ** 2

        def lap(a, ac):
            return (shift(a, 1, 0) - 2 * ac + shift(a, -1, 0)) * idx2 + (
                shift(a, 0, 1) - 2 * ac + shift(a, 0, -1)) * idy2

        du = du + nu * lap(u, uc)
        dv = dv + nu * lap(v, vc)
        dT = dT + nu * lap(T, Tc)

    return PEState(u=du, v=dv, T=dT, q=dq, ps=dps)


def pe_tendencies(s: PEState, grid: GridSpec, params: PhysicsParams,
                  phi_s=None) -> PEState:
    """Whole-domain PE tendencies under the grid's boundary condition;
    ``phi_s``: (ny, nx) surface geopotential, or None (flat)."""
    pad, shift, crop = pad_and_shift(grid.bc, grid.ny, grid.nx)
    up, vp = pad(s.u), pad(s.v)
    if grid.bc == "reflective":
        # no-flux walls: the wall-normal velocity's ghost flips sign (u at
        # the x walls, v at the y walls), as in the SWE core; the scalars
        # keep the clamped ghost of pad_and_shift
        up[..., :, 0] *= -1.0
        up[..., :, -1] *= -1.0
        vp[..., 0, :] *= -1.0
        vp[..., -1, :] *= -1.0
    padded = PEState(u=up, v=vp, T=pad(s.T), q=pad(s.q), ps=pad(s.ps))
    phi_sp = pad(phi_s) if phi_s is not None else None
    return pe_tendencies_from_shifts(padded, shift, grid, params,
                                     interior=crop, phi_s=phi_sp)


def pe_initial_state(grid: GridSpec, *, device="cuda", T0: float = 288.15,
                     ps0: float = 1013.25, u_jet: float = 10.0,
                     lapse: float = 50.0, deltaT_y: float = 20.0,
                     perturb: float = 0.0, seed: int = 0,
                     phi_s=None) -> PEState:
    """Baroclinic-jet state: a zonal jet at mid-latitude, stronger aloft,
    with a thermally consistent meridional T gradient, T rising by
    ``lapse`` K down the column, and an optional random ps perturbation.
    The perturbation draws from a ``torch.Generator`` seeded with
    ``seed``; it cannot reproduce JAX's threefry bits. The state is made
    on ``device``: CUDA unless the caller asks for the CPU."""
    device = require_device(device)
    L, ny, nx = grid.levels, grid.ny, grid.nx
    sig, _ = sigma_levels(L, device)
    y = torch.arange(ny, dtype=torch.float32, device=device)[:, None] \
        / max(ny - 1, 1)
    yx = y.expand(ny, nx)

    jet_profile = torch.exp(-((yx - 0.5) ** 2) / 0.02)
    height_factor = (1.0 - sig)[:, None, None]
    u = u_jet * jet_profile[None] * (0.5 + height_factor)
    v = torch.zeros_like(u)
    T = (T0 - deltaT_y * (yx - 0.5)[None]
         + lapse * (sig[:, None, None] - 0.5))
    q = 0.01 * (1.0 - yx)[None] * sig[:, None, None]

    ps = torch.full((ny, nx), ps0, dtype=torch.float32, device=device)
    if phi_s is not None:
        # hydrostatic surface-pressure reduction over terrain
        ps = ps * torch.exp(-phi_s / (R_DRY * T0))
    if perturb:
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn((ny, nx), generator=gen, dtype=torch.float32)
        ps = ps + perturb * noise.to(device)
    return PEState(u=u.contiguous(), v=v, T=T.contiguous(),
                   q=q.contiguous(), ps=ps)


def make_primitive_sim(sim_cls, config, initial_condition: str = "baroclinic",
                       *, device, orography=None, **ic_params):
    """A ``Simulation`` whose state is a ``PEState``. ``initial_condition``
    is 'baroclinic' (alias 'default', 'uniform') or 'resting';
    ``orography``: optional (ny, nx) surface geopotential (terrain)."""
    from njw_tpu_torch.ops.pe_stencil import (
        make_pe_kernel_rk4_stepper, pe_kernel_supported,
    )
    from njw_tpu_torch.weather.model import kernel_stepper_factory

    grid = config.grid_spec()
    grid.validate()
    if grid.levels < 2:
        # one level has no interior interface: sigma-dot and the T
        # tendency come out empty (the JAX package fails with IndexError)
        raise ValueError("the primitive-equation core needs at least 2 "
                         f"sigma levels, got {grid.levels}")
    params = config.physics()
    phi_s = None if orography is None else torch.as_tensor(
        orography, dtype=torch.float32).to(device).contiguous()
    ic_params = dict(ic_params)
    if phi_s is not None:
        ic_params.setdefault("phi_s", phi_s)
    if initial_condition not in PE_ICS:
        raise ValueError(f"unknown PE initial condition {initial_condition!r} "
                         "(use 'baroclinic' or 'resting')")
    if initial_condition == "resting":
        for name in ("u_jet", "lapse", "deltaT_y"):
            ic_params.setdefault(name, 0.0)
    state0 = pe_initial_state(grid, device=device, **ic_params)

    factory = kernel_stepper_factory(
        config, device,
        pe_kernel_supported(grid, params)
        and config.integration_method == "rk4",
        lambda: make_pe_kernel_rk4_stepper(grid, params, config.dt,
                                           phi_s=phi_s),
        "primitive + rk4 + periodic BC + L >= 2 + numeric f, beta = 0, "
        "viscosity = 0")
    if config.integration_method == "semi_implicit":
        # after the kernel factory, which refuses backend='kernel' for SI
        from njw_tpu_torch.weather.semi_implicit import semi_implicit_pe

        def factory(t):
            return semi_implicit_pe(t, grid=grid, params=params,
                                    order=config.si_order)

    def output_fn(s):
        return dict(s.items())

    sim = sim_cls(state0, lambda s: pe_tendencies(s, grid, params, phi_s=phi_s),
                  dt=config.dt, method=config.integration_method, grid=grid,
                  stepper_factory=factory, output_fn=output_fn)
    sim.config = config
    return sim
