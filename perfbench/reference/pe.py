"""Plain primitive-equations reference: the hydrostatic primitive
equations the port solves, written again in plain PyTorch, independent of
the port.

Sigma coordinates with L equally spaced full levels sigma_k = (k + 1/2)/L
(k = 0 at the top), interfaces k/L, an f-plane, a flat lower boundary:

  continuity   dps/dt = -sum_k div(ps u_k) dsig
  sigma-dot    (sigdot ps)_{k+1/2} = -sig_{k+1/2} dps/dt
                                     - sum_{j<=k} div(ps u_j) dsig
  momentum     du/dt = -u u_x - v u_y - sigdot du/dsig + f v
                       - dPhi/dx - R T dlnps/dx          (v alike)
  thermo       dT/dt = -u.grad(T) - sigdot dT/dsig
                       + kappa T (sigdot/sigma + D lnps/Dt)
  moisture     dq/dt = -u.grad(q) - sigdot dq/dsig
  hydrostatic  Phi_k = Phi_{k+1} + R (T_k + T_{k+1})/2 ln(sig_{k+1}/sig_k),
               Phi_{L-1} = R T_{L-1} ln(1/sig_{L-1})

with central differences on a periodic grid, vertical advection in
interface form with sigdot = 0 at sigma = 0 and 1, advanced by classic
RK4 (``rk4.py``). The initial condition is the baroclinic jet the
configuration names: a zonal jet at mid-latitude, stronger aloft, a
meridional T gradient, T rising by ``lapse`` K down the column, q
decreasing poleward, and ps = ps0 plus ``perturb`` times standard normals
drawn on the host from ``torch.Generator().manual_seed(seed)`` (the draw
the configuration states). u, v, T, q are (L, ny, nx), ps is (ny, nx).
Everything is computed in ``dtype``: float32 for the reference, bfloat16
for the control (``storage``: the state rounded to that type after every
step, the arithmetic in ``dtype``).
"""
from __future__ import annotations

import torch

from perfbench.reference import rk4

FIELDS = ("u", "v", "T", "q", "ps")
R_DRY = 287.04
CP_DRY = 1004.64
KAPPA = R_DRY / CP_DRY


def check_config(sim: dict) -> None:
    if sim.get("boundary_condition", "periodic") != "periodic":
        raise ValueError("reference pe: periodic boundaries only")
    for key in ("beta", "viscosity"):
        if float(sim.get(key, 0.0)) != 0.0:
            raise ValueError(f"reference pe: {key} must be 0")
    if sim.get("integration_method", "rk4") != "rk4":
        raise ValueError("reference pe: rk4 only")
    if int(sim["num_levels"]) < 2:
        raise ValueError("reference pe: at least 2 levels")


def sigma(L: int, device, dtype=torch.float32):
    full = (torch.arange(L, dtype=torch.float32, device=device) + 0.5) / L
    half = torch.arange(L + 1, dtype=torch.float32, device=device) / L
    return full.to(dtype), half.to(dtype)


def baroclinic(ny: int, nx: int, L: int, device, T0=288.15, ps0=1013.25,
               u_jet=10.0, lapse=50.0, deltaT_y=20.0, perturb=0.0,
               seed=0) -> rk4.Fields:
    sig, _ = sigma(L, device)
    y = torch.arange(ny, dtype=torch.float32, device=device)[:, None] \
        / max(ny - 1, 1)
    yx = y.expand(ny, nx)
    jet = torch.exp(-((yx - 0.5) ** 2) / 0.02)
    aloft = (1.0 - sig)[:, None, None]
    u = u_jet * jet[None] * (0.5 + aloft)
    T = T0 - deltaT_y * (yx - 0.5)[None] + lapse * (sig[:, None, None] - 0.5)
    q = 0.01 * (1.0 - yx)[None] * sig[:, None, None]
    ps = torch.full((ny, nx), ps0, dtype=torch.float32, device=device)
    if perturb:
        gen = torch.Generator().manual_seed(int(seed))
        noise = torch.randn((ny, nx), generator=gen, dtype=torch.float32)
        ps = ps + perturb * noise.to(device)
    return {"u": u.contiguous(), "v": torch.zeros_like(u),
            "T": T.contiguous(), "q": q.contiguous(), "ps": ps}


INITIAL_CONDITIONS = {"baroclinic": baroclinic}


def tendency_fn(sim: dict, L: int, device, dtype):
    cx = 0.5 / float(sim["dx"])
    cy = 0.5 / float(sim["dy"])
    f = float(sim.get("coriolis_f", 0.0))
    dsig = 1.0 / L
    sig, half = sigma(L, device, dtype)
    ln_ratio = torch.log(sig[1:] / sig[:-1])[:, None, None]
    ln_bottom = -torch.log(sig[-1])
    s_int = half[1:-1, None, None]
    s_full = sig[:, None, None]

    def ddx(a):
        return (a[..., 1:-1, 2:] - a[..., 1:-1, :-2]) * cx

    def ddy(a):
        return (a[..., 2:, 1:-1] - a[..., :-2, 1:-1]) * cy

    def c(a):
        return rk4.crop(a, 1)

    def tendency(s):
        u, v, T, q, ps = (s[k] for k in FIELDS)
        uc, vc, Tc, qc, psc = c(u), c(v), c(T), c(q), c(ps)
        lnps = torch.log(ps)
        flux_div = ddx(ps * u) + ddy(ps * v)
        dps = -flux_div.sum(dim=0) * dsig
        cum = torch.cumsum(flux_div, dim=0) * dsig
        sdot_int = (-s_int * dps[None] - cum[:-1]) / psc[None]
        zero = torch.zeros_like(sdot_int[:1])
        sdot = torch.cat([zero, sdot_int, zero], dim=0)      # interfaces

        def vadv(X):
            jump = sdot[1:-1] * (X[1:] - X[:-1])
            pad = torch.zeros_like(X[:1])
            return (torch.cat([jump, pad]) + torch.cat([pad, jump])) \
                * (0.5 / dsig)

        # geopotential, integrated up from the bottom level
        bottom = R_DRY * T[-1] * ln_bottom
        thick = R_DRY * 0.5 * (T[:-1] + T[1:]) * ln_ratio
        above = torch.flip(torch.cumsum(torch.flip(thick, (0,)), 0), (0,))
        phi = torch.cat([bottom[None] + above, bottom[None]], dim=0)
        lnps_x, lnps_y = ddx(lnps), ddy(lnps)

        du = (-uc * ddx(u) - vc * ddy(u) - vadv(uc) + f * vc - ddx(phi)
              - R_DRY * Tc * lnps_x)
        dv = (-uc * ddx(v) - vc * ddy(v) - vadv(vc) - f * uc - ddy(phi)
              - R_DRY * Tc * lnps_y)
        omega_p = (0.5 * (sdot[:-1] + sdot[1:]) / s_full
                   + dps[None] / psc[None] + uc * lnps_x + vc * lnps_y)
        dT = -uc * ddx(T) - vc * ddy(T) - vadv(Tc) + KAPPA * Tc * omega_p
        dq = -uc * ddx(q) - vc * ddy(q) - vadv(qc)
        return {"u": du, "v": dv, "T": dT, "q": dq, "ps": dps}

    return tendency


def _start(sim: dict, ic: str, params: dict, device, dtype) -> rk4.Fields:
    check_config(sim)
    ny, nx = int(sim["grid_height"]), int(sim["grid_width"])
    s = INITIAL_CONDITIONS[ic](ny, nx, int(sim["num_levels"]), device,
                               **params)
    return {k: a.to(dtype) for k, a in s.items()}


def snapshots(sim: dict, ic: str, params: dict, steps: int, interval: int,
              device, dtype=torch.float32, storage=None):
    """Yield (step, fields) at every ``interval`` steps up to ``steps``."""
    s = _start(sim, ic, params, device, dtype)
    tendency = tendency_fn(sim, int(sim["num_levels"]), device, dtype)
    dt = float(sim["dt"])
    done = 0
    while done < steps:
        n = min(interval, steps - done)
        s = rk4.advance(s, n, tendency, dt, storage=storage)
        done += n
        yield done, dict(s)

