"""Plain shallow-water reference: the equations the port solves, written
again in plain PyTorch, independent of the port.

    du/dt = -u du/dx - v du/dy - g dh/dx + f v
    dv/dt = -u dv/dx - v dv/dy - g dh/dy - f u
    dh/dt = -h (du/dx + dv/dy) - u dh/dx - v dh/dy

on a periodic A-grid with central differences and a constant f, advanced
by classic RK4 (``rk4.py``). The snapshots carry u, v, h and the
diagnostics vorticity = dv/dx - du/dy and divergence = du/dx + dv/dy.
The vortex initial condition is the one the configuration names
(cyclostrophic balance inside a radius, normalised coordinates scaled by
n - 1, radii by min(nx, ny)). Everything is computed in ``dtype``: float32
for the reference, bfloat16 for the control (``storage``: the state
rounded to that type after every step, the arithmetic in ``dtype``).
"""
from __future__ import annotations

import torch

from perfbench.reference import rk4

FIELDS = ("u", "v", "h")


def check_config(sim: dict) -> None:
    """Refuse what this reference does not model."""
    if sim.get("boundary_condition", "periodic") != "periodic":
        raise ValueError("reference swe: periodic boundaries only")
    for key in ("beta", "viscosity"):
        if float(sim.get(key, 0.0)) != 0.0:
            raise ValueError(f"reference swe: {key} must be 0")
    if sim.get("integration_method", "rk4") != "rk4":
        raise ValueError("reference swe: rk4 only")


def vortex(ny: int, nx: int, device, x_center=0.5, y_center=0.5,
           radius=0.1, strength=10.0, h_mean=10.0) -> rk4.Fields:
    y = torch.arange(ny, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(nx, dtype=torch.float32, device=device)[None, :]
    dx = x - x_center * (nx - 1)
    dy = y - y_center * (ny - 1)
    r = torch.sqrt(dx * dx + dy * dy)
    rg = radius * min(nx, ny)
    rn = r / rg
    inside = (r > 0.0) & (r <= rg)
    w = torch.where(inside, strength * rn * torch.exp(1.0 - rn * rn),
                    torch.zeros_like(rn))
    h = torch.where(inside, h_mean - 0.5 * w * w / 9.81,
                    torch.full_like(rn, h_mean))
    r = torch.clamp_min(r, 1.0e-6)
    return {"u": -w * dy / r, "v": w * dx / r, "h": h}


INITIAL_CONDITIONS = {"vortex": vortex}


def tendency_fn(sim: dict):
    cx = 0.5 / float(sim.get("dx", 1.0))
    cy = 0.5 / float(sim.get("dy", 1.0))
    g = float(sim.get("gravity", 9.81))
    f = float(sim.get("coriolis_f", 0.0))

    def ddx(a):
        return (a[..., 1:-1, 2:] - a[..., 1:-1, :-2]) * cx

    def ddy(a):
        return (a[..., 2:, 1:-1] - a[..., :-2, 1:-1]) * cy

    def tendency(s):
        u, v, h = s["u"], s["v"], s["h"]
        uc, vc, hc = rk4.crop(u, 1), rk4.crop(v, 1), rk4.crop(h, 1)
        ux, uy, vx, vy = ddx(u), ddy(u), ddx(v), ddy(v)
        hx, hy = ddx(h), ddy(h)
        return {"u": -uc * ux - vc * uy - g * hx + f * vc,
                "v": -uc * vx - vc * vy - g * hy - f * uc,
                "h": -hc * (ux + vy) - uc * hx - vc * hy}

    return tendency


def outputs(s: rk4.Fields, sim: dict) -> rk4.Fields:
    """The fields of one snapshot: u, v, h, vorticity, divergence."""
    cx = 0.5 / float(sim.get("dx", 1.0))
    cy = 0.5 / float(sim.get("dy", 1.0))
    p = rk4.pad_periodic({"u": s["u"], "v": s["v"]}, 1)
    u, v = p["u"], p["v"]
    vx = (v[1:-1, 2:] - v[1:-1, :-2]) * cx
    vy = (v[2:, 1:-1] - v[:-2, 1:-1]) * cy
    ux = (u[1:-1, 2:] - u[1:-1, :-2]) * cx
    uy = (u[2:, 1:-1] - u[:-2, 1:-1]) * cy
    return {**s, "vorticity": vx - uy, "divergence": ux + vy}


def snapshots(sim: dict, ic: str, params: dict, steps: int, interval: int,
              device, dtype=torch.float32, storage=None):
    """Yield (step, snapshot fields) at every ``interval`` steps up to
    ``steps``, from the initial condition ``ic`` with ``params``."""
    check_config(sim)
    ny, nx = int(sim["grid_height"]), int(sim["grid_width"])
    s = INITIAL_CONDITIONS[ic](ny, nx, device, **params)
    s = {k: a.to(dtype) for k, a in s.items()}
    tendency = tendency_fn(sim)
    dt = float(sim["dt"])
    done = 0
    while done < steps:
        n = min(interval, steps - done)
        s = rk4.advance(s, n, tendency, dt, storage=storage)
        done += n
        yield done, outputs(s, sim)
