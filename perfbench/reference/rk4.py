"""Classic RK4 over fields padded with the halo a step needs.

A tendency here maps fields padded by one cell to the interior: a
(..., H, W) field gives a (..., H - 2, W - 2) tendency. One RK4 step of
fields padded by four cells then gives the (..., H - 8, W - 8) interior,
and ``advance`` pads the whole periodic domain by four cells before each
step.
"""
from __future__ import annotations

from typing import Callable

import torch

Fields = dict  # name -> tensor, (..., H, W)
HALO_PER_STEP = 4


def crop(a: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return a
    return a[..., n:a.shape[-2] - n, n:a.shape[-1] - n]


def wrap_rows_cols(a: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """a[..., rows % ny, :][..., cols % nx]: any window of a periodic
    field."""
    ny, nx = a.shape[-2:]
    a = a.index_select(a.dim() - 2, torch.remainder(rows, ny).to(a.device))
    return a.index_select(a.dim() - 1, torch.remainder(cols, nx).to(a.device))


def periodic_region(fields: Fields, y0: int, y1: int, x0: int, x1: int,
                    halo: int) -> Fields:
    """The rows y0..y1 and columns x0..x1 (ends excluded) of periodic
    fields, with ``halo`` cells more on every side."""
    rows = torch.arange(y0 - halo, y1 + halo)
    cols = torch.arange(x0 - halo, x1 + halo)
    return {k: wrap_rows_cols(a, rows, cols).contiguous()
            for k, a in fields.items()}


def pad_periodic(fields: Fields, n: int) -> Fields:
    out = {}
    for k, a in fields.items():
        ny, nx = a.shape[-2:]
        out[k] = periodic_region({k: a}, 0, ny, 0, nx, n)[k]
    return out


def rk4_step(s: Fields, tendency: Callable[[Fields], Fields],
             dt: float) -> Fields:
    """One classic RK4 step, s + dt/6 (k1 + 2 k2 + 2 k3 + k4), of fields
    padded by four cells; returns the interior."""
    def axpy(base, a, k):
        return {n: base[n] + a * k[n] for n in k}

    k1 = tendency(s)
    k2 = tendency(axpy({n: crop(x, 1) for n, x in s.items()}, 0.5 * dt, k1))
    k3 = tendency(axpy({n: crop(x, 2) for n, x in s.items()}, 0.5 * dt, k2))
    k4 = tendency(axpy({n: crop(x, 3) for n, x in s.items()}, dt, k3))
    return {n: crop(s[n], 4) + (dt / 6.0) * (
        crop(k1[n], 3) + 2.0 * crop(k2[n], 2) + 2.0 * crop(k3[n], 1)
        + k4[n]) for n in s}


def advance(s: Fields, steps: int, tendency, dt: float,
            storage=None) -> Fields:
    """``steps`` RK4 steps of the whole periodic domain ``s`` (padded
    before each step). ``storage``: a dtype the state is rounded to after
    every step (a state kept in a narrower type than the arithmetic), or
    None."""
    for _ in range(steps):
        s = pad_periodic(s, HALO_PER_STEP)
        s = rk4_step(s, tendency, dt)
        if storage is not None:
            s = {k: a.to(storage).to(a.dtype) for k, a in s.items()}
    return s
