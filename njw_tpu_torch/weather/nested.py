"""Two-way nested (refined) grids for the shallow-water core.

Counterpart of ``njw_tpu/weather/nested.py``:

* A rectangular refinement patch runs at ``ratio`` x finer spacing and
  ``ratio`` x smaller dt.
* Prolongation (coarse -> fine patch and its ghost ring) is bilinear,
  built from phase-wise slice blends; restriction (fine -> coarse
  feedback) is a box average by reshape.
* One coarse step: step the coarse grid, then run the ``ratio`` fine
  substeps with the ghost ring interpolated linearly in time between the
  bracketing coarse states, then overwrite the coarse cells under the
  patch with the restricted fine solution (two-way feedback).

The state is a ``NestedState`` (coarse and fine ``WeatherState``s) and
the stepper an ordinary ``Stepper``, so ``Simulation`` drives it
unchanged. A multi-step method's carry (AB2's previous tendency) threads
through the fine substeps and across the coarse steps.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Iterator

import numpy as np
import torch

from njw_tpu_torch.weather.dynamics import (
    make_tendency_fn, swe_tendencies_from_shifts,
)
from njw_tpu_torch.weather.grid import (
    FieldState, GridSpec, PhysicsParams, WeatherState,
)
from njw_tpu_torch.weather.integrators import Stepper, make_stepper

_SWE = ("u", "v", "h")


@dataclasses.dataclass(frozen=True)
class NestedState(FieldState):
    """The coarse grid's state and the fine patch's (u, v, h each)."""

    FIELDS: ClassVar[tuple[str, ...]] = ("coarse", "fine")

    coarse: WeatherState
    fine: WeatherState

    def items(self) -> Iterator[tuple[str, torch.Tensor]]:
        for part in self.FIELDS:
            for name, t in getattr(self, part).items():
                yield f"{part}_{name}", t

    def map(self, fn, *others):
        return NestedState(
            coarse=self.coarse.map(fn, *(o.coarse for o in others)),
            fine=self.fine.map(fn, *(o.fine for o in others)))


def _upsample1d_weights(ratio: int):
    """Per phase (offset, w) of centre-aligned bilinear upsampling: fine
    phase p sits at coarse coordinate (p + 0.5) / ratio - 0.5 from its
    base coarse cell."""
    out = []
    for p in range(ratio):
        x = (p + 0.5) / ratio - 0.5
        i0 = int(np.floor(x))
        out.append((i0, x - i0))
    return out


def _upsample_axis(f: torch.Tensor, ratio: int, axis: int) -> torch.Tensor:
    """Bilinear upsampling along one axis (negative ``axis``) of a field
    padded by one cell each side: length n in, ratio * (n - 2) out."""
    n = f.shape[axis]
    phases = []
    for i0, w in _upsample1d_weights(ratio):
        # the base index runs over cells 1 .. n-2; i0 is -1 or 0
        lo = f.narrow(axis, 1 + i0, n - 2)
        hi = f.narrow(axis, 2 + i0, n - 2)
        phases.append((1.0 - w) * lo + w * hi)
    ax = f.ndim + axis
    stacked = torch.stack(phases, dim=ax + 1)
    shp = list(stacked.shape)
    shp[ax:ax + 2] = [shp[ax] * shp[ax + 1]]
    return stacked.reshape(shp)


class NestedGrid:
    """Geometry and transfer operators of one rectangular patch:
    ``patch = (y0, y1, x0, x1)`` in coarse-cell indices (half-open), at
    least 2 coarse cells from every edge of the domain."""

    def __init__(self, grid: GridSpec, patch, ratio: int = 2):
        y0, y1, x0, x1 = patch
        if not (2 <= y0 < y1 <= grid.ny - 2 and 2 <= x0 < x1 <= grid.nx - 2):
            raise ValueError(
                "patch must be inside the domain with >= 2 cells margin")
        self.grid = grid
        self.patch = (y0, y1, x0, x1)
        self.ratio = int(ratio)
        self.py, self.px = y1 - y0, x1 - x0
        self.nyf, self.nxf = self.py * ratio, self.px * ratio
        self.fine_grid = GridSpec(
            nx=self.nxf, ny=self.nyf, levels=grid.levels,
            dx=grid.dx / ratio, dy=grid.dy / ratio, bc="clamped",
            grid_type=grid.grid_type)

    def prolong_frame(self, f: torch.Tensor) -> torch.Tensor:
        """A coarse field interpolated onto the fine patch and its one-cell
        ghost ring: (nyf + 2, nxf + 2)."""
        y0, y1, x0, x1 = self.patch
        r = self.ratio
        # the coarse window with 2 extra cells each side: the support of
        # the bilinear ghost ring
        win = f[..., y0 - 2:y1 + 2, x0 - 2:x1 + 2]
        up = _upsample_axis(_upsample_axis(win, r, -1), r, -2)
        # up covers coarse cells [y0-1, y1+1): the frame starts r-1 in
        o = r - 1
        return up[..., o:o + self.nyf + 2, o:o + self.nxf + 2]

    def prolong(self, f: torch.Tensor) -> torch.Tensor:
        """Coarse field -> fine patch interior (nyf, nxf)."""
        return self.prolong_frame(f)[..., 1:-1, 1:-1]

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        """Fine patch -> the coarse cells under it (box average)."""
        r = self.ratio
        shp = f.shape[:-2] + (self.py, r, self.px, r)
        return f.reshape(shp).mean(dim=(-3, -1))

    def feedback(self, coarse_f: torch.Tensor,
                 fine_f: torch.Tensor) -> torch.Tensor:
        """A new coarse field with the restricted fine field under the
        patch."""
        y0, y1, x0, x1 = self.patch
        out = coarse_f.clone()
        out[..., y0:y1, x0:x1] = self.restrict(fine_f)
        return out


def make_nested_swe_stepper(grid: GridSpec, params: PhysicsParams,
                            nest: NestedGrid, dt: float,
                            method: str = "rk4") -> Stepper:
    """Stepper over NestedState: a coarse step, ``ratio`` fine substeps
    with ghost rings interpolated in time, and two-way feedback."""
    coarse_stepper = make_stepper(
        method, make_tendency_fn("shallow_water", grid, params))
    r = nest.ratio
    fg = nest.fine_grid

    def fine_rhs(s: WeatherState, boundary: WeatherState) -> WeatherState:
        """The fine tendency: interior from ``s``, ghost ring from the
        prolonged frames of ``boundary``."""
        frames = {}
        for name in _SWE:
            frame = getattr(boundary, name).clone()
            frame[..., 1:-1, 1:-1] = getattr(s, name)
            frames[name] = frame
        ny, nx = fg.ny, fg.nx

        def shift(f, dxi=0, dyi=0):
            # the field is known by identity; any other tensor would read
            # the wrong ghost frame, so it is refused
            for name in _SWE:
                if f is getattr(s, name):
                    return frames[name][..., 1 + dyi:1 + dyi + ny,
                                        1 + dxi:1 + dxi + nx]
            raise ValueError(
                "nested shift got a tensor that is not the state's "
                "u/v/h; add a ghost frame for new fields")

        du, dv, dh = swe_tendencies_from_shifts(s.u, s.v, s.h, shift, fg,
                                                params)
        return WeatherState(u=du, v=dv, h=dh)

    def frames_of(cs: WeatherState) -> WeatherState:
        return WeatherState(**{n: nest.prolong_frame(getattr(cs, n))
                               for n in _SWE})

    def fine_stepper_for(bnd):
        return make_stepper(method, lambda sf: fine_rhs(sf, bnd))

    def init(s: NestedState):
        return (coarse_stepper.init(s.coarse),
                fine_stepper_for(frames_of(s.coarse)).init(s.fine))

    def step(carry, s: NestedState, dt_in):
        c_carry, f_carry = carry
        c_carry, coarse_new = coarse_stepper.step(c_carry, s.coarse, dt_in)
        b0, b1 = frames_of(s.coarse), frames_of(coarse_new)
        # dt and theta in float32, as the JAX substep scan computes them
        dt_f = float(np.float32(dt_in) / np.float32(r))
        fine = s.fine
        for k in range(r):
            theta = float((np.float32(k) + np.float32(0.5)) / np.float32(r))
            bnd = b0.map(lambda a, b: a + theta * (b - a), b1)
            f_carry, fine = fine_stepper_for(bnd).step(f_carry, fine, dt_f)
        coarse_fb = WeatherState(**{
            n: nest.feedback(getattr(coarse_new, n), getattr(fine, n))
            for n in _SWE})
        return (c_carry, f_carry), NestedState(coarse=coarse_fb, fine=fine)

    return Stepper(init, step, "nested_" + method, 2)


def make_nested_sim(sim_cls, config, initial_condition: str, patch,
                    ratio: int = 2, **ic_params):
    """A Simulation whose state is a NestedState (shallow water only),
    the fine patch started from the prolonged coarse initial state.
    Snapshots hold the coarse fields and the fine patch's."""
    from njw_tpu_torch.platform.device import require_device
    from njw_tpu_torch.weather.ics import make_initial_state

    device = require_device(config.device)
    grid = config.grid_spec()
    params = config.physics()
    nest = NestedGrid(grid, patch, ratio)
    gen = torch.Generator().manual_seed(config.random_seed)
    full0 = make_initial_state(initial_condition, grid, device=device,
                               generator=gen, **ic_params)
    coarse0 = WeatherState(u=full0.u, v=full0.v, h=full0.h)
    fine0 = WeatherState(**{n: nest.prolong(getattr(coarse0, n))
                            for n in _SWE})
    state0 = NestedState(coarse=coarse0, fine=fine0)

    method = config.integration_method

    def stepper_factory(_tendency):
        return make_nested_swe_stepper(grid, params, nest, config.dt, method)

    def output_fn(s):
        return {"u": s.coarse.u, "v": s.coarse.v, "h": s.coarse.h,
                "fine_u": s.fine.u, "fine_v": s.fine.v, "fine_h": s.fine.h}

    sim = sim_cls(state0, lambda s: s, dt=config.dt, method=method,
                  grid=grid, stepper_factory=stepper_factory,
                  output_fn=output_fn)
    sim.config = config
    sim.nest = nest
    return sim
