"""Fused RK4 step of the shallow-water core: CUDA kernel and plain version.

Counterpart of ``njw_tpu/ops/stencil.py`` (``swe_rk4_step_pallas``,
``make_pallas_rk4_stepper``, ``pallas_supported``). The kernel,
``csrc/swe_rk4.cu``, replaces the TPU kernel ``swe_rk4_kernel``: one whole
RK4 step (four central-difference SWE tendencies, the accumulator-form
combine, optional 5-point viscosity on u and v) for periodic float32
``(ny, nx)`` fields in one pass over device memory. Its source says what
bounds it and how its tiles are laid out.

``swe_rk4_step`` launches the kernel for CUDA tensors. For CPU tensors it
runs ``swe_rk4_step_plain``, the same function in plain PyTorch (the
counterpart of Pallas interpret mode); the tests use it, and the chip
smoke test holds the kernel against it. No path catches a build or launch
failure and falls back.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.ops import _build
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.integrators import Stepper

Fields = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rk4_constants(grid: GridSpec, dt: float, gravity: float,
                  coriolis_f: float, viscosity: float) -> dict[str, float]:
    """The kernel's scalar constants, folded in double and rounded to
    float32 once, as JAX folds Python floats into a float32 kernel."""
    def f32(x: float) -> float:
        return float(np.float32(x))

    dx, dy, nu = float(grid.dx), float(grid.dy), float(viscosity)
    return {
        "cx": f32(0.5 / dx), "cy": f32(0.5 / dy),
        "g": f32(gravity), "f": f32(coriolis_f),
        "half": f32(0.5 * dt), "dt": f32(dt), "sixth": f32(dt / 6.0),
        "third": f32(1.0 / 3.0),
        "ix2": f32(nu / (dx * dx)), "iy2": f32(nu / (dy * dy)),
        "nu": nu,
    }


def _check(u, v, h, grid: GridSpec, out: Optional[Fields]) -> None:
    if grid.bc != "periodic":
        raise ValueError("swe_rk4_step: periodic boundary condition required")
    if grid.ny < 3 or grid.nx < 3:
        raise ValueError("swe_rk4_step: grid must be at least 3x3")
    for name, t in (("u", u), ("v", v), ("h", h)) + tuple(
            zip(("u_out", "v_out", "h_out"), out or ())):
        if t.dtype != torch.float32:
            raise TypeError(f"swe_rk4_step: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != grid.shape:
            raise ValueError(f"swe_rk4_step: {name} has shape {tuple(t.shape)}, "
                             f"grid is {grid.shape}")
        if not t.is_contiguous():
            raise ValueError(f"swe_rk4_step: {name} must be contiguous")
        if t.device != u.device:
            raise ValueError(f"swe_rk4_step: {name} is on {t.device}, u on {u.device}")
    if out is not None:
        ins = {u.data_ptr(), v.data_ptr(), h.data_ptr()}
        if any(o.data_ptr() in ins for o in out) or len(
                {o.data_ptr() for o in out}) != 3:
            raise ValueError("swe_rk4_step: outputs must be three distinct "
                             "buffers that do not alias the inputs")


def swe_rk4_step(u, v, h, *, grid: GridSpec, dt: float, gravity: float = 9.81,
                 coriolis_f: float = 0.0, viscosity: float = 0.0,
                 out: Optional[Fields] = None) -> Fields:
    """One fused RK4 SWE step on periodic float32 (ny, nx) fields.

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    ``out``: three preallocated result buffers (not aliasing the inputs).
    """
    if u.device.type == "cuda":
        return swe_rk4_step_cuda(u, v, h, grid=grid, dt=dt, gravity=gravity,
                                 coriolis_f=coriolis_f, viscosity=viscosity,
                                 out=out)
    _check(u, v, h, grid, out)
    if u.device.type == "cpu":
        return swe_rk4_step_plain(u, v, h, grid=grid, dt=dt, gravity=gravity,
                                  coriolis_f=coriolis_f, viscosity=viscosity,
                                  out=out)
    raise ValueError(f"swe_rk4_step: unsupported device {u.device}")


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 10 + [ctypes.c_int, ctypes.c_void_p])


def swe_rk4_step_cuda(u, v, h, *, grid: GridSpec, dt: float,
                      gravity: float = 9.81, coriolis_f: float = 0.0,
                      viscosity: float = 0.0,
                      out: Optional[Fields] = None) -> Fields:
    """Launch the CUDA kernel on the current stream. Refuses any tensor that
    is not on a CUDA device. ``swe_rk4_step_cuda.launches`` counts the
    launches."""
    for name, t in (("u", u), ("v", v), ("h", h)) + tuple(
            zip(("u_out", "v_out", "h_out"), out or ())):
        if t.device.type != "cuda":
            raise ValueError(f"swe_rk4_step_cuda: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
    _check(u, v, h, grid, out)
    if out is None:
        out = (torch.empty_like(u), torch.empty_like(v), torch.empty_like(h))
    k = rk4_constants(grid, dt, gravity, coriolis_f, viscosity)
    launch, err_string = _build.bind("swe_rk4", _ARGTYPES)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = launch(
            u.data_ptr(), v.data_ptr(), h.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            grid.ny, grid.nx, k["cx"], k["cy"], k["g"], k["f"], k["half"],
            k["dt"], k["sixth"], k["third"], k["ix2"], k["iy2"],
            int(k["nu"] != 0.0), stream)
    if err != 0:
        msg = err_string(err).decode()
        raise RuntimeError(f"swe_rk4 kernel launch failed: {msg} ({err})")
    swe_rk4_step_cuda.launches += 1
    return out


swe_rk4_step_cuda.launches = 0


def swe_rk4_step_plain(u, v, h, *, grid: GridSpec, dt: float,
                       gravity: float = 9.81, coriolis_f: float = 0.0,
                       viscosity: float = 0.0,
                       out: Optional[Fields] = None) -> Fields:
    """The kernel's function in plain PyTorch, in the kernel's accumulator
    form (state-form RK4, periodic rolls), on any device."""
    k = rk4_constants(grid, dt, gravity, coriolis_f, viscosity)
    cx, cy, g, f = k["cx"], k["cy"], k["g"], k["f"]

    def sx(a, s):  # result[.., x] = a[.., x + s], periodic
        return torch.roll(a, -s, dims=1)

    def sy(a, s):
        return torch.roll(a, -s, dims=0)

    def tendency(uu, vv, hh):
        u_x = (sx(uu, 1) - sx(uu, -1)) * cx
        u_y = (sy(uu, 1) - sy(uu, -1)) * cy
        v_x = (sx(vv, 1) - sx(vv, -1)) * cx
        v_y = (sy(vv, 1) - sy(vv, -1)) * cy
        h_x = (sx(hh, 1) - sx(hh, -1)) * cx
        h_y = (sy(hh, 1) - sy(hh, -1)) * cy
        du = -uu * u_x - vv * u_y - g * h_x + f * vv
        dv = -uu * v_x - vv * v_y - g * h_y - f * uu
        dh = -hh * (u_x + v_y) - uu * h_x - vv * h_y
        if k["nu"] != 0.0:
            ix2, iy2 = k["ix2"], k["iy2"]
            du = du + (sx(uu, 1) + sx(uu, -1) - 2.0 * uu) * ix2 \
                + (sy(uu, 1) + sy(uu, -1) - 2.0 * uu) * iy2
            dv = dv + (sx(vv, 1) + sx(vv, -1) - 2.0 * vv) * ix2 \
                + (sy(vv, 1) + sy(vv, -1) - 2.0 * vv) * iy2
        return du, dv, dh

    half, step_dt = k["half"], k["dt"]
    s = (u, v, h)
    d = tendency(*s)                                      # k1
    c = tuple(si + half * di for si, di in zip(s, d))     # s1
    acc = tuple(ci - si for ci, si in zip(c, s))          # acc = -s + s1
    d = tendency(*c)                                      # k2
    c = tuple(si + half * di for si, di in zip(s, d))     # s2
    acc = tuple(ai + 2.0 * ci for ai, ci in zip(acc, c))
    d = tendency(*c)                                      # k3
    c = tuple(si + step_dt * di for si, di in zip(s, d))  # s3
    acc = tuple(ai + ci for ai, ci in zip(acc, c))
    d = tendency(*c)                                      # k4
    new = tuple(ai * k["third"] + k["sixth"] * di for ai, di in zip(acc, d))
    if out is None:
        return new
    for o, n in zip(out, new):
        o.copy_(n)
    return out


def kernel_supported(grid: GridSpec, params: PhysicsParams, model: str,
                     method: str) -> bool:
    """Eligibility for the fused kernel (otherwise the plain integrators).
    Unlike the TPU rule there is no tile-multiple condition: the kernel
    masks ragged tiles."""
    return (
        model == "shallow_water"
        and method == "rk4"
        and grid.grid_type == "cartesian"
        and grid.bc == "periodic"
        and isinstance(params.gravity, numbers.Number)
        and isinstance(params.coriolis_f, numbers.Number)
        and isinstance(params.beta, numbers.Number)
        and float(params.beta) == 0.0
        # viscosity is supported in-kernel; beta needs a per-row f field,
        # which stays on the plain path
        and isinstance(params.viscosity, numbers.Number)
    )


def make_kernel_rk4_stepper(grid: GridSpec, params: PhysicsParams,
                            dt: float) -> Stepper:
    """Stepper around ``swe_rk4_step`` for ``Simulation``.

    In place by design: the carry is a second state buffer, and each step
    writes the new state into it and hands the old state back as the next
    carry. Two buffers ping-pong and a step allocates nothing, so a state
    returned by one step is overwritten by the step after next; callers
    that keep a state copy it (``Simulation._store_output`` does).
    """
    kw = dict(grid=grid, dt=float(dt), gravity=float(params.gravity),
              coriolis_f=float(params.coriolis_f),
              viscosity=float(params.viscosity))

    def init(s):
        return WeatherState(u=torch.empty_like(s.u), v=torch.empty_like(s.v),
                            h=torch.empty_like(s.h))

    def step(spare, s, _dt_ignored):
        u, v, h = swe_rk4_step(s.u, s.v, s.h, out=(spare.u, spare.v, spare.h),
                               **kw)
        return s, WeatherState(u=u, v=v, h=h)

    return Stepper(init, step, "rk4_kernel", 4)
