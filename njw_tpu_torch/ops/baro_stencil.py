"""One RK stage of the barotropic core: CUDA kernel and plain version.

Counterpart of ``njw_tpu/ops/baro_stencil.py`` (``baro_stage_pallas``,
``make_baro_pallas_rk4_stepper``, ``baro_pallas_supported``). The kernel,
``csrc/baro_stage.cu``, replaces the TPU kernel ``_baro_stage_kernel``:

    out = base + c_dt * (-J(psi, zeta) - beta dpsi/dx + nu Laplacian(zeta))

for periodic float32 (ny, nx) fields in one pass. The spectral Poisson
solve between stages stays with ``torch.fft`` (``ops/spectral.py``).

``baro_stage`` dispatches once, in ``_runner``: the kernel's launch for
CUDA tensors, its plain PyTorch version (the same arithmetic) for CPU
tensors, and nothing else; the stepper uses the same runner, and checks
only a state it did not hand out (the rule of ``ops/_bound.py``; it owns
no buffers, so it binds no launch). Nothing catches a build or launch
failure and falls back.
"""
from __future__ import annotations

import ctypes
import numbers
from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from njw_tpu_torch.ops import _build
from njw_tpu_torch.ops._bound import BoundSteps, Launch, device_kind, \
    require_cuda
from njw_tpu_torch.ops.spectral import poisson_solve
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams
from njw_tpu_torch.weather.integrators import Stepper

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 7
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# csrc/baro_stage.cu kStrips: (columns a lane, rows a warp) of each strip
# built; the launch's rule takes entry 0 where nx % 4 == 0 and every field
# is 16-byte aligned, entry 1 otherwise
BARO_STRIPS = ((4, 4), (1, 4))


def baro_strip(nx: int, aligned: bool = True) -> int:
    """The rule of csrc/baro_stage.cu: the index (into ``BARO_STRIPS``) of
    the strip the launch takes for a row of ``nx`` points, ``aligned``
    when every field starts on 16 bytes (as torch allocates)."""
    return 0 if nx % 4 == 0 and aligned else 1


def baro_kernel_attributes(strip: int, unit: bool = False,
                           index: int = 0) -> dict:
    """The built kernel of strip ``strip`` (an index of ``BARO_STRIPS``;
    ``unit``: the instantiation the launch takes where dx = dy = 1) on
    CUDA device ``index``: registers, local (spill) bytes, static shared
    bytes, threads a block, resident blocks an SM, columns a lane and rows
    a warp."""
    fn = _build.load("baro_stage").baro_stage_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    with torch.cuda.device(index):
        err = fn(strip, int(unit), vals)
    if err != 0:
        msg = _build.bind("baro_stage", _ARGTYPES)[1](err).decode()
        raise RuntimeError(f"baro_stage attributes: {msg} ({err})")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "threads", "blocks_per_sm", "columns_per_lane",
                     "rows_per_warp"), vals))


class BaroConsts(NamedTuple):
    """The kernel's scalars, folded in double and rounded to float32 once."""

    m12: float   # -1/(12 dx dy)
    cx: float    # 0.5/dx
    beta: float
    dx2: float   # dx^2
    dy2: float   # dy^2
    nu: float
    c_dt: float
    has_beta: int
    has_nu: int


@lru_cache(maxsize=64)
def baro_constants(grid: GridSpec, c_dt: float, beta: float,
                   nu: float) -> BaroConsts:
    def f32(x: float) -> float:
        return float(np.float32(x))

    dx, dy = float(grid.dx), float(grid.dy)
    return BaroConsts(f32(-1.0 / (12.0 * dx * dy)), f32(0.5 / dx),
                      f32(beta), f32(dx * dx), f32(dy * dy), f32(nu),
                      f32(c_dt), int(beta != 0.0), int(nu != 0.0))


def _check(psi, zeta, base, grid: GridSpec, out) -> None:
    if grid.bc != "periodic":
        raise ValueError("baro_stage: periodic boundary condition required")
    if grid.ny < 3 or grid.nx < 3:
        raise ValueError("baro_stage: grid must be at least 3x3")
    named = [("psi", psi), ("zeta", zeta), ("base", base)]
    if out is not None:
        named.append(("out", out))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"baro_stage: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != grid.shape:
            raise ValueError(f"baro_stage: {name} has shape {tuple(t.shape)}, "
                             f"grid is {grid.shape}")
        if not t.is_contiguous():
            raise ValueError(f"baro_stage: {name} must be contiguous")
        if t.device != zeta.device:
            raise ValueError(f"baro_stage: {name} is on {t.device}, zeta on "
                             f"{zeta.device}")
    if out is not None and out.data_ptr() in (psi.data_ptr(), zeta.data_ptr()):
        raise ValueError("baro_stage: out must not alias psi or zeta")


def baro_stage(psi, zeta, base, *, grid: GridSpec, c_dt: float,
               beta: float = 0.0, nu: float = 0.0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = base + c_dt * barotropic tendency(psi, zeta), one pass.

    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    return _call(_runner(zeta), psi, zeta, base, grid, c_dt, beta, nu, out)


def baro_stage_cuda(psi, zeta, base, *, grid: GridSpec, c_dt: float,
                    beta: float = 0.0, nu: float = 0.0,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Refuses tensors that
    are not on a CUDA device. ``baro_stage_cuda.launches`` counts the
    launches."""
    require_cuda("baro_stage_cuda", [("zeta", zeta)])  # _check: the rest
    return _call(_launch, psi, zeta, base, grid, c_dt, beta, nu, out)


def baro_stage_plain(psi, zeta, base, *, grid: GridSpec, c_dt: float,
                     beta: float = 0.0, nu: float = 0.0,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (periodic rolls), on any
    device, with the kernel's arithmetic and float32 constants."""
    return _call(_plain, psi, zeta, base, grid, c_dt, beta, nu, out)


def _call(run, psi, zeta, base, grid, c_dt, beta, nu, out) -> torch.Tensor:
    _check(psi, zeta, base, grid, out)
    if out is None:
        out = torch.empty_like(zeta)
    return run(psi, zeta, base, out, grid,
               baro_constants(grid, float(c_dt), float(beta), float(nu)))


def _runner(zeta: torch.Tensor) -> Callable:
    """The one dispatch point: the launch for CUDA tensors, the plain
    version for CPU tensors. Both take tensors already checked
    (``_check``) and constants already folded."""
    return _launch if device_kind(zeta, "baro_stage") == "cuda" else _plain


def _launch(psi, zeta, base, out, grid: GridSpec, k: BaroConsts,
            strip: int = -1) -> torch.Tensor:
    """Launch on the current stream; ``strip``: -1 for the rule's
    (``baro_strip``), or an index of ``BARO_STRIPS`` (the card tests and
    the profiler)."""
    launch, err_string = _build.bind("baro_stage", _ARGTYPES)
    entry = partial(launch, psi.data_ptr(), zeta.data_ptr(), base.data_ptr(),
                    out.data_ptr(), grid.ny, grid.nx, *k, strip)
    return Launch("baro_stage", entry, zeta.device.index, err_string,
                  (baro_stage_cuda, "launches"), out, ())()


baro_stage_cuda.launches = 0


def _plain(psi, zeta, base, out, grid: GridSpec,
           k: BaroConsts) -> torch.Tensor:
    def sh(f, sx, sy):  # f[y + sy, x + sx], periodic
        return torch.roll(f, (-sy, -sx), dims=(0, 1))

    p, z = psi, zeta
    pE, pW, pN, pS = sh(p, 1, 0), sh(p, -1, 0), sh(p, 0, 1), sh(p, 0, -1)
    pNE, pNW = sh(p, 1, 1), sh(p, -1, 1)
    pSE, pSW = sh(p, 1, -1), sh(p, -1, -1)
    zE, zW, zN, zS = sh(z, 1, 0), sh(z, -1, 0), sh(z, 0, 1), sh(z, 0, -1)
    zNE, zNW = sh(z, 1, 1), sh(z, -1, 1)
    zSE, zSW = sh(z, 1, -1), sh(z, -1, -1)

    j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW)
    j2 = (pE * (zNE - zSE) - pW * (zNW - zSW)
          - pN * (zNE - zNW) + pS * (zSE - zSW))
    j3 = (zN * (pNE - pNW) - zS * (pSE - pSW)
          - zE * (pNE - pSE) + zW * (pNW - pSW))
    dz = (j1 + j2 + j3) * k.m12
    if k.has_beta:
        dz = dz - k.beta * ((pE - pW) * k.cx)
    if k.has_nu:
        dz = dz + k.nu * ((zE - 2.0 * z + zW) / k.dx2
                          + (zN - 2.0 * z + zS) / k.dy2)
    return out.copy_(base + k.c_dt * dz)


def baro_kernel_supported(grid: GridSpec, params: PhysicsParams) -> bool:
    """Eligibility for the stage kernel. Unlike the TPU rule there is no
    tile-multiple or VMEM condition: the kernel masks ragged tiles."""
    return (
        grid.bc == "periodic"
        and grid.grid_type == "cartesian"
        and isinstance(params.beta, numbers.Number)
        and isinstance(params.viscosity, numbers.Number)
    )


def make_baro_kernel_rk4_stepper(grid: GridSpec, params: PhysicsParams,
                                 dt: float) -> Stepper:
    """RK4 with four stage launches per step; the spectral Poisson solve
    runs before each stage and the accumulator pass before the last:

        z1 = z + dt/2 T(z);  z2 = z + dt/2 T(z1);  z3 = z + dt T(z2)
        acc = (-z + z1 + 2 z2 + z3)/3;  z' = acc + dt/6 T(z3)
    """
    from njw_tpu_torch.weather.barotropic import BarotropicState

    beta, nu, dt = float(params.beta), float(params.viscosity), float(dt)
    # the stages' constants, folded once here and not per launch
    consts = {c_dt: baro_constants(grid, c_dt, beta, nu)
              for c_dt in (0.5 * dt, dt, dt / 6.0)}

    def advance(run, given):
        carry, s = given
        z = s.zeta

        def stage(cur, base, c_dt):
            # cur is the checked state or a stage output, psi and the
            # output are fresh contiguous float32 tensors of its shape
            psi = poisson_solve(cur, grid.dx, grid.dy, kind="laplacian5")
            return run(psi, cur, base, torch.empty_like(cur), grid,
                       consts[c_dt])

        z1 = stage(z, z, 0.5 * dt)
        z2 = stage(z1, z, 0.5 * dt)
        z3 = stage(z2, z, dt)
        # (-z + z1 + 2 z2 + z3)/3 in four passes, bit for bit (2 z2 is exact)
        acc = (z1 - z).add_(z2, alpha=2.0).add_(z3).mul_(1.0 / 3.0)
        return carry, BarotropicState(zeta=stage(z3, acc, dt / 6.0))

    def adopt(given):
        z = given[1].zeta
        _check(z, z, z, grid, None)
        return (partial(advance, _runner(z)),)

    steps = BoundSteps()
    return Stepper(lambda s: (),
                   lambda carry, s, _dt: steps((carry, s), adopt),
                   "baro_rk4_kernel", 4)
