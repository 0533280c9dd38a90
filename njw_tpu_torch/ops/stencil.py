"""Fused RK4 steps of the shallow-water core: CUDA kernel and plain versions.

Counterpart of ``njw_tpu/ops/stencil.py`` (``swe_rk4_step_pallas``,
``make_pallas_rk4_stepper``, ``swe_rk4_multistep_pallas``,
``pallas_supported``). The kernel source, ``csrc/swe_rk4.cu``, replaces
the TPU kernels ``swe_rk4_kernel`` (K1: one whole RK4 step, four
central-difference SWE tendencies, the accumulator-form combine, optional
5-point viscosity on u and v, for periodic float32 ``(ny, nx)`` fields in
one pass over device memory), its bf16 variant (K1-bf16: the advection
differences and products in bf16) and ``_swe_rk4_multi_kernel`` (K2: one
or two chained steps per pass). Its header says what bounds each and how
its tiles are laid out.

``swe_rk4_step`` launches the kernel for CUDA tensors. For CPU tensors it
runs ``swe_rk4_step_plain``, the same function in plain PyTorch (the
counterpart of Pallas interpret mode); the tests use it, and the chip
smoke test holds the kernel against it. No path catches a build or launch
failure and falls back. ``variant`` takes the JAX package's names:
``slices`` (the default), ``base`` and ``folded`` run the float32 kernel
(in JAX they differ only in rounding order), ``bf16`` and ``bf16s`` the
bf16 one. ``swe_rk4_multistep`` is K2's counterpart.

Launch counters: ``swe_rk4_step_cuda.launches`` (K1, float32, every form),
``swe_rk4_step_cuda.bf16_launches`` (K1-bf16) and
``swe_rk4_multistep_cuda.launches`` (K2). Every launch goes through the
library's prepared entry (``_bind_launch``); the steppers bind theirs once
per arrangement of their buffers (the rule of ``ops/_bound.py``).

Block layouts: ``SweLayout`` (output tile, rows of the region per warp,
columns per lane, blocks per SM). ``swe_layout`` is the rule: the one
layout the source builds for each form; ``SweLayout.smem_bytes`` and
``.threads`` mirror the source, and ``swe_kernel_attributes`` reads the
built kernel's (the card tests hold the two equal).

The sharded launchers of the same TPU kernel (``swe_rk4_step_pallas_local``,
``_carry``, ``_local2d``) have their counterparts here too:
``swe_rk4_step_local``, ``swe_rk4_step_carry`` and ``swe_rk4_step_local2d``,
thin wrappers over one padded launch (``swe_rk4_step_padded``) of the same
kernel, with a plain version on the padded block. As in the JAX package,
they take no variant. All forms dispatch in one place (``_bind``).
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from njw_tpu_torch.ops import _build
from njw_tpu_torch.ops._bound import BoundSteps, Launch, device_kind, \
    require_cuda, step
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.integrators import Stepper

Fields = tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_NAMES = ("u", "v", "h", "u_out", "v_out", "h_out")
HALO = 4  # rows (columns) of halo the kernel reads: one per chained stage
SMEM_PER_BLOCK = 227 * 1024  # the most shared memory a block may have (sm_90)
MAX_THREADS = 1024           # threads a block may have
# the JAX package's variant names; the last two take the bf16 tendency
VARIANTS = ("slices", "base", "folded", "bf16", "bf16s")


class SweLayout(NamedTuple):
    """A block layout of csrc/swe_rk4.cu: a ``tx`` x ``ty`` output tile,
    ``rows`` rows of the tile's region per warp (a band of the region's
    whole width), ``cols`` adjacent columns of the band per lane, and the
    ``blocks`` per SM its register cap is set for (``__launch_bounds__``)."""

    tx: int
    ty: int
    rows: int
    cols: int
    blocks: int

    def region(self, n_steps: int) -> tuple[int, int]:
        """(rows, columns) of the region: the tile and 4 halo points per
        side and step."""
        return self.ty + 2 * HALO * n_steps, self.tx + 2 * HALO * n_steps

    def threads(self, n_steps: int) -> int:
        py, px = self.region(n_steps)
        return px // self.cols * (py // self.rows)

    def smem_bytes(self, n_steps: int) -> int:
        """Two (u, v, h) float32 region buffers, s of this tile and of the
        next, and each band's first and last rows for two stage
        parities."""
        py, px = self.region(n_steps)
        return 4 * 3 * (2 * py * px + 4 * (py // self.rows) * px)


# The layout csrc/swe_rk4.cu builds for each form, by steps per launch
# (its Step1: K1 float32, bf16 and padded; its Step2: K2), the fastest the
# H100 timed at 2048^2 (scripts/profile_torch.py, PERF.md).
_RULE = {1: SweLayout(56, 56, 4, 2, 1), 2: SweLayout(48, 48, 4, 2, 1)}


@functools.lru_cache(maxsize=8)
def swe_layout(n_steps: int = 1, bf16: bool = False) -> SweLayout:
    """The rule: the layout of the form with ``n_steps`` per launch (the
    bf16 tendency takes the float32 one). Refuses, with ValueError, a
    layout that does not tile its region (a tile width that is not a
    multiple of 4, a region width that is not one warp's lanes of 1, 2 or
    4 columns, a region height that is not whole bands) or does not fit a
    block (threads, shared memory): the source's static_asserts, checked
    before anything is built."""
    if n_steps not in _RULE:
        raise ValueError(f"n_steps must be 1 or 2, got {n_steps}")
    lay = _RULE[n_steps]
    py, px = lay.region(n_steps)
    if lay.tx % 4 or lay.cols not in (1, 2, 4) or px != 32 * lay.cols \
            or py % lay.rows:
        raise ValueError(f"swe_rk4: {lay} does not tile its {py}x{px} "
                         "region (tx % 4, columns = 32 lanes x cols, rows % "
                         "band)")
    if lay.threads(n_steps) > MAX_THREADS:
        raise ValueError(f"swe_rk4: {lay} needs {lay.threads(n_steps)} "
                         f"threads, more than the {MAX_THREADS} a block may "
                         "have")
    if lay.smem_bytes(n_steps) > SMEM_PER_BLOCK:
        raise ValueError(f"swe_rk4: {lay} needs {lay.smem_bytes(n_steps)} B "
                         f"of shared memory, more than the {SMEM_PER_BLOCK} "
                         "a block may have")
    return lay


def _is_bf16(variant: str) -> bool:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; available: "
                         f"{list(VARIANTS)}")
    return variant in ("bf16", "bf16s")


@functools.lru_cache(maxsize=64)
def bf16_constant(x: float) -> float:
    """``x`` rounded to bfloat16, as ``jnp.bfloat16(x)`` rounds a Python
    float for the JAX kernel: both go through float32 first (torch's
    double-to-bf16 cast, like ml_dtypes', converts to float32 and then
    rounds to nearest even)."""
    return float(torch.tensor(x, dtype=torch.float64).to(torch.bfloat16))


def rk4_constants(grid: GridSpec, dt: float, gravity: float,
                  coriolis_f: float, viscosity: float,
                  bf16: bool = False) -> dict[str, float]:
    """The kernel's scalar constants, folded in double and rounded to
    float32 once, as JAX folds Python floats into a float32 kernel. With
    ``bf16``, also the bf16 tendency's difference scales ``bcx``, ``bcy``
    (bf16 values) and the flag ``bf16``."""
    def f32(x: float) -> float:
        return float(np.float32(x))

    dx, dy, nu = float(grid.dx), float(grid.dy), float(viscosity)
    k = {
        "cx": f32(0.5 / dx), "cy": f32(0.5 / dy),
        "g": f32(gravity), "f": f32(coriolis_f),
        "half": f32(0.5 * dt), "dt": f32(dt), "sixth": f32(dt / 6.0),
        "third": f32(1.0 / 3.0),
        "ix2": f32(nu / (dx * dx)), "iy2": f32(nu / (dy * dy)),
        "nu": nu,
    }
    if bf16:
        k.update(bf16=True, bcx=bf16_constant(0.5 / dx),
                 bcy=bf16_constant(0.5 / dy))
    return k


def _refuse_fields(name: str, ins: Fields, out: Optional[Fields],
                   shape: tuple, out_shape: tuple) -> None:
    """Type, shape, layout and device checks of the kernel's operands: the
    three inputs share one layout (shape and strides), so do the three
    outputs, and each row is contiguous."""
    dev = ins[0].device
    groups = [(("u", "v", "h"), ins, shape)]
    if out is not None:
        groups.append((("u_out", "v_out", "h_out"), out, out_shape))
    for names, ts, want in groups:
        for n, t in zip(names, ts):
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: {n} must be float32, got {t.dtype}")
            if tuple(t.shape) != tuple(want):
                raise ValueError(f"{name}: {n} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(want)}")
            if t.stride(-1) != 1 or t.stride() != ts[0].stride():
                raise ValueError(f"{name}: {n} must have contiguous rows "
                                 "and the strides of the other fields")
            if t.device != dev:
                raise ValueError(f"{name}: {n} is on {t.device}, u on {dev}")
    if out is not None:
        stores = {t.untyped_storage().data_ptr() for t in ins}
        if any(o.untyped_storage().data_ptr() in stores for o in out) or len(
                {o.data_ptr() for o in out}) != 3:
            raise ValueError(f"{name}: outputs must be three distinct "
                             "buffers that do not alias the inputs")


def _check(u, v, h, grid: GridSpec, out: Optional[Fields]) -> None:
    if grid.bc != "periodic":
        raise ValueError("swe_rk4_step: periodic boundary condition required")
    if grid.ny < 3 or grid.nx < 3:
        raise ValueError("swe_rk4_step: grid must be at least 3x3")
    _refuse_fields("swe_rk4_step", (u, v, h), out, grid.shape, grid.shape)
    for n, t in (("u", u), ("v", v), ("h", h)) + tuple(
            zip(("u_out", "v_out", "h_out"), out or ())):
        if not t.is_contiguous():
            raise ValueError(f"swe_rk4_step: {n} must be contiguous")


def swe_rk4_step(u, v, h, *, grid: GridSpec, dt: float, gravity: float = 9.81,
                 coriolis_f: float = 0.0, viscosity: float = 0.0,
                 variant: str = "slices",
                 out: Optional[Fields] = None) -> Fields:
    """One fused RK4 SWE step on periodic float32 (ny, nx) fields.

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    ``variant``: one of ``VARIANTS`` (see the module docstring).
    ``out``: three preallocated result buffers (not aliasing the inputs).
    """
    return _bind(device_kind(u, "swe_rk4_step"),
                 _args((u, v, h), out, grid, dt, gravity, coriolis_f,
                       viscosity, variant))()


def swe_rk4_step_cuda(u, v, h, *, grid: GridSpec, dt: float,
                      gravity: float = 9.81, coriolis_f: float = 0.0,
                      viscosity: float = 0.0, variant: str = "slices",
                      out: Optional[Fields] = None) -> Fields:
    """Launch the CUDA kernel on the current stream. Refuses any tensor that
    is not on a CUDA device. ``swe_rk4_step_cuda.launches`` counts the
    float32 launches of every form (whole-domain and padded),
    ``swe_rk4_step_cuda.bf16_launches`` those of the bf16 variant."""
    require_cuda("swe_rk4_step_cuda",
                 zip(_NAMES, (u, v, h) + tuple(out or ())))
    return _launch(*_args((u, v, h), out, grid, dt, gravity, coriolis_f,
                          viscosity, variant))


def swe_rk4_step_plain(u, v, h, *, grid: GridSpec, dt: float,
                       gravity: float = 9.81, coriolis_f: float = 0.0,
                       viscosity: float = 0.0, variant: str = "slices",
                       out: Optional[Fields] = None) -> Fields:
    """The kernel's function in plain PyTorch, in the kernel's accumulator
    form (state-form RK4, periodic rolls), on any device; the bf16
    variant in torch bf16 operations, each rounded, in the kernel's
    order."""
    return _plain(*_args((u, v, h), out, grid, dt, gravity, coriolis_f,
                         viscosity, variant))


def _args(ins: Fields, out, grid, dt, gravity, coriolis_f, viscosity,
          variant: str = "slices", n_fused: Optional[int] = None) -> tuple:
    """Check a whole-domain call and fold its constants; return its (ins,
    out, halo, constants), the arguments of ``_launch`` and ``_plain``.
    ``n_fused`` (the multistep entry points only) is stored in the
    constants as ``fused``: K2's launch and its counter."""
    _check(*ins, grid, out)
    k = rk4_constants(grid, dt, gravity, coriolis_f, viscosity,
                      _is_bf16(variant))
    if n_fused is not None:
        k["fused"] = _fused(n_fused)
    if out is None:
        out = tuple(torch.empty_like(t) for t in ins)
    return ins, out, (0, 0), k


def _fused(n_fused: int) -> int:
    if n_fused not in (1, 2):
        raise ValueError(f"n_fused must be 1 or 2, got {n_fused} (the JAX "
                         "kernel's 8-row slab halo bound)")
    return n_fused


def _bind(kind: str, args: tuple) -> Callable[[], Fields]:
    """The one dispatch point of every form, whole-domain, multistep and
    padded: for "cuda" the kernel's launch bound once (``_bind_launch``),
    for "cpu" the plain version's call. ``args``: (ins, out, halo,
    constants), checked and folded."""
    if kind == "cuda":
        return _bind_launch(*args)
    return functools.partial(_plain, *args)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_PREPARE_ARGTYPES = ([_P] + [_L, _I, _I] * 2 + [_I] * 4 + [_F] * 10
                     + [_I] * 3 + [_F] * 2 + [_I])


def _error_string(lib) -> Callable[[int], bytes]:
    fn = lib.swe_rk4_error_string
    fn.argtypes, fn.restype = [_I], ctypes.c_char_p
    return fn


def _bind_launch(ins: Fields, out: Fields, halo: tuple, k: dict) -> Launch:
    """The launch of ``ins`` into ``out`` bound once through the library's
    prepared entry (``swe_rk4_prepare`` checks and keeps all but the six
    field pointers and the stream, ``swe_rk4_launch_prepared`` takes
    them): K2 (``k["fused"]`` steps) counted on
    ``swe_rk4_multistep_cuda.launches``, K1-bf16 on
    ``swe_rk4_step_cuda.bf16_launches``, K1 on ``.launches``. ``ins``: (u,
    v, h) views of the input block (its first element, its row pitch),
    whose interior starts at ``halo`` = (hy, hx); an axis whose halo is 0
    wraps. ``out``: views of the interior-shaped result. The block layout
    is the rule's (``swe_layout``). ``k["stages"]`` < 4 steps runs only
    the first stages and writes nothing, 0 only the loads
    (``scripts/profile_torch.py`` times the kernel's parts so)."""
    hy, hx = halo
    ny, nx = out[0].shape
    n_steps = k.get("fused", 1)
    swe_layout(n_steps, bool(k.get("bf16")))   # refuses one that does not fit
    lib = _build.load("swe_rk4")
    size = lib.swe_rk4_prepared_bytes
    size.argtypes, size.restype = [], ctypes.c_int
    prepared = ctypes.create_string_buffer(size())
    prepare = lib.swe_rk4_prepare
    prepare.argtypes, prepare.restype = _PREPARE_ARGTYPES, ctypes.c_int
    err = prepare(prepared, ins[0].stride(0), hy, hx, out[0].stride(0), 0,
                  0, ny, nx, int(hy > 0), int(hx > 0), k["cx"], k["cy"],
                  k["g"], k["f"], k["half"], k["dt"], k["sixth"],
                  k["third"], k["ix2"], k["iy2"], int(k["nu"] != 0.0),
                  n_steps, int(k.get("bf16", 0)), k.get("bcx", 0.0),
                  k.get("bcy", 0.0), k.get("stages", 4 * n_steps))
    if err != 0:
        msg = _error_string(lib)(err).decode()
        raise RuntimeError(f"swe_rk4 kernel launch failed: {msg} ({err})")
    launch = lib.swe_rk4_launch_prepared
    launch.argtypes, launch.restype = [_P] * 8, ctypes.c_int
    entry = functools.partial(launch, ctypes.addressof(prepared),
                              *(t.data_ptr() for t in (*ins, *out)))
    counter = (swe_rk4_multistep_cuda, "launches") if "fused" in k else \
        (swe_rk4_step_cuda, "bf16_launches" if k.get("bf16") else "launches")
    return Launch("swe_rk4", entry, ins[0].device.index, _error_string(lib),
                  counter, out, (prepared, *ins, *out))


def _launch(ins: Fields, out: Fields, halo: tuple, k: dict) -> Fields:
    """Launch on the current stream and count it (``_bind_launch``)."""
    return _bind_launch(ins, out, halo, k)()


swe_rk4_step_cuda.launches = 0
swe_rk4_step_cuda.bf16_launches = 0


def swe_kernel_attributes(n_steps: int = 1, bf16: bool = False,
                          padded: tuple = (0, 0), index: int = 0) -> dict:
    """The built kernel's instantiation for a form (steps per launch, the
    bf16 tendency, ``padded`` = (halo in y, halo in x) as 0/1) on CUDA
    device ``index``: its registers and local (spill) bytes per thread,
    dynamic and static shared bytes, threads per block and resident blocks
    per SM, with the rule's layout and tile."""
    lay = swe_layout(n_steps, bf16)
    fn = _build.load("swe_rk4").swe_rk4_attributes
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        err = fn(n_steps, int(bf16), int(padded[0]), int(padded[1]), vals)
    if err != 0:
        msg = _error_string(_build.load("swe_rk4"))(err).decode()
        raise RuntimeError(f"swe_rk4 attributes: {msg} ({err})")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads",
                     "blocks_per_sm", "static_smem_bytes"), vals),
                tile=[lay.ty, lay.tx], layout=lay._asdict())


def _tendency(uu, vv, hh, nbrs, k: dict):
    """(du, dv, dh) in the kernel's operation order. ``nbrs``: the five
    accessors (east, west, north, south, centre) of a field: rolls on the
    whole periodic domain, slices on a padded frame."""
    e, w, n, s, c = nbrs
    uc, vc, hc = c(uu), c(vv), c(hh)
    if k.get("bf16"):
        du, dv, dh = _advection_bf16(uu, vv, hh, nbrs, k)
    else:
        cx, cy, g, f = k["cx"], k["cy"], k["g"], k["f"]
        u_x = (e(uu) - w(uu)) * cx
        u_y = (n(uu) - s(uu)) * cy
        v_x = (e(vv) - w(vv)) * cx
        v_y = (n(vv) - s(vv)) * cy
        h_x = (e(hh) - w(hh)) * cx
        h_y = (n(hh) - s(hh)) * cy
        du = -uc * u_x - vc * u_y - g * h_x + f * vc
        dv = -uc * v_x - vc * v_y - g * h_y - f * uc
        dh = -hc * (u_x + v_y) - uc * h_x - vc * h_y
    if k["nu"] != 0.0:
        ix2, iy2 = k["ix2"], k["iy2"]
        du = du + (e(uu) + w(uu) - 2.0 * uc) * ix2 \
            + (n(uu) + s(uu) - 2.0 * uc) * iy2
        dv = dv + (e(vv) + w(vv) - 2.0 * vc) * ix2 \
            + (n(vv) + s(vv) - 2.0 * vc) * iy2
    return du, dv, dh


def _advection_bf16(uu, vv, hh, nbrs, k: dict):
    """The bf16 variant's (du, dv, dh) before viscosity: u, v, h rounded
    to bf16; the differences, their products with the bf16 scales and the
    advection sums in bf16, each operation rounded (torch's bf16
    arithmetic), in the kernel's order; g h_x and f v in float32."""
    e, w, n, s, c = nbrs
    bcx, bcy, g, f = k["bcx"], k["bcy"], k["g"], k["f"]
    ub, vb, hb = (x.to(torch.bfloat16) for x in (uu, vv, hh))
    u_x = (e(ub) - w(ub)) * bcx
    u_y = (n(ub) - s(ub)) * bcy
    v_x = (e(vb) - w(vb)) * bcx
    v_y = (n(vb) - s(vb)) * bcy
    h_x = (e(hb) - w(hb)) * bcx
    h_y = (n(hb) - s(hb)) * bcy
    ubc, vbc, hbc = c(ub), c(vb), c(hb)
    du = (-ubc * u_x - vbc * u_y).float() - g * h_x.float() + f * c(vv)
    dv = (-ubc * v_x - vbc * v_y).float() - g * h_y.float() - f * c(uu)
    dh = (-hbc * (u_x + v_y) - ubc * h_x - vbc * h_y).float()
    return du, dv, dh


def _rolls():
    def e(a):  # a[.., x + 1], periodic
        return torch.roll(a, -1, dims=1)

    def w(a):
        return torch.roll(a, 1, dims=1)

    def n(a):
        return torch.roll(a, -1, dims=0)

    def s(a):
        return torch.roll(a, 1, dims=0)

    return (e, w, n, s, lambda a: a), (lambda a: a)


def _slices():
    """Neighbour accessors on a frame whose valid region shrinks by one
    point per side per stage, and the crop to the next region."""
    def mid(a):
        return a[1:-1, 1:-1]

    return (lambda a: a[1:-1, 2:], lambda a: a[1:-1, :-2],
            lambda a: a[2:, 1:-1], lambda a: a[:-2, 1:-1], mid), mid


def frame(a: torch.Tensor, halo: tuple, width: int) -> torch.Tensor:
    """The padded block ``a`` (interior at ``halo`` = (hy, hx)) cut to
    ``width`` rows and columns of halo; an axis with halo 0 (whole and
    periodic) is extended by ``width`` by its wrap. Leading axes (levels)
    pass through."""
    hy, hx = halo
    rows = a.shape[-2] - 2 * hy
    a = a[..., hy - width:hy + rows + width, :]
    if hx:
        cols = a.shape[-1] - 2 * hx
        return a[..., hx - width:hx + cols + width]
    idx = torch.arange(-width, a.shape[-1] + width, device=a.device) \
        % a.shape[-1]
    return a.index_select(-1, idx)


def _plain(ins: Fields, out: Fields, halo: tuple, k: dict) -> Fields:
    """The kernel's function in plain PyTorch: ``k["fused"]`` (else one)
    applications of the one-step plain version."""
    for _ in range(k.get("fused", 1) - 1):
        ins = _plain_step(ins, None, halo, k)
    return _plain_step(ins, out, halo, k)


def _plain_step(ins: Fields, out: Optional[Fields], halo: tuple,
                k: dict) -> Fields:
    """One step in plain PyTorch, in the kernel's accumulator form:
    periodic rolls on the whole domain (halo (0, 0)); on a padded block,
    slices of the block cut to a 4-point halo, the valid region shrinking
    by one point per side per stage (no roll, nothing wraps)."""
    if halo == (0, 0):
        nbrs, mid = _rolls()
        s = ins
    else:
        nbrs, mid = _slices()
        s = tuple(frame(t, halo, HALO) for t in ins)
    half, step_dt = k["half"], k["dt"]
    base = tuple(mid(x) for x in s)                         # s, region 1
    d = _tendency(*s, nbrs, k)                              # k1
    c = tuple(b + half * di for b, di in zip(base, d))      # s1
    acc = tuple(ci - b for ci, b in zip(c, base))           # acc = -s + s1
    d = _tendency(*c, nbrs, k)                              # k2
    base = tuple(mid(b) for b in base)
    c = tuple(b + half * di for b, di in zip(base, d))      # s2
    acc = tuple(mid(a) + 2.0 * ci for a, ci in zip(acc, c))
    d = _tendency(*c, nbrs, k)                              # k3
    base = tuple(mid(b) for b in base)
    c = tuple(b + step_dt * di for b, di in zip(base, d))   # s3
    acc = tuple(mid(a) + ci for a, ci in zip(acc, c))
    d = _tendency(*c, nbrs, k)                              # k4
    new = tuple(mid(a) * k["third"] + k["sixth"] * di
                for a, di in zip(acc, d))
    if out is None:
        return new
    for o, n in zip(out, new):
        o.copy_(n)
    return out


# ----------------------------------------------- several steps per pass (K2)

def swe_rk4_multistep(u, v, h, *, grid: GridSpec, dt: float,
                      gravity: float = 9.81, coriolis_f: float = 0.0,
                      n_fused: int = 2,
                      out: Optional[Fields] = None) -> Fields:
    """``n_fused`` (1 or 2) chained RK4 SWE steps in one pass over
    periodic float32 (ny, nx) fields, without viscosity (the counterpart of
    ``swe_rk4_multistep_pallas``; no tile-multiple conditions: the kernel
    masks ragged tiles). CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    return _bind(device_kind(u, "swe_rk4_multistep"),
                 _args((u, v, h), out, grid, dt, gravity, coriolis_f, 0.0,
                       n_fused=n_fused))()


def swe_rk4_multistep_cuda(u, v, h, *, grid: GridSpec, dt: float,
                           gravity: float = 9.81, coriolis_f: float = 0.0,
                           n_fused: int = 2,
                           out: Optional[Fields] = None) -> Fields:
    """Launch the multistep kernel (K2) on the current stream; CUDA tensors
    only. ``swe_rk4_multistep_cuda.launches`` counts its launches."""
    require_cuda("swe_rk4_multistep_cuda",
                 zip(_NAMES, (u, v, h) + tuple(out or ())))
    return _launch(*_args((u, v, h), out, grid, dt, gravity, coriolis_f,
                          0.0, n_fused=n_fused))


swe_rk4_multistep_cuda.launches = 0


def swe_rk4_multistep_plain(u, v, h, *, grid: GridSpec, dt: float,
                            gravity: float = 9.81, coriolis_f: float = 0.0,
                            n_fused: int = 2,
                            out: Optional[Fields] = None) -> Fields:
    """The multistep kernel's function in plain PyTorch: ``n_fused``
    applications of the one-step plain version, on any device."""
    return _plain(*_args((u, v, h), out, grid, dt, gravity, coriolis_f,
                         0.0, n_fused=n_fused))


# ------------------------------------------------------- the padded forms

def swe_rk4_step_padded(u_p, v_p, h_p, *, halo: tuple, dt: float,
                        dx: float = 1.0, dy: float = 1.0,
                        gravity: float = 9.81, coriolis_f: float = 0.0,
                        viscosity: float = 0.0,
                        out: Optional[Fields] = None) -> Fields:
    """One fused RK4 step of the interior of halo-padded float32 blocks.

    ``halo`` = (hy, hx): the interior of each (ly + 2 hy, lx + 2 hx) block
    starts at row hy, column hx, and the block holds neighbour data in the
    hy >= 4 rows (hx >= 4 columns) around it, of which the kernel reads
    the 4 next to the interior; hx = 0: x is whole and periodic in the
    block. The blocks may be views with contiguous rows. Returns the
    (ly, lx) step, in ``out`` when given (any views of that shape with
    contiguous rows, such as the interior of the next padded block). CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    return bind_padded(u_p, v_p, h_p, halo=halo, dt=dt, dx=dx, dy=dy,
                       gravity=gravity, coriolis_f=coriolis_f,
                       viscosity=viscosity, out=out)()


def bind_padded(u_p, v_p, h_p, **kw) -> Callable[[], Fields]:
    """``swe_rk4_step_padded(u_p, v_p, h_p, **kw)`` checked and bound
    once (``_bind``), for a stepper that repeats it on its own buffers."""
    return _bind(device_kind(u_p, "swe_rk4_step_padded"),
                 _padded_args(u_p, v_p, h_p, **kw))


def swe_rk4_step_padded_plain(u_p, v_p, h_p, **kw) -> Fields:
    """``swe_rk4_step_padded``'s plain version, on any device (the chip
    smoke test holds the kernel against it on the card)."""
    return _plain(*_padded_args(u_p, v_p, h_p, **kw))


def _padded_args(u_p, v_p, h_p, *, halo: tuple, dt: float, dx: float = 1.0,
                 dy: float = 1.0, gravity: float = 9.81,
                 coriolis_f: float = 0.0, viscosity: float = 0.0,
                 out: Optional[Fields] = None) -> tuple:
    """Check a padded call; return its (ins, out, halo, constants), the
    arguments of ``_launch`` and ``_plain``."""
    ins = (u_p, v_p, h_p)
    hy, hx = (int(x) for x in halo)
    if u_p.dim() != 2:
        raise ValueError("swe_rk4_step_padded: 2-D blocks required")
    ly, lx = u_p.shape[0] - 2 * hy, u_p.shape[1] - 2 * hx
    if hy < HALO or (hx and hx < HALO):
        raise ValueError(f"swe_rk4_step_padded: halo {halo}: the kernel "
                         f"reads {HALO} rows (and columns unless hx = 0)")
    if ly < 1 or lx < (1 if hx else 3):
        raise ValueError(f"swe_rk4_step_padded: interior {ly}x{lx} too small")
    _refuse_fields("swe_rk4_step_padded", ins, out, tuple(u_p.shape),
                   (ly, lx))
    if out is None:
        out = tuple(torch.empty((ly, lx), dtype=torch.float32,
                                device=u_p.device) for _ in ins)
    grid = GridSpec(nx=lx, ny=ly, dx=dx, dy=dy)
    return ins, out, (hy, hx), rk4_constants(grid, dt, gravity, coriolis_f,
                                             viscosity)


def swe_rk4_step_local(u_p, v_p, h_p, *, hy: int = HALO, **kw) -> Fields:
    """Counterpart of ``swe_rk4_step_pallas_local``: the step of the
    (ly, nx) interior of (ly + 2 hy, nx) blocks, x whole and periodic."""
    return swe_rk4_step_padded(u_p, v_p, h_p, halo=(hy, 0), **kw)


def swe_rk4_step_carry(u_p, v_p, h_p, *, hy: int = HALO,
                       out: Optional[Fields] = None, **kw) -> Fields:
    """Counterpart of ``swe_rk4_step_pallas_carry``: the step of the
    interior of (ly + 2 hy, nx) blocks (x whole and periodic), written
    into the interior rows of the padded blocks ``out`` (new ones when
    None), which are returned. Their halo rows are not written: the next
    step's exchange refreshes them."""
    if out is None:
        out = tuple(torch.empty_like(t) for t in (u_p, v_p, h_p))
    rows = out[0].shape[0]
    swe_rk4_step_padded(u_p, v_p, h_p, halo=(hy, 0),
                        out=tuple(o[hy:rows - hy] for o in out), **kw)
    return out


def swe_rk4_step_local2d(u_p, v_p, h_p, *, hy: int = HALO, hx: int = HALO,
                         **kw) -> Fields:
    """Counterpart of ``swe_rk4_step_pallas_local2d``: the step of the
    (ly, lx) interior of (ly + 2 hy, lx + 2 hx) blocks."""
    return swe_rk4_step_padded(u_p, v_p, h_p, halo=(hy, hx), **kw)


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


def _ping_pong_stepper(grid: GridSpec, k: dict, name: str,
                       stages: int) -> Stepper:
    """The Stepper of the kernel whose constants are ``k``, under the rule
    of ``ops/_bound.py``: the carry is a second state buffer, and each step
    writes the new state into it and hands the old state back as the next
    carry. Two buffers ping-pong and a step allocates nothing, so a state
    returned by one step is overwritten by the step after next; callers
    that keep a state copy it (``Simulation._store_output`` does). A state
    it did not hand out is checked as ``swe_rk4_step`` checks it, and the
    stepper binds two launches, one each way between its buffers."""
    def init(s):
        return WeatherState(u=torch.empty_like(s.u), v=torch.empty_like(s.v),
                            h=torch.empty_like(s.h))

    def bind(src: WeatherState, dst: WeatherState):
        ins, out = (src.u, src.v, src.h), (dst.u, dst.v, dst.h)
        _check(*ins, grid, out)
        return _bind(device_kind(src.u, "swe_rk4_step"), (ins, out, (0, 0),
                                                          k))

    def adopt(given):
        spare, s = given    # the carry's buffers take the new state
        return (step((bind(s, spare),), (s, spare)),
                step((bind(spare, s),), given))

    steps = BoundSteps()
    return Stepper(init, lambda spare, s, _dt: steps((spare, s), adopt),
                   name, stages)


def make_kernel_rk4_stepper(grid: GridSpec, params: PhysicsParams,
                            dt: float, variant: str = "slices") -> Stepper:
    """Stepper around the kernel for ``Simulation`` (the counterpart of
    ``make_pallas_rk4_stepper(variant=...)``); ``rk4_kernel_bf16`` for the
    bf16 variants. Two buffers ping-pong (``_ping_pong_stepper``); its
    constants are folded once."""
    bf16 = _is_bf16(variant)
    k = rk4_constants(grid, float(dt), float(params.gravity),
                      float(params.coriolis_f), float(params.viscosity), bf16)
    return _ping_pong_stepper(grid, k,
                              "rk4_kernel_bf16" if bf16 else "rk4_kernel", 4)


def make_kernel_multistep_stepper(grid: GridSpec, params: PhysicsParams,
                                  dt: float, n_fused: int = 2) -> Stepper:
    """Stepper around ``swe_rk4_multistep``: each of its steps advances
    ``n_fused`` RK4 steps of ``dt`` in one launch, so a ``Simulation``
    driving it takes ``dt * n_fused`` as its own step. Viscosity must be 0
    (the kernel has none, as in the JAX package)."""
    if float(params.viscosity) != 0.0:
        raise ValueError("swe_rk4_multistep has no viscosity term")
    k = dict(rk4_constants(grid, float(dt), float(params.gravity),
                           float(params.coriolis_f), 0.0),
             fused=_fused(n_fused))
    return _ping_pong_stepper(grid, k, f"rk4_kernel_x{n_fused}",
                              4 * n_fused)
