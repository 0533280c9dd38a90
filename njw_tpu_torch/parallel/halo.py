"""Halo exchange and the sharded weather steppers.

Counterpart of ``njw_tpu/parallel/halo.py``: ``halo_pad_2d``,
``make_padded_shift_fn``, ``interior_crop``; the plain sharded steppers
(``sharded_swe_step`` :149, ``sharded_pe_step`` :276, with the
interior/edge overlap; the sharded barotropic core
``sharded_barotropic_step`` :421 and ``_2d`` :523 on the distributed FFT
of ``parallel/fft.py``), which run the plain tendencies and launch no
kernel; and the steppers that run the fused kernels per shard
(``sharded_swe_step_pallas`` :743 and ``_2d`` :820,
``sharded_pe_step_pallas`` :590 and ``_2d`` :1029,
``sharded_pe_step_pallas_fused`` :664 and ``_fused_2d`` :886), named with
``kernel`` for ``pallas``. They run on either mesh of
``njw_tpu_torch.parallel.mesh``.

Each constructor returns a stepper: ``step(shards) -> shards`` advances
the shards this process holds (a list, row-major) by ``n_steps`` and
returns new interior-shaped shards. The plain steppers
(``PlainShardedStepper``) are the JAX ones: any BC, the beta-plane,
viscosity and any explicit integrator, a 1-point halo exchanged at every
tendency evaluation. In the kernel steppers each shard's state lives in
padded blocks with exactly the halo its kernel reads (4 rows, and 4
columns on a 2-D mesh, for the whole-step kernels K1 and K4; 1 for the
stage kernel K5). Each step refreshes only those halo bands by exchange
(x bands over the interior rows first, then y bands over the full padded
width, so the corners ride along; an axis is one ``mesh.pair_exchange``
and one strip-copy launch of what arrives into the bands) and launches
the kernel on every shard in turn. The blocks, and the exchange's
buffers, are made at the first call and reused: a step allocates
nothing. On ``LocalMesh`` the shards' launches follow one another on one
stream.

The kernel steppers, as in the JAX package: periodic BC and a numeric f
only (``NotImplementedError`` otherwise); a mesh with px > 1 takes the 2-D
form; the fused 2-D form falls back to the stage path where the
whole-step kernel does not fit (here ``pe_rk4_kernel_fits``, the port's
own rule: a one-column tile of L levels in the shared memory of a cluster
of eight blocks, L <= 688). The fused steppers take K4 wherever it fits,
as a user who names them asks (the whole-domain auto choice takes the
stage path, which the H100 timed faster). Beyond it: beta must be 0 and, for PE, viscosity 0 (the JAX
sharded kernel paths drop both without a word), and the SWE paths apply
the viscosity the JAX ones drop (ROADMAP section 3). The TPU's tile
conditions (ly % 8, lx % 128) do not apply: the kernels mask ragged tiles.
"""
from __future__ import annotations

import numbers
import time
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from njw_tpu_torch.ops import pe_stencil, stencil
from njw_tpu_torch.ops._bound import BoundSteps, step
from njw_tpu_torch.ops.halo_strips import bind_strips, copy_strips_cuda
from njw_tpu_torch.ops.stencil import HALO as SWE_HALO
from njw_tpu_torch.parallel.mesh import ProcessMesh
from njw_tpu_torch.weather.barotropic import BarotropicState
from njw_tpu_torch.weather.dynamics import (
    coriolis_field, scalar_bc, swe_tendencies_from_shifts,
)
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.utils import profiling
from njw_tpu_torch.weather.integrators import INTEGRATORS, Stepper, \
    make_stepper
from njw_tpu_torch.weather.primitive import PEState, pe_tendencies_from_shifts

SWE_FIELDS = ("u", "v", "h")


# ------------------------------------------------------------ the exchange

def halo_pad_2d(mesh, fields: Sequence[torch.Tensor], halo: int = 1, *,
                bc: str = "periodic", wall_sign_x: float = 1.0,
                wall_sign_y: float = 1.0) -> list[torch.Tensor]:
    """Pad each local (..., ly, lx) shard to (..., ly + 2h, lx + 2h) with
    its neighbours' data (``fields``: one tensor per local shard).

    x first, then y over the x-padded block, so the corners come along.
    For bc 'clamped' and 'reflective' the exchange is still a ring, but
    shards on the global boundary overwrite the wrapped halo with their
    own edge, times ``wall_sign_{x,y}`` (-1 for the wall-normal velocity
    of a reflective wall; the x flip comes before the y clamp, so corners
    get exactly one flip)."""
    blocks = pad_blocks(mesh, [(f,) for f in fields], halo, bc=bc,
                        signs_x=(wall_sign_x,), signs_y=(wall_sign_y,))
    return [b[0] for b in blocks]


def pad_blocks(mesh, blocks: Sequence[tuple], halo: int = 1, *,
               bc: str = "periodic", signs_x: Sequence[float] = None,
               signs_y: Sequence[float] = None) -> list[tuple]:
    """``halo_pad_2d`` of several fields a shard at once (``blocks``: one
    tuple of fields per local shard; ``signs_*``: each field's wall sign,
    1 by default): one exchange carries them all."""
    started = pad_start(mesh, blocks, "x", halo)
    padded = pad_finish(mesh, blocks, started, "x", halo, bc, signs_x)
    started = pad_start(mesh, padded, "y", halo)
    return pad_finish(mesh, padded, started, "y", halo, bc, signs_y)


def _dim(axis: str) -> int:
    return -1 if axis == "x" else -2


def pad_start(mesh, blocks: Sequence[tuple], axis: str, halo: int) -> tuple:
    """Post the exchange of every field's edge strips along ``axis`` (both
    directions): the last ``halo`` rows or columns go to the next shard,
    the first to the previous one. ``pad_finish`` completes it."""
    dim = _dim(axis)
    lo = mesh.ring_shift_start(
        [tuple(f.narrow(dim, f.shape[dim] - halo, halo) for f in b)
         for b in blocks], axis, +1)
    hi = mesh.ring_shift_start(
        [tuple(f.narrow(dim, 0, halo) for f in b) for b in blocks], axis, -1)
    return lo, hi


def pad_finish(mesh, blocks: Sequence[tuple], started: tuple, axis: str,
               halo: int, bc: str = "periodic",
               signs: Sequence[float] = None) -> list[tuple]:
    """Wait for ``pad_start``'s exchange and pad every field along
    ``axis``; under a clamped or reflective ``bc`` the shards on the
    global boundary take their own edge times the field's sign instead."""
    dim = _dim(axis)
    n = mesh.axis_size(axis)
    clamp = bc in ("clamped", "reflective")
    lo, hi = (h.wait() for h in started)
    out = []
    for b, low, high, i in zip(blocks, lo, hi, mesh.axis_index(axis)):
        fields = []
        for k, (f, a, c) in enumerate(zip(b, low, high)):
            sign = 1.0 if signs is None else signs[k]
            if clamp and i == 0:
                a = sign * f.narrow(dim, 0, 1).expand_as(a)
            if clamp and i == n - 1:
                c = sign * f.narrow(dim, f.shape[dim] - 1, 1).expand_as(c)
            fields.append(torch.cat([a, f, c], dim=dim))
        out.append(tuple(fields))
    return out


def make_padded_shift_fn(halo: int, ly: int, lx: int) -> Callable:
    """Slicing-view shift accessor over an (ly + 2h, lx + 2h) padded block,
    with the signature of ``dynamics.make_shift_fn``: shift(f, dxi, dyi)
    is the (ly, lx) view offset by (dxi, dyi)."""
    h = halo

    def shift(fp: torch.Tensor, dxi: int = 0, dyi: int = 0) -> torch.Tensor:
        return fp[..., h + dyi:h + dyi + ly, h + dxi:h + dxi + lx]

    return shift


def interior_crop(halo: int, ly: int, lx: int) -> Callable:
    h = halo

    def crop(fp: torch.Tensor) -> torch.Tensor:
        return fp[..., h:h + ly, h:h + lx]

    return crop


class _Fill:
    """One axis of a halo refresh: ``exchange`` (``mesh.pair_exchange``),
    then one strip copy of what arrives into ``bands`` (``bind_strips``:
    one launch of ``ops/csrc/halo_strips.cu`` on CUDA, a launch per 80
    strips; ``_foreach_copy_`` on the CPU). The copy is bound to the
    tensors the exchange returns (views valid until its next call, the
    same tensors at every call on both meshes): at the first call, and
    again should an exchange return other tensors."""

    def __init__(self, exchange, bands: list):
        self.exchange, self.bands = exchange, bands
        self.got, self.copies = [], ()

    def __call__(self) -> None:
        got = [s for side in self.exchange() for src in side for s in src]
        if not self.got or any(a is not b for a, b in zip(got, self.got)):
            self.got = got
            self.copies = bind_strips(list(zip(got, self.bands)))
        for copy in self.copies:
            copy()


class _Bands:
    """The halo bands of every local shard's padded fields, and the
    interior strips that fill the neighbours' bands, as views made once.
    ``blocks``: one tuple of padded fields per local shard, the interior
    (ly, lx) at ``halo`` = (hy, hx); hx = 0: x is whole (no x exchange)."""

    def __init__(self, blocks: Sequence[tuple], halo: tuple, inner: tuple):
        hy, hx = halo
        ly, lx = inner
        self.axes = []
        if hx:
            rows = [tuple(t[..., hy:hy + ly, :] for t in b) for b in blocks]
            self.axes.append(("x",) + self._views(rows, -1, hx, lx))
        self.axes.append(("y",) + self._views(blocks, -2, hy, ly))
        self._mesh, self._fills = None, []

    @staticmethod
    def _views(blocks, dim: int, h: int, n: int) -> tuple:
        def strips(start):
            return [tuple(t.narrow(dim, start, h) for t in b) for b in blocks]

        # the last h interior strips fill the next shard's low band, the
        # first h the previous shard's high band
        return strips(n), strips(h), strips(0), strips(n + h)

    def refresh(self, mesh) -> None:
        """Fill every band from its neighbour: a ``_Fill`` an axis (made at
        the first refresh on ``mesh``). While a profiler records, the
        refresh is a ``sim.step.exchange`` span (from the first exchange
        to the last band's copy enqueued) counting the mesh's own
        ``exchanges`` and ``exchange_bytes`` over it, and the device
        operations it enqueued (``launches``: strip-copy launches, and on
        a ``ProcessMesh`` its collectives, one an exchange)."""
        t0 = time.perf_counter()
        n0, b0 = mesh.exchanges, mesh.exchange_bytes
        k0 = copy_strips_cuda.launches
        if self._mesh is not mesh:
            self._fills = [
                _Fill(mesh.pair_exchange(last, first, axis),
                      [d for bands in (band_lo, band_hi) for dst in bands
                       for d in dst])
                for axis, last, first, band_lo, band_hi in self.axes]
            self._mesh = mesh
        for fill in self._fills:
            fill()
        if profiling.recording():
            n = mesh.exchanges - n0
            profiling.record(
                "sim.step.exchange", t0, time.perf_counter(), exchanges=n,
                exchange_bytes=mesh.exchange_bytes - b0,
                launches=copy_strips_cuda.launches - k0
                + (n if isinstance(mesh, ProcessMesh) else 0))


# ------------------------------------------------------------ the steppers

def _kernel_rules(grid: GridSpec, params: PhysicsParams, name: str,
                  pe: bool) -> None:
    """The JAX package's rules for its kernel-backed sharded paths, and
    the terms they would drop."""
    if grid.bc != "periodic":
        raise NotImplementedError(f"{name}: periodic BC required")
    if not isinstance(params.coriolis_f, numbers.Number):
        raise NotImplementedError(f"{name}: constant Coriolis f only")
    if not isinstance(params.beta, numbers.Number) or float(params.beta):
        raise NotImplementedError(f"{name}: beta must be 0 on the kernel "
                                  "path")
    if not isinstance(params.viscosity, numbers.Number) or (
            pe and float(params.viscosity)):
        raise NotImplementedError(f"{name}: viscosity must be "
                                  f"{'0' if pe else 'a number'} on the "
                                  "kernel path")


def _block(grid: GridSpec, mesh, need: int, name: str) -> tuple[int, int]:
    """(ly, lx) of a shard; each axis that is exchanged must be at least
    the halo the kernel reads, a whole x at least 3."""
    ly, lx = mesh.block_shape(grid.ny, grid.nx)
    if ly < need or (lx < need if mesh.px > 1 else lx < 3):
        raise ValueError(f"{name}: shard {ly}x{lx} smaller than the "
                         f"kernel's halo of {need}")
    return ly, lx


def _check_shards(name: str, mesh, shards: Sequence, cls, fields: tuple,
                  inner: tuple) -> None:
    """Refuse shards that are not ``cls`` states of ``fields``, of interior
    shape ``inner``, float32 on the mesh's device."""
    mesh._check_shards(shards)
    for s in shards:
        if not isinstance(s, cls) or tuple(n for n, _ in s.items()) != fields:
            raise TypeError(f"{name}: shards must be {cls.__name__}s of "
                            f"{fields}")
        for n, t in s.items():
            if tuple(t.shape[-2:]) != tuple(inner) or \
                    t.device != mesh.device or t.dtype != torch.float32:
                raise ValueError(
                    f"{name}: shard field {n} is {tuple(t.shape)} {t.dtype} "
                    f"on {t.device}; expected (..., {inner[0]}, {inner[1]}) "
                    f"float32 on {mesh.device}")


class ShardedStepper:
    """``step(shards) -> shards`` over ``n_steps`` steps (see the module
    docstring), under the rule of ``ops/_bound.py``. ``name``: the form.
    Each form makes its blocks at the first call (``_make``) and binds
    the cycle of its steps on them once: the exchanges, copies and kernel
    launches of each step. Shards it did not hand out are checked and
    copied into the interior views the cycle's first step reads
    (``self._input``)."""

    name = ""
    stages = 4

    def __init__(self, mesh, n_steps: int, inner: tuple, halo: tuple,
                 cls, filler: float):
        self.mesh, self.n_steps = mesh, int(n_steps)
        self.inner, self.halo = inner, halo
        self.cls, self.filler = cls, filler
        self.fields = SWE_FIELDS if cls is WeatherState else PEState.FIELDS
        self._bound, self._input = None, None
        self._steps = BoundSteps()

    # padded states of every local shard, the halo filled with ``filler``
    # (ones for PE: a stale ps cell must never reach a log as 0)
    def _padded(self, like: Sequence) -> list:
        hy, hx = self.halo

        def pad(a):
            shape = a.shape[:-2] + (a.shape[-2] + 2 * hy, a.shape[-1] + 2 * hx)
            return torch.full(shape, self.filler, dtype=a.dtype,
                              device=a.device)

        return [s.map(pad) for s in like]

    def _interior(self, st):
        hy, hx = self.halo
        ly, lx = self.inner
        return st.map(lambda a: a[..., hy:hy + ly, hx:hx + lx])

    def _adopt(self, shards: tuple) -> list:
        _check_shards(self.name, self.mesh, shards, self.cls, self.fields,
                      self.inner)
        if self._bound is None:
            self._bound = self._make(shards)
        _copies(self._input, shards)()
        return self._bound

    def __call__(self, shards: Sequence) -> list:
        return [_copy(st) for st in self.advance(shards)]

    def advance(self, shards: Sequence) -> list:
        """``n_steps`` steps like a call, returning the stepper's own
        interior views in place of new states: they are overwritten by the
        step after next. Shards that are the views it returned last are
        stepped in place, with no copy into the blocks."""
        handed = tuple(shards)
        for _ in range(self.n_steps):
            handed = self._steps(handed, self._adopt)
        return list(handed)


def _fields(st) -> tuple:
    return tuple(t for _, t in st.items())


def _copy(st):
    """A new contiguous state with the values of ``st`` (views)."""
    return st.map(lambda a: a.clone(memory_format=torch.contiguous_format))


def _copies(dst: Sequence, src: Sequence) -> Callable[[], None]:
    """The copy of every field of the states ``src`` into ``dst``."""
    pairs = [(d, x) for a, b in zip(dst, src)
             for d, x in zip(_fields(a), _fields(b))]

    def run():
        for d, x in pairs:
            d.copy_(x)

    return run


class _CarryStepper(ShardedStepper):
    """The persistent padded carry (JAX's ``_carry`` and ``carry2d``
    forms): two padded blocks per shard ping-pong; each step refreshes the
    input's bands and the kernel writes the other block's interior."""

    def _make(self, shards):
        pads = [self._padded(shards) for _ in range(2)]
        inner = [[self._interior(p) for p in ps] for ps in pads]
        self._input = inner[0]
        steps = []
        for t in (0, 1):
            bands = _Bands([_fields(p) for p in pads[t]], self.halo,
                           self.inner)
            steps.append(step(
                [partial(bands.refresh, self.mesh)] + [
                    self._bind(src, out)
                    for src, out in zip(pads[t], inner[1 - t])],
                tuple(inner[1 - t])))
        return steps


class _ConcatStepper(ShardedStepper):
    """JAX's ``_local2d`` (concat) form: the state stays interior-shaped;
    each step copies it into one padded block per shard, refreshes the
    bands, and the kernel writes the next interior-shaped state (two
    such states ping-pong)."""

    def _make(self, shards):
        pads = self._padded(shards)
        bands = _Bands([_fields(p) for p in pads], self.halo, self.inner)
        inner = [self._interior(p) for p in pads]
        states = [[s.map(torch.empty_like) for s in shards]
                  for _ in range(2)]
        self._input = states[1]
        return [step([_copies(inner, states[1 - t]),
                      partial(bands.refresh, self.mesh)]
                     + [self._bind(src, out)
                        for src, out in zip(pads, states[t])],
                     tuple(states[t]))
                for t in (0, 1)]


# --------------------------------------------------------------------- SWE

class _SWEForm:
    def _setup(self, grid, params, dt):
        self.kw = dict(dt=float(dt), dx=float(grid.dx), dy=float(grid.dy),
                       gravity=float(params.gravity),
                       coriolis_f=float(params.coriolis_f),
                       viscosity=float(params.viscosity))

    def _bind(self, src: WeatherState, out: WeatherState) -> Callable:
        return stencil.bind_padded(src.u, src.v, src.h, halo=self.halo,
                                   out=(out.u, out.v, out.h), **self.kw)


class _SWECarry(_SWEForm, _CarryStepper):
    name = "swe_rk4_carry"


class _SWELocal2d(_SWEForm, _ConcatStepper):
    name = "swe_rk4_local2d"


def sharded_swe_step_kernel(grid: GridSpec, params: PhysicsParams, mesh, *,
                            dt: float, n_steps: int = 1) -> ShardedStepper:
    """Sharded SWE RK4 with the fused kernel K1 per shard. 1-D row
    decomposition (px = 1): x whole per shard, each step exchanges 4 halo
    rows per side into a persistent padded carry and the kernel writes the
    next carry's interior (``swe_rk4_step_carry``). A mesh with px > 1
    takes the 2-D form (``sharded_swe_step_kernel_2d``)."""
    name = "sharded_swe_step_kernel"
    _kernel_rules(grid, params, name, pe=False)
    if mesh.px > 1:
        return sharded_swe_step_kernel_2d(grid, params, mesh, dt=dt,
                                          n_steps=n_steps)
    ly, lx = _block(grid, mesh, SWE_HALO, name)
    st = _SWECarry(mesh, n_steps, (ly, lx), (SWE_HALO, 0), WeatherState,
                   0.0)
    st._setup(grid, params, dt)
    return st


def sharded_swe_step_kernel_2d(grid: GridSpec, params: PhysicsParams, mesh,
                               *, dt: float, n_steps: int = 1
                               ) -> ShardedStepper:
    """Sharded SWE RK4 with K1 over a ('y', 'x') mesh: per step each shard
    exchanges 4 halo columns, then 4 halo rows of the x-padded block
    (corners ride along), and the kernel steps the (ly, lx) interior
    (``swe_rk4_step_local2d``)."""
    name = "sharded_swe_step_kernel_2d"
    _kernel_rules(grid, params, name, pe=False)
    ly, lx = _block(grid, mesh, SWE_HALO, name)
    st = _SWELocal2d(mesh, n_steps, (ly, lx), (SWE_HALO, SWE_HALO),
                     WeatherState, 0.0)
    st._setup(grid, params, dt)
    return st


# ---------------------------------------------------------------------- PE

class _PEFused:
    def _setup(self, grid, params, dt):
        self.kw = dict(dt=float(dt), dx=float(grid.dx), dy=float(grid.dy),
                       coriolis_f=float(params.coriolis_f))

    def _bind(self, src: PEState, out: PEState) -> Callable:
        return pe_stencil.bind_rk4_padded(src, halo=self.halo, out=out,
                                          **self.kw)


class _PEFusedCarry(_PEFused, _CarryStepper):
    name = "pe_rk4_carry"


class _PEFusedCarry2d(_PEFused, _CarryStepper):
    name = "pe_rk4_carry2d"


class _PEFusedLocal2d(_PEFused, _ConcatStepper):
    name = "pe_rk4_local2d"


class _PEStages(ShardedStepper):
    """Four K5 stage launches per shard per step, the RK4 combine fused
    into the last (as the whole-domain stage stepper):

        s1 = s + dt/2 T(s);  s2 = s + dt/2 T(s1);  s3 = s + dt T(s2)
        s' = (-s + s1 + 2 s2 + s3)/3 + dt/6 T(s3)

    Four padded states per shard; each stage refreshes the one-point halo
    band of its input, reads the bases at interior shape (views of the
    padded states) and writes the next padded state's interior. The last
    stage writes s' over s1 (a base, read at each point before it is
    written there). The four states' roles turn by one each step, so the
    cycle is four steps."""

    def _setup(self, grid, params, dt):
        dt = float(dt)
        third = 1.0 / 3.0
        self.kw = dict(dx=float(grid.dx), dy=float(grid.dy),
                       coriolis_f=float(params.coriolis_f))
        self.c = (0.5 * dt, 0.5 * dt, dt, dt / 6.0)
        self.combine = (-third, third, 2.0 * third, third)

    def _make(self, shards):
        pads = [self._padded(shards) for _ in range(4)]
        bands = [_Bands([_fields(p) for p in ps], self.halo, self.inner)
                 for ps in pads]
        inner = [[self._interior(p) for p in ps] for ps in pads]
        self._input = inner[0]

        def stage(k_in, bases, coeffs, k_out, c_dt):
            return [partial(bands[k_in].refresh, self.mesh)] + [
                pe_stencil.bind_stage_padded(
                    cur, tuple(inner[g][j] for g in bases), halo=self.halo,
                    c_dt=c_dt, base_coeffs=coeffs, out=inner[k_out][j],
                    **self.kw)
                for j, cur in enumerate(pads[k_in])]

        steps, one = [], (1.0,)
        s0, s1, s2, s3 = range(4)
        for _ in range(4):
            steps.append(step(
                stage(s0, (s0,), one, s1, self.c[0])
                + stage(s1, (s0,), one, s2, self.c[1])
                + stage(s2, (s0,), one, s3, self.c[2])
                + stage(s3, (s0, s1, s2, s3), self.combine, s1, self.c[3]),
                tuple(inner[s1])))
            s0, s1, s2, s3 = s1, s2, s3, s0
        return steps


class _PEStages1d(_PEStages):
    name = "pe_stage_local"


class _PEStages2d(_PEStages):
    name = "pe_stage_local2d"


def _pe_stepper(cls, grid, params, mesh, dt, n_steps, halo, name):
    ly, lx = _block(grid, mesh, max(halo), name)
    st = cls(mesh, n_steps, (ly, lx), halo, PEState, 1.0)
    st._setup(grid, params, dt)
    return st


def sharded_pe_step_kernel(grid: GridSpec, params: PhysicsParams, mesh, *,
                           dt: float, n_steps: int = 1) -> ShardedStepper:
    """Sharded PE RK4 on the stage kernel K5 per shard (four exchanges of
    one halo row and four stage launches per step). 1-D row decomposition
    (``pe_stage_local``); a mesh with px > 1 takes the 2-D form."""
    name = "sharded_pe_step_kernel"
    _kernel_rules(grid, params, name, pe=True)
    if mesh.px > 1:
        return sharded_pe_step_kernel_2d(grid, params, mesh, dt=dt,
                                         n_steps=n_steps)
    return _pe_stepper(_PEStages1d, grid, params, mesh, dt, n_steps,
                       (pe_stencil.STAGE_HALO, 0), name)


def sharded_pe_step_kernel_2d(grid: GridSpec, params: PhysicsParams, mesh,
                              *, dt: float, n_steps: int = 1
                              ) -> ShardedStepper:
    """Sharded PE RK4 on K5 over a ('y', 'x') mesh: per stage one halo
    column, then one halo row of the x-padded block
    (``pe_stage_local2d``)."""
    name = "sharded_pe_step_kernel_2d"
    _kernel_rules(grid, params, name, pe=True)
    h = pe_stencil.STAGE_HALO
    return _pe_stepper(_PEStages2d, grid, params, mesh, dt, n_steps, (h, h),
                       name)


def sharded_pe_step_kernel_fused(grid: GridSpec, params: PhysicsParams, mesh,
                                 *, dt: float, n_steps: int = 1
                                 ) -> ShardedStepper:
    """Sharded PE RK4 on the whole-step kernel K4 per shard: one exchange
    of 4 halo rows and one launch per step, into a persistent padded carry
    (``pe_rk4_carry``); x whole per shard. A mesh with px > 1 takes the
    2-D form (``sharded_pe_step_kernel_fused_2d``)."""
    name = "sharded_pe_step_kernel_fused"
    _kernel_rules(grid, params, name, pe=True)
    if mesh.px > 1:
        return sharded_pe_step_kernel_fused_2d(grid, params, mesh, dt=dt,
                                               n_steps=n_steps)
    if not pe_stencil.pe_rk4_kernel_fits(grid.levels):
        raise ValueError(f"{name}: {grid.levels} levels do not fit the "
                         "whole-step kernel")
    return _pe_stepper(_PEFusedCarry, grid, params, mesh, dt, n_steps,
                       (pe_stencil.RK4_HALO, 0), name)


def sharded_pe_step_kernel_fused_2d(grid: GridSpec, params: PhysicsParams,
                                    mesh, *, dt: float, n_steps: int = 1,
                                    carry: bool = False) -> ShardedStepper:
    """Sharded PE RK4 on K4 over a ('y', 'x') mesh: one exchange (4 halo
    columns, then 4 halo rows of the x-padded block) and one launch per
    step. ``carry=False`` (the default, as in the JAX package): the state
    stays interior-shaped and is copied into a padded block each step
    (``pe_rk4_local2d``); ``carry=True``: the padded block is the state
    and the kernel writes the next one's interior (``pe_rk4_carry2d``, the
    TPU kernel K6). Where the whole-step kernel does not fit
    (``pe_rk4_kernel_fits``), the stage path (``sharded_pe_step_kernel_2d``).
    """
    name = "sharded_pe_step_kernel_fused_2d"
    _kernel_rules(grid, params, name, pe=True)
    if not pe_stencil.pe_rk4_kernel_fits(grid.levels):
        return sharded_pe_step_kernel_2d(grid, params, mesh, dt=dt,
                                         n_steps=n_steps)
    h = pe_stencil.RK4_HALO
    return _pe_stepper(_PEFusedCarry2d if carry else _PEFusedLocal2d, grid,
                       params, mesh, dt, n_steps, (h, h), name)


# ------------------------------------------------------ the plain steppers

class _Shards(list):
    """The local shard states as one state for the integrators of
    ``weather/integrators.py``: ``map`` maps each shard's fields, so every
    stage combine runs in the integrator's own order on each shard."""

    def map(self, fn, *others):
        return _Shards(s.map(fn, *(o[i] for o in others))
                       for i, s in enumerate(self))

    @property
    def device(self) -> torch.device:
        return self[0].device


class PlainShardedStepper:
    """``step(shards) -> shards`` over ``n_steps`` steps of an integrator
    of ``weather/integrators.py`` (the JAX package's ``lax.scan`` inside
    ``shard_map``): each tendency evaluation exchanges the halos it needs
    and evaluates every local shard with plain PyTorch operations. There is
    no ``donate``: the stages' temporaries go back to PyTorch's allocator
    as soon as a stage drops them. ``stages``: tendency evaluations a
    step; ``exchange(shards)`` runs the exchanges of one of them, for
    measurement."""

    def __init__(self, name: str, mesh, cls, fields: tuple, inner: tuple,
                 tendency, exchange, *, method: str, dt: float,
                 n_steps: int):
        if method not in INTEGRATORS:
            raise ValueError(f"{name}: unknown method {method!r}; the "
                             f"sharded steppers take {sorted(INTEGRATORS)}")
        self.name, self.mesh, self.inner = name, mesh, inner
        self.cls, self.fields = cls, fields
        self.n_steps = int(n_steps)
        self._integrator = make_stepper(method, tendency)
        self.stages = self._integrator.stages
        # dt enters as a float32 value, as in Simulation
        self._dt = float(np.float32(dt))
        self._exchange = exchange

    def __call__(self, shards: Sequence) -> list:
        _check_shards(self.name, self.mesh, shards, self.cls, self.fields,
                      self.inner)
        s = _Shards(shards)
        carry = self._integrator.init(s)
        for _ in range(self.n_steps):
            carry, s = self._integrator.step(carry, s, self._dt)
        return list(s)

    def exchange(self, shards: Sequence) -> None:
        self._exchange(shards)

    advance = __call__


def simulation_stepper(sharded, shards: Sequence) -> tuple:
    """(state, ``Stepper``) of a sharded stepper of one step, for
    ``weather.model.Simulation``: the state is the one shard of
    ``shards`` where there is one (a ``ProcessMesh`` rank's), else the
    list of them; each step is one ``sharded.advance``. dt is the
    stepper's own."""
    single = len(shards) == 1

    def step(carry, state, _dt):
        out = sharded.advance([state] if single else list(state))
        return carry, (out[0] if single else _Shards(out))

    state = shards[0] if single else _Shards(shards)
    return state, Stepper(lambda s: None, step, sharded.name, sharded.stages)


def _stitch(top, left, interior, right, bot):
    """Reassemble (1, lx) + (h, 1) + (h, w) + (h, 1) + (1, lx) edge strips
    into the whole (ly, lx) block (leading dims broadcast)."""
    mid = torch.cat([left, interior, right], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def _wall_signs(bc: str, fields: tuple) -> tuple:
    """Each field's (x, y) wall signs: under a reflective BC the
    wall-normal velocity's ghost flips (u at the x walls, v at the y
    walls)."""
    refl = bc == "reflective"
    return (tuple(-1.0 if refl and f == "u" else 1.0 for f in fields),
            tuple(-1.0 if refl and f == "v" else 1.0 for f in fields))


def _halo_tendency(mesh, grid: GridSpec, cls, fields: tuple, inner: tuple,
                   physics, overlap: bool):
    """(T, exchange): T(shards) evaluates ``physics(j, block, shift, crop,
    rows)`` (the tendency fields of local shard j, from its fields
    ``block`` read through ``shift``, cropped by ``crop``; ``rows``: the
    shard's rows the output covers) over every local shard, from a 1-point
    halo. ``overlap=False``: on the padded block. ``overlap=True``: the
    interior (ly - 2, lx - 2) from the unpadded block while the x exchange
    is in flight, the left and right strips from the x-padded block while
    the y exchange is in flight, then the top and bottom rows, stitched
    (``halo.py:149-273``); the same arithmetic per point."""
    ly, lx = inner
    sx, sy = _wall_signs(grid.bc, fields)
    bc = scalar_bc(grid.bc)
    shift, crop = make_padded_shift_fn(1, ly, lx), interior_crop(1, ly, lx)
    shift_i = make_padded_shift_fn(1, ly - 2, lx - 2)
    crop_i = interior_crop(1, ly - 2, lx - 2)
    whole, mid = slice(0, ly), slice(1, ly - 1)

    def blocks_of(states):
        return [tuple(getattr(s, f) for f in fields) for s in states]

    def exchange(states):
        return pad_blocks(mesh, blocks_of(states), 1, bc=bc, signs_x=sx,
                          signs_y=sy)

    def region(j, block, rows, cols, h, w, out_rows):
        return physics(j, tuple(f[..., rows, cols] for f in block),
                       make_padded_shift_fn(1, h, w), interior_crop(1, h, w),
                       out_rows)

    def padded(states):
        return _Shards(cls(*physics(j, b, shift, crop, whole))
                       for j, b in enumerate(exchange(states)))

    def overlapped(states):
        blocks = blocks_of(states)
        started = pad_start(mesh, blocks, "x", 1)
        inner_t = [physics(j, b, shift_i, crop_i, mid)
                   for j, b in enumerate(blocks)]
        px_blocks = pad_finish(mesh, blocks, started, "x", 1, bc, sx)
        started = pad_start(mesh, px_blocks, "y", 1)
        # rows 0..ly-1 of the x-padded block are rows 1..ly of the padded
        left = [region(j, b, whole, slice(0, 3), ly - 2, 1, mid)
                for j, b in enumerate(px_blocks)]
        right = [region(j, b, whole, slice(lx - 1, lx + 2), ly - 2, 1, mid)
                 for j, b in enumerate(px_blocks)]
        full = pad_finish(mesh, px_blocks, started, "y", 1, bc, sy)
        out = _Shards()
        for j, b in enumerate(full):
            top = region(j, b, slice(0, 3), slice(None), 1, lx, slice(0, 1))
            bot = region(j, b, slice(ly - 1, ly + 2), slice(None), 1, lx,
                         slice(ly - 1, ly))
            out.append(cls(*(_stitch(*parts) for parts in zip(
                top, left[j], inner_t[j], right[j], bot))))
        return out

    return (overlapped if overlap else padded), exchange


def sharded_swe_step(grid: GridSpec, params: PhysicsParams, mesh, *,
                     dt: float, method: str = "rk4", n_steps: int = 1,
                     overlap: bool = True) -> PlainShardedStepper:
    """Sharded SWE step on the plain tendencies (``sharded_swe_step``,
    ``njw_tpu/parallel/halo.py:149``): every tendency evaluation exchanges
    a 1-point halo of u, v and h (one exchange a direction carries all
    three) and evaluates ``swe_tendencies_from_shifts`` per shard; any
    integrator of ``weather/integrators.py``; every BC (clamped and
    reflective walls through the halo pad's wall signs), the beta-plane
    (each shard's rows of ``dynamics.coriolis_field``) and viscosity.
    ``overlap=True`` computes the interior from the unpadded block while
    the exchange is in flight (``_halo_tendency``); it falls back to the
    padded form when a shard has fewer than 4 rows or columns."""
    ly, lx = mesh.block_shape(grid.ny, grid.nx)
    overlap = overlap and ly >= 4 and lx >= 4
    f = None
    if params.beta != 0.0:
        f = coriolis_field(grid, params, mesh.device)
    rows0 = [iy * ly for iy in mesh.axis_index("y")]

    def physics(j, block, shift, crop, rows):
        p = params
        if f is not None:
            # the shard's rows of the whole domain's (ny, 1) field
            p = params.replace(
                coriolis_f=f[rows0[j]:rows0[j] + ly][rows])
        u, v, h = block
        return swe_tendencies_from_shifts(u, v, h, shift, grid, p,
                                          interior=crop)

    tendency, exchange = _halo_tendency(mesh, grid, WeatherState, SWE_FIELDS,
                                        (ly, lx), physics, overlap)
    return PlainShardedStepper("sharded_swe_step", mesh, WeatherState,
                               SWE_FIELDS, (ly, lx), tendency, exchange,
                               method=method, dt=dt, n_steps=n_steps)


def sharded_pe_step(grid: GridSpec, params: PhysicsParams, mesh, *,
                    dt: float, method: str = "rk4", n_steps: int = 1,
                    overlap: bool = True) -> PlainShardedStepper:
    """Sharded primitive-equations step on the plain tendencies
    (``sharded_pe_step``, ``njw_tpu/parallel/halo.py:276``): the levels
    stay whole; every tendency evaluation exchanges a 1-point halo of u,
    v, T, q and ps in one exchange a direction and evaluates
    ``pe_tendencies_from_shifts`` per shard (f-plane, viscosity, every
    BC, no terrain). ``overlap`` as in ``sharded_swe_step``."""
    ly, lx = mesh.block_shape(grid.ny, grid.nx)
    overlap = overlap and ly >= 4 and lx >= 4

    def physics(j, block, shift, crop, rows):
        out = pe_tendencies_from_shifts(PEState(*block), shift, grid, params,
                                        interior=crop)
        return tuple(t for _, t in out.items())

    tendency, exchange = _halo_tendency(mesh, grid, PEState, PEState.FIELDS,
                                        (ly, lx), physics, overlap)
    return PlainShardedStepper("sharded_pe_step", mesh, PEState,
                               PEState.FIELDS, (ly, lx), tendency, exchange,
                               method=method, dt=dt, n_steps=n_steps)


# --------------------------------------------- the sharded barotropic core

def _halo_pad_y(mesh, blocks: Sequence[tuple], bc: str = "periodic"
                ) -> list[tuple]:
    """Pad only the row axis of every field with 1-row neighbour halos (x
    stays whole; ``halo.py:378``): one exchange a direction carries all
    the fields of a shard."""
    started = pad_start(mesh, blocks, "y", 1)
    return pad_finish(mesh, blocks, started, "y", 1, bc)


def _arakawa(sh, p, z, dx: float, dy: float) -> torch.Tensor:
    """The arithmetic of ``weather.barotropic.arakawa_jacobian`` over the
    neighbour accessor ``sh(f, dx_, dy_)``."""
    pE, pW = sh(p, 1, 0), sh(p, -1, 0)
    pN, pS = sh(p, 0, 1), sh(p, 0, -1)
    pNE, pNW = sh(p, 1, 1), sh(p, -1, 1)
    pSE, pSW = sh(p, 1, -1), sh(p, -1, -1)
    zE, zW = sh(z, 1, 0), sh(z, -1, 0)
    zN, zS = sh(z, 0, 1), sh(z, 0, -1)
    zNE, zNW = sh(z, 1, 1), sh(z, -1, 1)
    zSE, zSW = sh(z, 1, -1), sh(z, -1, -1)

    j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW)
    j2 = (pE * (zNE - zSE) - pW * (zNW - zSW)
          - pN * (zNE - zNW) + pS * (zSE - zSW))
    j3 = (zN * (pNE - pNW) - zS * (pSE - pSW)
          - zE * (pNE - pSE) + zW * (pNW - pSW))
    return (j1 + j2 + j3) / (12.0 * dx * dy)


def _arakawa_padded(p: torch.Tensor, z: torch.Tensor, dx: float,
                    dy: float) -> torch.Tensor:
    """Arakawa Jacobian on y-padded (ly + 2, nx) blocks; x wraps locally
    (``halo.py:390``)."""
    ly = p.shape[-2] - 2

    def sh(f, dx_, dy_):
        out = f[..., 1 + dy_:1 + dy_ + ly, :]
        return torch.roll(out, -dx_, dims=-1) if dx_ else out

    return _arakawa(sh, p, z, dx, dy)


def _arakawa_padded_2d(p: torch.Tensor, z: torch.Tensor, dx: float,
                       dy: float) -> torch.Tensor:
    """Arakawa Jacobian on (ly + 2, lx + 2) blocks padded on both axes
    (``halo.py:495``): slicing only."""
    ly, lx = p.shape[-2] - 2, p.shape[-1] - 2

    def sh(f, dx_, dy_):
        return f[..., 1 + dy_:1 + dy_ + ly, 1 + dx_:1 + dx_ + lx]

    return _arakawa(sh, p, z, dx, dy)


def _baro_stepper(name, mesh, inner, tendency, exchange, method, dt,
                  n_steps):
    return PlainShardedStepper(name, mesh, BarotropicState,
                               BarotropicState.FIELDS, inner, tendency,
                               exchange, method=method, dt=dt,
                               n_steps=n_steps)


def sharded_barotropic_step(grid: GridSpec, params: PhysicsParams, mesh, *,
                            dt: float, method: str = "rk4", n_steps: int = 1
                            ) -> PlainShardedStepper:
    """Sharded barotropic vorticity step over a 1-D row decomposition
    (``halo.py:421``): each tendency evaluation inverts zeta by the
    distributed transpose-FFT Poisson solve (``parallel/fft.py``), pads
    psi and zeta by one row from the y neighbours, and evaluates the
    Arakawa Jacobian, beta and viscosity as the whole-domain core does. A
    mesh with px > 1 takes the 2-D decomposition
    (``sharded_barotropic_step_2d``). Periodic only; ny and nx must divide
    by the number of shards (the transpose re-shards x)."""
    from njw_tpu_torch.parallel.fft import (
        distributed_poisson_solve, transpose_round_trip,
    )

    name = "sharded_barotropic_step"
    if grid.bc != "periodic":
        raise NotImplementedError("barotropic requires periodic BC")
    if mesh.px > 1:
        return sharded_barotropic_step_2d(grid, params, mesh, dt=dt,
                                          method=method, n_steps=n_steps)
    n = mesh.size
    if grid.ny % n or grid.nx % n:
        raise ValueError(
            f"grid {grid.ny}x{grid.nx} must divide the {n}-device mesh "
            "in BOTH axes (the transpose FFT re-shards x)")
    dx, dy = grid.dx, grid.dy
    beta, nu = params.beta, params.viscosity

    def tendency(states):
        zetas = [s.zeta for s in states]
        psis = distributed_poisson_solve(mesh, zetas, dx, dy, "y")
        out = _Shards()
        for zeta, psi, (pp, zp) in zip(
                zetas, psis, _halo_pad_y(mesh, list(zip(psis, zetas)))):
            dz = -_arakawa_padded(pp, zp, dx, dy)
            if beta != 0.0:
                v = (torch.roll(psi, -1, dims=-1)
                     - torch.roll(psi, 1, dims=-1)) * (0.5 / dx)
                dz = dz - beta * v
            if nu != 0.0:
                lap_x = (torch.roll(zeta, -1, dims=-1) - 2 * zeta
                         + torch.roll(zeta, 1, dims=-1)) / (dx * dx)
                lap_y = (zp[..., 2:, :] - 2 * zeta
                         + zp[..., :-2, :]) / (dy * dy)
                dz = dz + nu * (lap_x + lap_y)
            out.append(BarotropicState(zeta=dz))
        return out

    def exchange(states):
        zetas = [s.zeta for s in states]
        _halo_pad_y(mesh, [(z, z) for z in zetas])
        transpose_round_trip(mesh, [z.to(torch.complex64) for z in zetas])

    return _baro_stepper(name, mesh, mesh.block_shape(grid.ny, grid.nx),
                         tendency, exchange, method, dt, n_steps)


def sharded_barotropic_step_2d(grid: GridSpec, params: PhysicsParams, mesh,
                               *, dt: float, method: str = "rk4",
                               n_steps: int = 1) -> PlainShardedStepper:
    """Sharded barotropic vorticity step over a ('y', 'x') mesh
    (``halo.py:523``): the pencil transpose-FFT Poisson solve
    (``parallel/fft.py`` ``distributed_poisson_solve_2d``) and a 1-point
    halo on both axes for the Arakawa Jacobian, beta and viscosity.
    Periodic only; the grid must tile the mesh, ny and nx divide by the
    number of shards and the local rows by px."""
    from njw_tpu_torch.parallel.fft import (
        distributed_poisson_solve_2d, transpose_round_trip,
    )

    if grid.bc != "periodic":
        raise NotImplementedError("barotropic requires periodic BC")
    py, px = mesh.shape
    n = py * px
    if grid.ny % py or grid.nx % px:
        raise ValueError(f"grid {grid.ny}x{grid.nx} must tile the "
                         f"({py},{px}) mesh")
    if (grid.ny // py) % px or grid.ny % n or grid.nx % n:
        raise ValueError(
            f"grid {grid.ny}x{grid.nx} must divide the {n}-device mesh "
            "in BOTH axes (the pencil transpose FFT re-shards x)")
    dx, dy = grid.dx, grid.dy
    beta, nu = params.beta, params.viscosity

    def tendency(states):
        zetas = [s.zeta for s in states]
        psis = distributed_poisson_solve_2d(mesh, zetas, dx, dy)
        out = _Shards()
        for zeta, (pp, zp) in zip(
                zetas, pad_blocks(mesh, list(zip(psis, zetas)), 1)):
            dz = -_arakawa_padded_2d(pp, zp, dx, dy)
            if beta != 0.0:
                v = (pp[..., 1:-1, 2:] - pp[..., 1:-1, :-2]) * (0.5 / dx)
                dz = dz - beta * v
            if nu != 0.0:
                lap_x = (zp[..., 1:-1, 2:] - 2 * zeta
                         + zp[..., 1:-1, :-2]) / (dx * dx)
                lap_y = (zp[..., 2:, 1:-1] - 2 * zeta
                         + zp[..., :-2, 1:-1]) / (dy * dy)
                dz = dz + nu * (lap_x + lap_y)
            out.append(BarotropicState(zeta=dz))
        return out

    def exchange(states):
        zetas = [s.zeta for s in states]
        pad_blocks(mesh, [(z, z) for z in zetas], 1)
        transpose_round_trip(mesh, [z.to(torch.complex64) for z in zetas],
                             pencils=True)

    return _baro_stepper("sharded_barotropic_step_2d", mesh,
                         mesh.block_shape(grid.ny, grid.nx), tendency,
                         exchange, method, dt, n_steps)
