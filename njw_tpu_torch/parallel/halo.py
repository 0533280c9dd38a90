"""Halo exchange and the kernel-backed sharded weather steppers.

Counterpart of ``njw_tpu/parallel/halo.py``: ``halo_pad_2d``,
``make_padded_shift_fn``, ``interior_crop`` and the sharded steppers that
run the fused kernels per shard (``sharded_swe_step_pallas`` :743 and
``_2d`` :820, ``sharded_pe_step_pallas`` :590 and ``_2d`` :1029,
``sharded_pe_step_pallas_fused`` :664 and ``_fused_2d`` :886), named with
``kernel`` for ``pallas``. They run on either mesh of
``njw_tpu_torch.parallel.mesh``.

Each constructor returns a stepper: ``step(shards) -> shards`` advances
the shards this process holds (a list, row-major) by ``n_steps`` and
returns new interior-shaped shards. Inside, each shard's state lives in
padded blocks with exactly the halo its kernel reads (4 rows, and 4
columns on a 2-D mesh, for the whole-step kernels K1 and K4; 1 for the
stage kernel K5). Each step refreshes only those halo bands by exchange
(x bands over the interior rows first, then y bands over the full padded
width, so the corners ride along) and launches the kernel on every shard
in turn. The blocks are made at the first call and reused: a step
allocates nothing (on a ``ProcessMesh`` the exchange's send and receive
buffers excepted). On ``LocalMesh`` the shards' launches follow one
another on one stream.

As in the JAX package: periodic BC and a numeric f only
(``NotImplementedError`` otherwise); a mesh with px > 1 takes the 2-D
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
from typing import Callable, Sequence

import torch

from njw_tpu_torch.ops import pe_stencil
from njw_tpu_torch.ops.stencil import HALO as SWE_HALO
from njw_tpu_torch.ops.stencil import swe_rk4_step_padded
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.primitive import PEState

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
    h = halo
    clamp = bc in ("clamped", "reflective")

    def pad(fs, axis, sign):
        dim = -1 if axis == "x" else -2
        n = mesh.axis_size(axis)
        lo = mesh.ring_shift([(f.narrow(dim, f.shape[dim] - h, h),)
                              for f in fs], axis, +1)
        hi = mesh.ring_shift([(f.narrow(dim, 0, h),) for f in fs], axis, -1)
        out = []
        for f, (a,), (b,), i in zip(fs, lo, hi, mesh.axis_index(axis)):
            if clamp and i == 0:
                a = sign * f.narrow(dim, 0, 1).expand_as(a)
            if clamp and i == n - 1:
                b = sign * f.narrow(dim, f.shape[dim] - 1, 1).expand_as(b)
            out.append(torch.cat([a, f, b], dim=dim))
        return out

    return pad(pad(list(fields), "x", wall_sign_x), "y", wall_sign_y)


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

    @staticmethod
    def _views(blocks, dim: int, h: int, n: int) -> tuple:
        def strips(start):
            return [tuple(t.narrow(dim, start, h) for t in b) for b in blocks]

        # the last h interior strips fill the next shard's low band, the
        # first h the previous shard's high band
        return strips(n), strips(h), strips(0), strips(n + h)

    def refresh(self, mesh) -> None:
        for axis, last, first, band_lo, band_hi in self.axes:
            for sends, bands, shift in ((last, band_lo, +1),
                                        (first, band_hi, -1)):
                got = mesh.ring_shift(sends, axis, shift)
                for dst, src in zip(bands, got):
                    for d, s in zip(dst, src):
                        d.copy_(s)


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


class ShardedStepper:
    """``step(shards) -> shards`` over ``n_steps`` steps (see the module
    docstring). ``name``: the form."""

    name = ""

    def __init__(self, mesh, n_steps: int, inner: tuple, halo: tuple,
                 cls, filler: float):
        self.mesh, self.n_steps = mesh, int(n_steps)
        self.inner, self.halo = inner, halo
        self.cls, self.filler = cls, filler
        self.fields = SWE_FIELDS if cls is WeatherState else PEState.FIELDS
        self._blocks = None

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

    def _check(self, shards: Sequence) -> None:
        mesh = self.mesh
        mesh._check_shards(shards)
        for s in shards:
            if not isinstance(s, self.cls) or tuple(
                    n for n, _ in s.items()) != self.fields:
                raise TypeError(f"{self.name}: shards must be "
                                f"{self.cls.__name__}s of {self.fields}")
            for n, t in s.items():
                if tuple(t.shape[-2:]) != tuple(self.inner) or \
                        t.device != mesh.device or t.dtype != torch.float32:
                    raise ValueError(
                        f"{self.name}: shard field {n} is {tuple(t.shape)} "
                        f"{t.dtype} on {t.device}; expected (..., "
                        f"{self.inner[0]}, {self.inner[1]}) float32 on "
                        f"{mesh.device}")

    def __call__(self, shards: Sequence) -> list:
        self._check(shards)
        if self._blocks is None:
            self._blocks = self._make(shards)
        return self._run(shards)

    def exchange(self) -> None:
        """One halo exchange of the blocks a step starts from (what each
        step does before its launches), for measurement."""
        self._bands_of_input().refresh(self.mesh)


def _fields(st) -> tuple:
    return tuple(t for _, t in st.items())


def _copy(st):
    """A new contiguous state with the values of ``st`` (views)."""
    return st.map(lambda a: a.clone(memory_format=torch.contiguous_format))


class _CarryStepper(ShardedStepper):
    """The persistent padded carry (JAX's ``_carry`` and ``carry2d``
    forms): two padded blocks per shard ping-pong; each step refreshes the
    input's bands and the kernel writes the other block's interior."""

    def _make(self, shards):
        pads = [self._padded(shards) for _ in range(2)]
        bands = [_Bands([_fields(p) for p in ps], self.halo, self.inner)
                 for ps in pads]
        inner = [[self._interior(p) for p in ps] for ps in pads]
        return {"pads": pads, "bands": bands, "inner": inner, "turn": 0}

    def _bands_of_input(self):
        b = self._blocks
        return b["bands"][b["turn"]]

    def _run(self, shards):
        b = self._blocks
        t = b["turn"]
        for dst, s in zip(b["inner"][t], shards):
            for d, x in zip(_fields(dst), _fields(s)):
                d.copy_(x)
        for _ in range(self.n_steps):
            b["bands"][t].refresh(self.mesh)
            for src, out in zip(b["pads"][t], b["inner"][1 - t]):
                self._launch(src, out)
            t = 1 - t
        b["turn"] = t
        return [_copy(st) for st in b["inner"][t]]


class _ConcatStepper(ShardedStepper):
    """JAX's ``_local2d`` (concat) form: the state stays interior-shaped;
    each step copies it into one padded block per shard, refreshes the
    bands, and the kernel writes the next interior-shaped state."""

    def _make(self, shards):
        pads = self._padded(shards)
        return {"pads": pads,
                "bands": _Bands([_fields(p) for p in pads], self.halo,
                                self.inner),
                "inner": [self._interior(p) for p in pads],
                "states": [[s.map(torch.empty_like) for s in shards]
                           for _ in range(2)]}

    def _bands_of_input(self):
        return self._blocks["bands"]

    def _run(self, shards):
        b = self._blocks
        cur = shards
        for i in range(self.n_steps):
            for dst, s in zip(b["inner"], cur):
                for d, x in zip(_fields(dst), _fields(s)):
                    d.copy_(x)
            b["bands"].refresh(self.mesh)
            cur = b["states"][i % 2]
            for src, out in zip(b["pads"], cur):
                self._launch(src, out)
        return [_copy(st) for st in cur]


# --------------------------------------------------------------------- SWE

class _SWEForm:
    def _setup(self, grid, params, dt):
        self.kw = dict(dt=float(dt), dx=float(grid.dx), dy=float(grid.dy),
                       gravity=float(params.gravity),
                       coriolis_f=float(params.coriolis_f),
                       viscosity=float(params.viscosity))

    def _launch(self, src: WeatherState, out: WeatherState) -> None:
        swe_rk4_step_padded(src.u, src.v, src.h, halo=self.halo,
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

    def _launch(self, src: PEState, out: PEState) -> None:
        pe_stencil.pe_rk4_padded(src, halo=self.halo, out=out, **self.kw)


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
    written there)."""

    def _setup(self, grid, params, dt):
        dt = float(dt)
        third = 1.0 / 3.0
        self.kw = dict(dx=float(grid.dx), dy=float(grid.dy),
                       coriolis_f=float(params.coriolis_f))
        self.c = (0.5 * dt, 0.5 * dt, dt, dt / 6.0)
        self.combine = (-third, third, 2.0 * third, third)

    def _make(self, shards):
        pads = [self._padded(shards) for _ in range(4)]
        return {"pads": pads,
                "bands": [_Bands([_fields(p) for p in ps], self.halo,
                                 self.inner) for ps in pads],
                "inner": [[self._interior(p) for p in ps] for ps in pads],
                "order": (0, 1, 2, 3)}

    def _bands_of_input(self):
        b = self._blocks
        return b["bands"][b["order"][0]]

    def _stage(self, k_in: int, bases: tuple, coeffs: tuple, k_out: int,
               c_dt: float) -> None:
        b = self._blocks
        b["bands"][k_in].refresh(self.mesh)
        for j, cur in enumerate(b["pads"][k_in]):
            pe_stencil.pe_stage_padded(
                cur, tuple(b["inner"][g][j] for g in bases), halo=self.halo,
                c_dt=c_dt, base_coeffs=coeffs, out=b["inner"][k_out][j],
                **self.kw)

    def _run(self, shards):
        b = self._blocks
        s0, s1, s2, s3 = b["order"]
        for dst, s in zip(b["inner"][s0], shards):
            for d, x in zip(_fields(dst), _fields(s)):
                d.copy_(x)
        one = (1.0,)
        for _ in range(self.n_steps):
            self._stage(s0, (s0,), one, s1, self.c[0])
            self._stage(s1, (s0,), one, s2, self.c[1])
            self._stage(s2, (s0,), one, s3, self.c[2])
            self._stage(s3, (s0, s1, s2, s3), self.combine, s1, self.c[3])
            s0, s1, s2, s3 = s1, s2, s3, s0
        b["order"] = (s0, s1, s2, s3)
        return [_copy(st) for st in b["inner"][s0]]


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
