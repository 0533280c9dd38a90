"""The primitive-equation kernels: one RK stage, and one whole RK4 step.

Counterpart of ``njw_tpu/ops/pe_stencil.py`` (``pe_stage_pallas``,
``pe_rk4_step_pallas``, ``make_pe_pallas_rk4_stepper``,
``pe_pallas_supported``), for periodic float32 states (u, v, T, q of shape
(L, ny, nx), ps of shape (ny, nx)) with an optional surface geopotential
``phi_s``:

* ``csrc/pe_stage.cu`` replaces the TPU kernel ``_pe_stage_kernel``:
  out = sum_g coef_g * base_g + c_dt * T(cur), with one base or four (the
  RK4 combine fused into the last stage);
* ``csrc/pe_rk4.cu`` replaces the TPU kernel ``_pe_rk4_kernel``: the four
  stages of an RK4 step in one launch, the state read and written once.

Their sources say what bounds them and how the work is laid out. The
whole-step kernel keeps a tile's stage states and RK4 accumulator in
shared memory, the levels split over a cluster of up to eight blocks
(``rk4_layout``: tile 8 up to L = 168, smaller tiles past it); it fits
while a one-column tile over eight blocks does (``pe_rk4_kernel_fits``,
L <= 688). The RK4 stepper takes the four stage launches: the H100 timed
the whole-step kernel slower at every L timed (PERF.md); ``whole_step=True``
takes it.

Each public wrapper (``pe_stage``, ``pe_rk4_step``) dispatches once, in
``_stage_bound`` / ``_rk4_bound``: the kernel's launch, bound (``Launch``),
for CUDA tensors, its plain PyTorch version (the kernel's arithmetic) for
CPU tensors, and nothing else. The steppers bind through the same
dispatch, once per arrangement of their buffers (the rule of
``ops/_bound.py``). Nothing catches a build or launch failure and falls
back.

The sharded launchers of the two TPU kernels run the same kernels on a
halo-padded block (one launch each, with a plain version on the padded
block) and go through the same runners: ``pe_stage_local`` and
``pe_stage_local2d`` (``pe_stage_pallas_local``, ``_local2d``), and
``pe_rk4_local``, ``pe_rk4_carry``, ``pe_rk4_local2d`` and
``pe_rk4_carry2d`` (``pe_rk4_pallas_local``, ``_carry``, ``_local2d`` and
``pe_rk4_pallas_carry2d``, the launcher of the TPU kernel
``_pe_rk4_carry2d_kernel``, which the whole-step kernel serves here).
"""
from __future__ import annotations

import ctypes
import math
import numbers
from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from njw_tpu_torch.ops import _build
from njw_tpu_torch.ops._bound import BoundSteps, Launch, device_kind, \
    require_cuda, step
from njw_tpu_torch.ops.stencil import SMEM_PER_BLOCK, frame
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams
from njw_tpu_torch.weather.integrators import Stepper
from njw_tpu_torch.weather.primitive import KAPPA, R_DRY, PEState

MAX_BASES = 4
STAGE_MAX_LEVELS = 454       # csrc/pe_stage.cu kMaxLevels: the stage reach
STAGE_TILE_COLUMNS = 64      # its tiles' width (TX)
STAGE_TILE_ROWS = (4, 2, 1)  # the tile heights it builds
STAGE_SLOTS = 5              # levels in its ring (SLOTS)
STAGE_REGION_PITCH = STAGE_TILE_COLUMNS + 8   # floats a region row (PX)
SMEM_PER_SM = 233472         # shared bytes an SM of the H100 holds
RK4_THREADS = 512            # csrc/pe_rk4.cu NT
RK4_TILE_MAX = 8             # the largest output tile the wrapper picks
RK4_CLUSTERS = (1, 2, 4, 8)  # blocks per cluster the whole-step kernel takes
RK4_LEVELS_PER_BLOCK = 21    # the most levels a block of it holds at tile 8
RK4_NCOL = 5                 # csrc/pe_rk4.cu NCOL: per-column planes
STAGE_HALO, RK4_HALO = 1, 4  # halo rows (columns) each kernel reads

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_STAGE_ARGTYPES = ([_P] * 6 + [_L, _L, _I, _I] + [_P] * 5 * MAX_BASES
                   + [_I] + [_F] * MAX_BASES + [_P] * 5 + [_L, _L] + [_P]
                   + [_I] * 5 + [_F] * 8 + [_I, _P])
_RK4_ARGTYPES = ([_P] * 6 + [_L, _L, _I, _I] + [_P] * 5 + [_L, _L]
                 + [_P] + [_I] * 7 + [_F] * 11 + [_I, _P])
NO_HALO = (0, 0)             # the whole periodic domain: both axes wrap


def _f32(x: float) -> float:
    return float(np.float32(x))


class ColumnConsts(NamedTuple):
    """The column arithmetic's scalars, folded in double and rounded to
    float32 once (``pe::Consts`` in ``csrc/pe_column.cuh``)."""

    cx: float      # 0.5/dx
    cy: float      # 0.5/dy
    f: float
    dsig: float    # 1/L
    r_dry: float
    kappa: float
    phibot: float  # R ln(1/sig_{L-1})


class Rk4Consts(NamedTuple):
    """The whole step's RK4 scalars, rounded to float32 once."""

    c_half: float  # dt/2
    c_full: float  # dt
    third: float   # 1/3
    sixth: float   # dt/6


@lru_cache(maxsize=64)
def column_constants(grid: GridSpec, coriolis_f: float) -> ColumnConsts:
    L = grid.levels
    sig_bottom = (L - 0.5) / L
    return ColumnConsts(_f32(0.5 / grid.dx), _f32(0.5 / grid.dy),
                        _f32(coriolis_f), _f32(1.0 / L), _f32(R_DRY),
                        _f32(KAPPA), _f32(R_DRY * (-math.log(sig_bottom))))


def rk4_constants(dt: float) -> Rk4Consts:
    return Rk4Consts(_f32(0.5 * dt), _f32(dt), _f32(1.0 / 3.0),
                     _f32(dt / 6.0))


@lru_cache(maxsize=16)
def level_constants(L: int, device: str) -> torch.Tensor:
    """float32 [thick_0..thick_{L-1}, 1/(k+1/2) for k < L] on ``device``:
    thick_k = R/2 ln(sig_k / sig_{k-1}) (thick_0 unused), the factors of
    the hydrostatic step and of omega/p, as the Pallas kernel folds them."""
    sig = [(k + 0.5) / L for k in range(L)]
    thick = [0.0] + [R_DRY * 0.5 * math.log(sig[k] / sig[k - 1])
                     for k in range(1, L)]
    inv_kh = [1.0 / (k + 0.5) for k in range(L)]
    return torch.tensor(thick + inv_kh, dtype=torch.float32, device=device)


def _as_bases(bases) -> tuple:
    return (bases,) if isinstance(bases, PEState) else tuple(bases)


def _check(cur: PEState, bases: tuple, grid: GridSpec, coeffs, phi_s,
           out: Optional[PEState], name: str = "pe_stage") -> None:
    if grid.bc != "periodic":
        raise ValueError(f"{name}: periodic boundary condition required")
    if grid.ny < 3 or grid.nx < 3:
        raise ValueError(f"{name}: grid must be at least 3x3")
    if not 1 <= len(bases) <= MAX_BASES or len(bases) != len(coeffs):
        raise ValueError(f"{name}: {len(bases)} bases for "
                         f"{len(coeffs)} coefficients (1 to {MAX_BASES})")
    shape3, shape2 = (grid.levels, grid.ny, grid.nx), grid.shape
    dev = cur.ps.device
    states = (cur, *bases) if out is None else (cur, *bases, out)
    # the common case in few operations; the message is built on failure
    for st in states:
        for t, want in ((st.u, shape3), (st.v, shape3), (st.T, shape3),
                        (st.q, shape3), (st.ps, shape2)):
            if (t.dtype != torch.float32 or t.shape != want
                    or not t.is_contiguous() or t.device != dev):
                _refuse(name, t, want, dev)
    if phi_s is not None and (phi_s.dtype != torch.float32
                              or phi_s.shape != shape2
                              or not phi_s.is_contiguous()
                              or phi_s.device != dev):
        _refuse(name, phi_s, shape2, dev, "phi_s")
    if out is not None:
        ins = {t.data_ptr() for _, t in cur.items()}
        if any(t.data_ptr() in ins for _, t in out.items()):
            raise ValueError(f"{name}: out must not alias cur")


def _refuse(name: str, t: torch.Tensor, want: tuple, dev,
            what: str = "a field"):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(want)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    raise ValueError(f"{name}: {what} is on {t.device}, cur on {dev}")


# ---------------------------------------------------------------- one stage

def pe_stage(cur: PEState, bases, *, grid: GridSpec, c_dt: float,
             coriolis_f: float = 0.0, base_coeffs: Sequence[float] = (1.0,),
             phi_s: Optional[torch.Tensor] = None,
             out: Optional[PEState] = None) -> PEState:
    """out = sum_g base_coeffs[g] * bases[g] + c_dt * T(cur), one pass.

    ``bases``: a PEState or a sequence of 1 to 4. CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    return _stage_bound(device_kind(cur.ps, "pe_stage"), _stage_args(
        cur, _as_bases(bases), grid, c_dt, coriolis_f, base_coeffs, phi_s,
        out))()


def pe_stage_cuda(cur: PEState, bases, *, grid: GridSpec, c_dt: float,
                  coriolis_f: float = 0.0,
                  base_coeffs: Sequence[float] = (1.0,),
                  phi_s: Optional[torch.Tensor] = None,
                  out: Optional[PEState] = None) -> PEState:
    """Launch the CUDA kernel on the current stream. Refuses tensors that
    are not on a CUDA device. ``pe_stage_cuda.launches`` counts the
    launches."""
    require_cuda("pe_stage_cuda", [("ps", cur.ps)])  # _check: the rest too
    return _launch_stage(*_stage_args(cur, _as_bases(bases), grid, c_dt,
                                      coriolis_f, base_coeffs, phi_s, out))


def pe_stage_plain(cur: PEState, bases, *, grid: GridSpec, c_dt: float,
                   coriolis_f: float = 0.0,
                   base_coeffs: Sequence[float] = (1.0,),
                   phi_s: Optional[torch.Tensor] = None,
                   out: Optional[PEState] = None) -> PEState:
    """The kernel's function in plain PyTorch (periodic rolls), on any
    device, with the kernel's operation order and float32 constants."""
    return _plain_stage(*_stage_args(cur, _as_bases(bases), grid, c_dt,
                                     coriolis_f, base_coeffs, phi_s, out))


def _stage_args(cur, bases, grid, c_dt, coriolis_f, base_coeffs, phi_s,
                out) -> tuple:
    """Check a whole-domain stage call and fold its constants; return the
    arguments of ``_launch_stage`` and ``_plain_stage``."""
    _check(cur, bases, grid, base_coeffs, phi_s, out)
    if out is None:
        out = cur.map(torch.empty_like)
    return (cur, bases, tuple(_f32(c) for c in base_coeffs), out, phi_s,
            grid, column_constants(grid, float(coriolis_f)), _f32(c_dt),
            level_constants(grid.levels, str(cur.ps.device)))


def _stage_bound(kind: str, args: tuple) -> Callable[[], PEState]:
    """The one dispatch point of the stage, every form: for "cuda" the
    launch bound once (``_bind_stage``), for "cpu" the plain version's
    call. ``args``: checked (``_check``) and folded."""
    if kind == "cuda":
        return _bind_stage(*args)
    return partial(_plain_stage, *args)


def _pitches(st: PEState) -> tuple[int, int]:
    """(row pitch, plane pitch) of a state's fields, in elements."""
    return st.u.stride(1), st.u.stride(0)


def _ptrs(st: PEState) -> list:
    return [t.data_ptr() for t in (st.u, st.v, st.T, st.q, st.ps)]


def _bind_stage(cur: PEState, bases: tuple, coeffs: tuple, out: PEState,
                phi_s, grid: GridSpec, k: ColumnConsts, c_dt: float,
                levc: torch.Tensor, halo: tuple = NO_HALO,
                tile_rows: int = 0) -> Launch:
    """The launch, bound once (counted on ``pe_stage_cuda.launches``).
    ``cur``: the input block, whose interior starts at ``halo`` = (hy, hx)
    (0: that axis wraps); the bases and ``out``: interior-shaped views of
    one layout; ``grid``: the interior's. ``tile_rows``: 0 for the rule's
    tile (``stage_tile_rows``), or another height of ``STAGE_TILE_ROWS``
    whose block fits (the card tests and the profiler)."""
    rows = stage_tile_rows(grid.levels) if tile_rows == 0 else tile_rows
    if rows not in STAGE_TILE_ROWS or \
            stage_smem_bytes(rows, grid.levels) > SMEM_PER_BLOCK:
        raise ValueError(f"pe_stage: a tile of {rows} rows at "
                         f"{grid.levels} levels does not fit a block")
    base_ptrs = [p for b in bases for p in _ptrs(b)]
    base_ptrs += [None] * (5 * MAX_BASES - len(base_ptrs))
    hy, hx = halo
    launch, err_string = _build.bind("pe_stage", _STAGE_ARGTYPES)
    entry = partial(
        launch, *_ptrs(cur), phi_s.data_ptr() if phi_s is not None else None,
        *_pitches(cur), hy, hx, *base_ptrs, len(bases), *coeffs,
        *(0.0,) * (MAX_BASES - len(coeffs)), *_ptrs(out), *_pitches(out),
        levc.data_ptr(), grid.levels, grid.ny, grid.nx, int(hy > 0),
        int(hx > 0), *k, c_dt, rows)
    return Launch("pe_stage", entry, cur.ps.device.index, err_string,
                  (pe_stage_cuda, "launches"), out,
                  (cur, bases, out, phi_s, levc))


def _launch_stage(*args, **kw) -> PEState:
    """Launch on the current stream and count it (``_bind_stage``)."""
    return _bind_stage(*args, **kw)()


pe_stage_cuda.launches = 0


def stage_smem_bytes(rows: int, levels: int) -> int:
    """Shared bytes a block of the stage kernel takes with tiles of 64 x
    ``rows`` columns at ``levels`` (``smem_bytes`` in csrc/pe_stage.cu):
    the ring of ``STAGE_SLOTS`` levels of u, v, T and q on the (rows + 2)
    rows of the halo region, ``levels`` floats of cum a column, and the
    region's row offsets into cur and shifts (12 B a row) and column
    offsets (4 B)."""
    ring = 4 * STAGE_SLOTS * 4 * (rows + 2) * STAGE_REGION_PITCH
    return (ring + 4 * levels * STAGE_TILE_COLUMNS * rows + 12 * (rows + 2)
            + 4 * (STAGE_TILE_COLUMNS + 2))


def stage_resident_threads(rows: int, levels: int) -> int:
    """Threads an SM holds with tiles of ``rows`` rows at ``levels`` as
    shared memory allows it (``resident_threads`` in csrc/pe_stage.cu:
    233,472 bytes an SM, 1 KB of them reserved a block); 0 where a block
    does not fit."""
    need = stage_smem_bytes(rows, levels)
    if need > SMEM_PER_BLOCK:
        return 0
    return SMEM_PER_SM // (need + 1024) * STAGE_TILE_COLUMNS * rows


def stage_tile_rows(levels: int) -> int:
    """The rule (``tile_rows`` in csrc/pe_stage.cu, which asserts some of
    its values): of ``STAGE_TILE_ROWS``, the tile height whose blocks let
    an SM hold the most threads, the taller on a tie (4 rows at L = 20 and
    40, 1 at the reach). Raises ValueError for levels the kernel does not
    take (fewer than 1, more than ``STAGE_MAX_LEVELS``)."""
    if not 1 <= levels <= STAGE_MAX_LEVELS:
        raise ValueError(f"pe_stage: {levels} levels: the stage kernel "
                         f"takes 1 to {STAGE_MAX_LEVELS}")
    return max(STAGE_TILE_ROWS,
               key=lambda r: (stage_resident_threads(r, levels), r))


def stage_kernel_fits(levels: int) -> bool:
    """Whether the stage kernel takes ``levels`` (``stage_tile_rows``)."""
    try:
        stage_tile_rows(levels)
    except ValueError:
        return False
    return True


def stage_kernel_attributes(levels: int, tile_rows: int = 0,
                            nbase: int = 1, index: int = 0) -> dict:
    """The built stage kernel the launch takes at ``levels``, ``tile_rows``
    (0: the rule's) and ``nbase`` bases (one instantiation for one base,
    one for 2 to 4) on CUDA device ``index``: registers and local (spill)
    bytes a thread, dynamic and static shared bytes, threads a block,
    resident blocks an SM and the tile (rows, columns)."""
    fn = _build.load("pe_stage").pe_stage_attributes
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    with torch.cuda.device(index):
        err = fn(levels, tile_rows, nbase, vals)
    if err != 0:
        msg = _build.bind("pe_stage", _STAGE_ARGTYPES)[1](err).decode()
        raise RuntimeError(f"pe_stage attributes: {msg} ({err})")
    out = dict(zip(("registers", "local_bytes", "smem_bytes", "threads",
                    "blocks_per_sm", "static_smem_bytes"), vals))
    out["tile"] = [vals[6], STAGE_TILE_COLUMNS]
    return out


def _rolls() -> tuple:
    """Neighbour accessors (east, west, north, south, centre) of a field
    on the whole periodic domain, and the crop between stages (none)."""
    def ident(a):
        return a

    return (lambda a: torch.roll(a, -1, -1), lambda a: torch.roll(a, 1, -1),
            lambda a: torch.roll(a, -1, -2), lambda a: torch.roll(a, 1, -2),
            ident), ident


def _slices() -> tuple:
    """Neighbour accessors on a padded frame whose valid region shrinks by
    one point per side per stage, and the crop to the next region."""
    def mid(a):
        return a[..., 1:-1, 1:-1]

    return (lambda a: a[..., 1:-1, 2:], lambda a: a[..., 1:-1, :-2],
            lambda a: a[..., 2:, 1:-1], lambda a: a[..., :-2, 1:-1], mid), mid


def _tendency_plain(cur: PEState, phi_s, k: ColumnConsts,
                    levc: torch.Tensor, nbrs: Optional[tuple] = None
                    ) -> tuple:
    """(du, dv, dT, dq, dps) of the column arithmetic in plain PyTorch:
    the flux divergence summed top-down level by level, phi integrated
    bottom-up, sigma-dot pre-scaled by L/2. ``nbrs``: the neighbour
    accessors (``_rolls`` by default, ``_slices`` on a padded frame, where
    the result covers the frame less one point per side)."""
    L = cur.u.shape[0]
    thick, inv_kh = levc[:L], levc[L:, None, None]
    e, w, n, s, c = nbrs if nbrs is not None else _rolls()[0]

    def ddx(a):
        return (e(a) - w(a)) * k.cx

    def ddy(a):
        return (n(a) - s(a)) * k.cy

    u, v, T, q, ps = cur.u, cur.v, cur.T, cur.q, cur.ps
    lnps = torch.log(ps)
    lnps_x, lnps_y = ddx(lnps), ddy(lnps)

    # top-down: cumulative flux divergence
    fd = ddx(ps * u) + ddy(ps * v)
    cum = [fd[0]]
    for kk in range(1, L):
        cum.append(cum[-1] + fd[kk])
    dps = -cum[-1] * k.dsig
    inv_ps = 1.0 / c(ps)
    dps_over_ps = dps * inv_ps

    # sigma-dot scaled by L/2 at the interfaces 0..L (zero at both ends)
    zero = torch.zeros_like(inv_ps)
    sd = [zero] + [-0.5 * (float(kk) * dps_over_ps + cum[kk - 1] * inv_ps)
                   for kk in range(1, L)] + [zero]
    sd_up, sd_dn = torch.stack(sd[:-1]), torch.stack(sd[1:])

    # bottom-up: hydrostatic geopotential
    phi = [None] * L
    phi[L - 1] = k.phibot * T[L - 1]
    if phi_s is not None:
        phi[L - 1] = phi[L - 1] + phi_s
    for kk in range(L - 1, 0, -1):
        phi[kk - 1] = phi[kk] + thick[kk] * (T[kk - 1] + T[kk])
    phi = torch.stack(phi)

    def up_dn(X):
        z = torch.zeros_like(X[:1])
        d = X[1:] - X[:-1]
        return torch.cat([z, d]), torch.cat([d, z])  # X_k - X_{k-1}, X_{k+1} - X_k

    def vadv(X):
        x_up, x_dn = up_dn(X)
        return sd_dn * x_dn + sd_up * x_up

    uc, vc, Tc, qc = c(u), c(v), c(T), c(q)
    du = (-uc * ddx(u) - vc * ddy(u) - vadv(uc) + k.f * vc
          - ddx(phi) - k.r_dry * Tc * lnps_x)
    dv = (-uc * ddx(v) - vc * ddy(v) - vadv(vc) - k.f * uc
          - ddy(phi) - k.r_dry * Tc * lnps_y)
    dlnps_adv = dps_over_ps + uc * lnps_x + vc * lnps_y
    omega_over_p = (sd_up + sd_dn) * inv_kh + dlnps_adv
    dT = -uc * ddx(T) - vc * ddy(T) - vadv(Tc) + k.kappa * Tc * omega_over_p
    dq = -uc * ddx(q) - vc * ddy(q) - vadv(qc)
    return du, dv, dT, dq, dps


def _plain_stage(cur: PEState, bases: tuple, coeffs: tuple, out: PEState,
                 phi_s, grid: GridSpec, k: ColumnConsts, c_dt: float,
                 levc: torch.Tensor, halo: tuple = NO_HALO) -> PEState:
    """The stage in plain PyTorch: rolls on the whole domain; on a padded
    block, slices of the block cut to a one-point halo (no roll)."""
    if halo == NO_HALO:
        tend = _tendency_plain(cur, phi_s, k, levc)
    else:
        tend = _tendency_plain(
            cur.map(lambda a: frame(a, halo, STAGE_HALO)), None, k, levc,
            _slices()[0])
    for (name, o), d in zip(out.items(), tend):
        acc = coeffs[0] * getattr(bases[0], name)
        for c, b in zip(coeffs[1:], bases[1:]):
            acc = acc + c * getattr(b, name)
        o.copy_(acc + c_dt * d)
    return out


# ------------------------------------------------------------ one RK4 step

class Rk4Layout(NamedTuple):
    """How the whole-step kernel cuts its work (csrc/pe_rk4.cu): ``ncta``
    blocks per cluster, splitting the levels, and the output ``tile``
    edge."""

    ncta: int
    tile: int


def rk4_smem_bytes(levels: int, tile: int, ncta: int = 1) -> int:
    """Shared memory one block of the whole-step kernel takes at ``levels``,
    output tile ``tile`` and ``ncta`` blocks per cluster, each holding lc =
    ceil(levels / ncta) levels (``pe_rk4_smem_bytes`` in csrc/pe_rk4.cu),
    in 4 B words: s on the (T+8)^2 source region, s1 (then s3) on (T+6)^2
    and the accumulator on T^2, 4 lc + 1 planes each; s2 on (T+4)^2, or
    stage 1's auxiliaries where they are larger (phi on (T+8)^2 and cum on
    (T+6)^2, lc planes each, and five per-column planes on (T+6)^2); the
    (T+8)^2 source offsets; the 2L level constants."""
    lc, T = -(-levels // ncta), tile
    F = 4 * lc + 1
    a, b, w = (T + 6) ** 2, (T + 4) ** 2, (T + 8) ** 2
    aux1 = lc * (w + a) + RK4_NCOL * a
    return 4 * (F * (w + a + T * T) + max(F * b, aux1) + w + 2 * levels)


def rk4_layout(levels: int) -> Optional[Rk4Layout]:
    """The whole-step kernel's layout at ``levels``: the smallest cluster
    (1, 2, 4, 8 blocks) whose blocks hold tile RK4_TILE_MAX with at most
    RK4_LEVELS_PER_BLOCK levels each; past that, 8 blocks and the largest
    tile that fits (None where none does, L > 688)."""
    if levels < 1:
        return None
    for ncta in RK4_CLUSTERS:
        if ncta <= levels and -(-levels // ncta) <= RK4_LEVELS_PER_BLOCK \
                and rk4_smem_bytes(levels, RK4_TILE_MAX, ncta) \
                <= SMEM_PER_BLOCK:
            return Rk4Layout(ncta, RK4_TILE_MAX)
    ncta = min(RK4_CLUSTERS[-1], levels)
    for tile in range(RK4_TILE_MAX, 0, -1):
        if rk4_smem_bytes(levels, tile, ncta) <= SMEM_PER_BLOCK:
            return Rk4Layout(ncta, tile)
    return None


def pe_rk4_kernel_fits(levels: int) -> bool:
    """The whole-step kernel holds a tile of ``levels`` in the shared
    memory of a cluster (L <= 688: a one-column tile over 8 blocks)."""
    return rk4_layout(levels) is not None


def _rk4_layout_arg(levels: int, layout: Optional[Rk4Layout],
                    name: str) -> Rk4Layout:
    """``layout``, or the rule's when None; refuses levels no layout holds
    and a layout whose block does not fit the shared memory a block may
    have (the kernel refuses the other bad layouts)."""
    if layout is None:
        layout = rk4_layout(levels)
        if layout is None:
            raise ValueError(f"{name}: {levels} levels do not fit the "
                             "whole-step kernel (L <= 688)")
        return layout
    layout = Rk4Layout(*layout)
    need = rk4_smem_bytes(levels, layout.tile, layout.ncta)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: {layout} at {levels} levels needs {need} B "
                         f"of shared memory, more than the {SMEM_PER_BLOCK} "
                         "a block may have")
    return layout


def pe_rk4_step(s: PEState, *, grid: GridSpec, dt: float,
                coriolis_f: float = 0.0, phi_s: Optional[torch.Tensor] = None,
                out: Optional[PEState] = None) -> PEState:
    """One RK4 step in one pass (the combine of the TPU ``_rk4_chain``).
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    return _rk4_bound(device_kind(s.ps, "pe_rk4_step"),
                      _rk4_args(s, grid, dt, coriolis_f, phi_s, out))()


def pe_rk4_step_cuda(s: PEState, *, grid: GridSpec, dt: float,
                     coriolis_f: float = 0.0,
                     phi_s: Optional[torch.Tensor] = None,
                     out: Optional[PEState] = None,
                     layout: Optional[Rk4Layout] = None) -> PEState:
    """Launch the whole-step kernel on the current stream. Refuses tensors
    that are not on a CUDA device. ``pe_rk4_step_cuda.launches`` counts the
    launches. ``layout``: the kernel's ``Rk4Layout`` (``rk4_layout`` when
    None; the card tests and the profiler name others)."""
    require_cuda("pe_rk4_step_cuda", [("ps", s.ps)])  # _check: the rest too
    return _launch_rk4(*_rk4_args(s, grid, dt, coriolis_f, phi_s, out,
                                  layout))


def pe_rk4_step_plain(s: PEState, *, grid: GridSpec, dt: float,
                      coriolis_f: float = 0.0,
                      phi_s: Optional[torch.Tensor] = None,
                      out: Optional[PEState] = None) -> PEState:
    """The kernel's function in plain PyTorch, on any device: four plain
    tendencies chained with the kernel's accumulator."""
    return _plain_rk4(*_rk4_args(s, grid, dt, coriolis_f, phi_s, out))


@lru_cache(maxsize=64)
def rk4_occupancy(levels: int, layout: Rk4Layout, index: int) -> tuple:
    """(blocks of the whole-step kernel one SM of CUDA device ``index``
    holds at once, clusters the device runs at once) at ``layout`` (the
    occupancy queries of csrc/pe_rk4.cu)."""
    fn = _build.load("pe_rk4").pe_rk4_occupancy
    fn.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 2
    fn.restype = ctypes.c_int
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(levels, layout.ncta, layout.tile, ctypes.byref(blocks),
                 ctypes.byref(clusters))
    if err != 0:
        msg = _build.bind("pe_rk4", _RK4_ARGTYPES)[1](err).decode()
        raise RuntimeError(f"pe_rk4 occupancy: {msg} ({err})")
    return blocks.value, clusters.value


def rk4_smem_bytes_built(levels: int, tile: int, ncta: int) -> int:
    """``rk4_smem_bytes`` as the built kernel computes it (the card tests
    hold the two equal)."""
    fn = _build.load("pe_rk4").pe_rk4_smem_bytes
    fn.argtypes, fn.restype = [_I, _I, _I], ctypes.c_longlong
    return int(fn(levels, ncta, tile))


def _rk4_args(s, grid, dt, coriolis_f, phi_s, out,
              layout: Optional[Rk4Layout] = None) -> tuple:
    """Check a whole-domain step and fold its constants; return the
    arguments of ``_launch_rk4`` and ``_plain_rk4``."""
    _check(s, (s,), grid, (1.0,), phi_s, out, "pe_rk4_step")
    if out is None:
        out = s.map(torch.empty_like)
    return (s, out, phi_s, grid, column_constants(grid, float(coriolis_f)),
            rk4_constants(float(dt)),
            level_constants(grid.levels, str(s.ps.device)), layout)


def _rk4_bound(kind: str, args: tuple) -> Callable[[], PEState]:
    """The one dispatch point of the whole step, every form: for "cuda"
    the launch bound once (``_bind_rk4``), for "cpu" the plain version's
    call."""
    if kind == "cuda":
        return _bind_rk4(*args)
    return partial(_plain_rk4, *args)


def _bind_rk4(s: PEState, out: PEState, phi_s, grid: GridSpec,
              k: ColumnConsts, r: Rk4Consts, levc: torch.Tensor,
              layout: Optional[Rk4Layout], halo: tuple = NO_HALO,
              stages: int = 4) -> Launch:
    """The launch, one cluster per output tile, bound once (counted on
    ``pe_rk4_step_cuda.launches``). ``s``: the input block, whose interior
    starts at ``halo`` = (hy, hx) (0: that axis wraps); ``out``:
    interior-shaped views; ``grid``: the interior's; ``layout``: an
    ``Rk4Layout`` (the rule's when None; ``_rk4_layout_arg``). ``stages``
    < 4 runs only the first stages and writes nothing
    (``scripts/profile_torch.py`` times the kernel's parts so)."""
    layout = _rk4_layout_arg(grid.levels, layout, "pe_rk4_step")
    hy, hx = halo
    if s.ps.stride(0) * s.ps.shape[0] >= 2 ** 31:
        raise ValueError("pe_rk4: a plane of the block must hold fewer "
                         "than 2**31 elements")
    launch, err_string = _build.bind("pe_rk4", _RK4_ARGTYPES)
    entry = partial(
        launch, *_ptrs(s), phi_s.data_ptr() if phi_s is not None else None,
        *_pitches(s), hy, hx, *_ptrs(out), *_pitches(out), levc.data_ptr(),
        *layout, grid.levels, grid.ny, grid.nx, int(hy > 0), int(hx > 0),
        *k, *r, stages)
    return Launch("pe_rk4", entry, s.ps.device.index, err_string,
                  (pe_rk4_step_cuda, "launches"), out, (s, out, phi_s, levc))


def _launch_rk4(*args, **kw) -> PEState:
    """Launch on the current stream and count it (``_bind_rk4``)."""
    return _bind_rk4(*args, **kw)()


pe_rk4_step_cuda.launches = 0


def _plain_rk4(s: PEState, out: PEState, phi_s, grid: GridSpec,
               k: ColumnConsts, r: Rk4Consts, levc: torch.Tensor,
               _layout=None, halo: tuple = NO_HALO) -> PEState:
    """The whole step in plain PyTorch: rolls on the whole domain; on a
    padded block, slices of the block cut to a four-point halo, the valid
    region shrinking by one point per side per stage (no roll)."""
    if halo == NO_HALO:
        nbrs, mid = _rolls()
    else:
        nbrs, mid = _slices()
        s = s.map(lambda a: frame(a, halo, RK4_HALO))

    def tend(x):
        return _tendency_plain(x, phi_s, k, levc, nbrs)

    def axpy(base, c, d):  # base + c T
        return PEState(*(x + c * t for (_, x), t in zip(base.items(), d)))

    base = s.map(mid)
    s1 = axpy(base, r.c_half, tend(s))
    acc = [a - x for (_, a), (_, x) in zip(s1.items(), base.items())]
    base = base.map(mid)
    s2 = axpy(base, r.c_half, tend(s1))
    acc = [mid(a) + 2.0 * b for a, (_, b) in zip(acc, s2.items())]
    base = base.map(mid)
    s3 = axpy(base, r.c_full, tend(s2))
    acc = [mid(a) + b for a, (_, b) in zip(acc, s3.items())]
    t4 = tend(s3)
    for (_, o), a, d in zip(out.items(), acc, t4):
        o.copy_(mid(a) * r.third + r.sixth * d)
    return out


# ------------------------------------------------------- the padded forms

def _refuse_layout(name: str, what: str, st: PEState, shape3: tuple,
                   dev) -> None:
    """Refuse a state whose u, v, T, q are not (L, rows, cols) float32
    views sharing one layout with contiguous rows, or whose ps is not the
    (rows, cols) view of the same row pitch, or not on ``dev``."""
    ref = st.u.stride()
    for n, t in st.items():
        want = shape3 if n != "ps" else shape3[1:]
        strides = ref if n != "ps" else ref[1:]
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.stride() != strides or t.device != dev):
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: {what}.{n} must be float32")
            if t.device != dev:
                raise ValueError(f"{name}: {what}.{n} is on {t.device}, "
                                 f"the block on {dev}")
            raise ValueError(
                f"{name}: {what}.{n} has shape {tuple(t.shape)} and strides "
                f"{t.stride()}; expected shape {want} with contiguous rows "
                "and the layout of u")
    if ref[-1] != 1:
        raise ValueError(f"{name}: {what} must have contiguous rows")


def _padded_grid(name: str, block: PEState, halo: tuple, need: int,
                 dx: float, dy: float, bases: tuple = (),
                 out: Optional[PEState] = None) -> GridSpec:
    """Check a padded call and return the interior's grid. ``block``: the
    (L, ly + 2 hy, lx + 2 hx) input; ``need``: the halo the kernel reads
    (hx = 0: x whole and periodic); ``bases``, ``out``: (L, ly, lx) views
    of one layout."""
    hy, hx = halo
    if block.u.dim() != 3:
        raise ValueError(f"{name}: u, v, T, q must be (L, rows, cols)")
    L, rows, cols = block.u.shape
    ly, lx = rows - 2 * hy, cols - 2 * hx
    if hy < need or (hx and hx < need):
        raise ValueError(f"{name}: halo {halo}: the kernel reads {need} "
                         "rows (and columns unless hx = 0)")
    if ly < 1 or lx < (1 if hx else 3) or L < 1:
        raise ValueError(f"{name}: interior {L}x{ly}x{lx} too small")
    dev = block.ps.device
    _refuse_layout(name, "the block", block, (L, rows, cols), dev)
    views = [(f"base {g}", b) for g, b in enumerate(bases)]
    if out is not None:
        views.append(("out", out))
    for what, b in views:
        _refuse_layout(name, what, b, (L, ly, lx), dev)
        if b.u.stride() != views[0][1].u.stride():
            raise ValueError(f"{name}: the bases and out must share one "
                             "layout")
    if out is not None:
        ins = {t.untyped_storage().data_ptr() for _, t in block.items()}
        if any(t.untyped_storage().data_ptr() in ins for _, t in out.items()):
            raise ValueError(f"{name}: out must not alias the block")
    return GridSpec(nx=lx, ny=ly, levels=L, dx=dx, dy=dy)


def _interior_empty(grid: GridSpec, device,
                    like: Optional[PEState] = None) -> PEState:
    """A new interior-shaped state; with ``like``, of its layout (strides)
    too."""
    L, ny, nx = grid.levels, grid.ny, grid.nx

    def e(name, *shape):
        if like is None:
            return torch.empty(shape, dtype=torch.float32, device=device)
        return torch.empty_strided(shape, getattr(like, name).stride(),
                                   dtype=torch.float32, device=device)

    return PEState(u=e("u", L, ny, nx), v=e("v", L, ny, nx),
                   T=e("T", L, ny, nx), q=e("q", L, ny, nx),
                   ps=e("ps", ny, nx))


def interior(st: PEState, halo: tuple) -> PEState:
    """The interior views of a padded state (interior at ``halo``)."""
    hy, hx = halo

    def crop(a):
        return a[..., hy:a.shape[-2] - hy, hx:a.shape[-1] - hx]

    return st.map(crop)


def pe_stage_padded(cur_p: PEState, bases, *, halo: tuple, c_dt: float,
                    dx: float = 1.0, dy: float = 1.0,
                    coriolis_f: float = 0.0,
                    base_coeffs: Sequence[float] = (1.0,),
                    out: Optional[PEState] = None) -> PEState:
    """out = sum_g base_coeffs[g] * bases[g] + c_dt * T(cur) on the
    (L, ly, lx) interior of a halo-padded state.

    ``halo`` = (hy, hx): the interior of each (L, ly + 2 hy, lx + 2 hx)
    field of ``cur_p`` starts at row hy, column hx, with neighbour data in
    the hy >= 1 rows (hx >= 1 columns) around it; hx = 0: x is whole and
    periodic. ``bases`` (a PEState or 1 to 4) and ``out`` are
    interior-shaped views of one layout with contiguous rows (arrays, or
    the interiors of padded states of one shape; a new ``out`` takes the
    bases' layout); ``out`` may alias a base. CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    return bind_stage_padded(cur_p, bases, halo=halo, c_dt=c_dt, dx=dx,
                             dy=dy, coriolis_f=coriolis_f,
                             base_coeffs=base_coeffs, out=out)()


def bind_stage_padded(cur_p: PEState, bases, **kw) -> Callable[[], PEState]:
    """``pe_stage_padded(cur_p, bases, **kw)`` checked and bound once
    (``_stage_bound``), for a stepper that repeats it on its own
    buffers."""
    return _stage_bound(device_kind(cur_p.ps, "pe_stage_padded"),
                        _stage_padded_args(cur_p, bases, **kw))


def pe_stage_padded_plain(cur_p: PEState, bases, **kw) -> PEState:
    """``pe_stage_padded``'s plain version, on any device."""
    return _plain_stage(*_stage_padded_args(cur_p, bases, **kw))


def _stage_padded_args(cur_p: PEState, bases, *, halo: tuple, c_dt: float,
                       dx: float = 1.0, dy: float = 1.0,
                       coriolis_f: float = 0.0,
                       base_coeffs: Sequence[float] = (1.0,),
                       out: Optional[PEState] = None) -> tuple:
    """Check a padded stage call; return the arguments of
    ``_launch_stage`` and ``_plain_stage``."""
    bases = _as_bases(bases)
    if not 1 <= len(bases) <= MAX_BASES or len(bases) != len(base_coeffs):
        raise ValueError(f"pe_stage_padded: {len(bases)} bases for "
                         f"{len(base_coeffs)} coefficients (1 to {MAX_BASES})")
    grid = _padded_grid("pe_stage_padded", cur_p, tuple(halo), STAGE_HALO,
                        dx, dy, bases, out)
    if not stage_kernel_fits(grid.levels):
        raise ValueError(f"pe_stage_padded: {grid.levels} levels do not fit "
                         "a block")
    dev = cur_p.ps.device
    if out is None:
        out = _interior_empty(grid, dev, like=bases[0])
    return (cur_p, bases, tuple(_f32(c) for c in base_coeffs), out, None,
            grid, column_constants(grid, float(coriolis_f)), _f32(c_dt),
            level_constants(grid.levels, str(dev)), tuple(halo))


def pe_stage_local(cur_p: PEState, bases, *, hy: int = STAGE_HALO,
                   **kw) -> PEState:
    """Counterpart of ``pe_stage_pallas_local``: the stage on the (L, ly,
    nx) interior of a state padded by hy rows, x whole and periodic."""
    return pe_stage_padded(cur_p, bases, halo=(hy, 0), **kw)


def pe_stage_local2d(cur_p: PEState, bases, *, hy: int = STAGE_HALO,
                     hx: int = STAGE_HALO, **kw) -> PEState:
    """Counterpart of ``pe_stage_pallas_local2d``: the stage on the (L, ly,
    lx) interior of a state padded by hy rows and hx columns."""
    return pe_stage_padded(cur_p, bases, halo=(hy, hx), **kw)


def pe_rk4_padded(s_p: PEState, *, halo: tuple, dt: float, dx: float = 1.0,
                  dy: float = 1.0, coriolis_f: float = 0.0,
                  out: Optional[PEState] = None) -> PEState:
    """One whole RK4 step of the (L, ly, lx) interior of a halo-padded
    state (the fields of ``s_p`` padded by hy >= 4 rows and hx >= 4
    columns, or hx = 0: x whole and periodic), into ``out`` (new when None:
    interior-shaped views with contiguous rows), at the layout
    ``rk4_layout`` gives. CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    return bind_rk4_padded(s_p, halo=halo, dt=dt, dx=dx, dy=dy,
                           coriolis_f=coriolis_f, out=out)()


def bind_rk4_padded(s_p: PEState, **kw) -> Callable[[], PEState]:
    """``pe_rk4_padded(s_p, **kw)`` checked and bound once
    (``_rk4_bound``), for a stepper that repeats it on its own buffers."""
    return _rk4_bound(device_kind(s_p.ps, "pe_rk4_padded"),
                      _rk4_padded_args(s_p, **kw))


def pe_rk4_padded_plain(s_p: PEState, **kw) -> PEState:
    """``pe_rk4_padded``'s plain version, on any device."""
    return _plain_rk4(*_rk4_padded_args(s_p, **kw))


def _rk4_padded_args(s_p: PEState, *, halo: tuple, dt: float,
                     dx: float = 1.0, dy: float = 1.0,
                     coriolis_f: float = 0.0,
                     out: Optional[PEState] = None) -> tuple:
    """Check a padded whole-step call (levels the kernel does not hold are
    refused on every device); return (s_p, out, phi_s, grid, column
    constants, RK4 constants, level constants, layout, halo), the
    arguments of ``_launch_rk4`` and ``_plain_rk4``."""
    grid = _padded_grid("pe_rk4_padded", s_p, tuple(halo), RK4_HALO, dx,
                        dy, (), out)
    layout = _rk4_layout_arg(grid.levels, None, "pe_rk4_padded")
    dev = s_p.ps.device
    if out is None:
        out = _interior_empty(grid, dev)
    return (s_p, out, None, grid, column_constants(grid, float(coriolis_f)),
            rk4_constants(float(dt)), level_constants(grid.levels, str(dev)),
            layout, tuple(halo))


def _padded_out(s_p: PEState, out: Optional[PEState]) -> PEState:
    return s_p.map(torch.empty_like) if out is None else out


def pe_rk4_local(s_p: PEState, *, hy: int = RK4_HALO, **kw) -> PEState:
    """Counterpart of ``pe_rk4_pallas_local``: the step of the (L, ly, nx)
    interior of a state padded by hy rows, x whole and periodic."""
    return pe_rk4_padded(s_p, halo=(hy, 0), **kw)


def pe_rk4_carry(s_p: PEState, *, hy: int = RK4_HALO,
                 out: Optional[PEState] = None, **kw) -> PEState:
    """Counterpart of ``pe_rk4_pallas_carry``: the step of the interior of
    a state padded by hy rows (x whole and periodic), written into the
    interior of the padded state ``out`` (new when None), which is
    returned. Its halo rows are not written: the next step's exchange
    refreshes them."""
    out = _padded_out(s_p, out)
    pe_rk4_padded(s_p, halo=(hy, 0), out=interior(out, (hy, 0)), **kw)
    return out


def pe_rk4_local2d(s_p: PEState, *, hy: int = RK4_HALO, hx: int = RK4_HALO,
                   **kw) -> PEState:
    """Counterpart of ``pe_rk4_pallas_local2d``: the step of the (L, ly,
    lx) interior of a state padded by hy rows and hx columns."""
    return pe_rk4_padded(s_p, halo=(hy, hx), **kw)


def pe_rk4_carry2d(s_p: PEState, *, hy: int = RK4_HALO, hx: int = RK4_HALO,
                   out: Optional[PEState] = None, **kw) -> PEState:
    """Counterpart of ``pe_rk4_pallas_carry2d`` (the TPU kernel
    ``_pe_rk4_carry2d_kernel``, served here by the whole-step kernel): the
    step of the interior of a state padded by hy rows and hx columns,
    written into the interior of the padded state ``out`` (new when None),
    which is returned; its halo rows and columns are not written."""
    out = _padded_out(s_p, out)
    pe_rk4_padded(s_p, halo=(hy, hx), out=interior(out, (hy, hx)), **kw)
    return out


# ----------------------------------------------------------------- steppers

def pe_kernel_supported(grid: GridSpec, params: PhysicsParams) -> bool:
    """Eligibility for the kernels: the TPU rule without its tile and VMEM
    terms (the kernels mask ragged edges). The stage kernel takes L up to
    454 (``stage_tile_rows``); the whole-step kernel is taken only on
    request."""
    return (
        grid.bc == "periodic"
        and grid.grid_type == "cartesian"
        and 2 <= grid.levels
        and stage_kernel_fits(grid.levels)
        and isinstance(params.coriolis_f, numbers.Number)
        and isinstance(params.beta, numbers.Number)
        and float(params.beta) == 0.0
        and isinstance(params.viscosity, numbers.Number)
        and float(params.viscosity) == 0.0
    )


def make_pe_kernel_rk4_stepper(grid: GridSpec, params: PhysicsParams,
                               dt: float,
                               phi_s: Optional[torch.Tensor] = None,
                               whole_step: bool = False) -> Stepper:
    """RK4 on the kernels, under the rule of ``ops/_bound.py``. Four stage
    launches a step, the faster path on the H100 at every L timed (8-87;
    the TPU stepper takes its whole-step kernel where it fits VMEM);
    ``whole_step=True``: the whole-step kernel (``pe_rk4_kernel_fits``).

    Both are in place by design and allocate nothing per step: a state
    returned by one step is overwritten by the step after next; callers
    that keep a state copy it (``Simulation._store_output`` does)."""
    if whole_step:
        return _whole_step_stepper(grid, params, dt, phi_s)
    return _stage_stepper(grid, params, dt, phi_s)


def _whole_step_stepper(grid, params, dt, phi_s) -> Stepper:
    """One whole-step launch per step into a spare state; the incoming
    state becomes the next spare. The carry holds the spare; the stepper
    binds two launches, one each way."""
    k = column_constants(grid, float(params.coriolis_f))
    r = rk4_constants(float(dt))

    def bind(s, out):
        _check(s, (s,), grid, (1.0,), phi_s, out, "pe_rk4_step")
        return _rk4_bound(device_kind(s.ps, "pe_rk4_step"), (
            s, out, phi_s, grid, k, r,
            level_constants(grid.levels, str(s.ps.device)), None))

    def adopt(given):
        (spare,), s = given
        return (step((bind(s, spare),), ((s,), spare)),
                step((bind(spare, s),), given))

    steps = BoundSteps()
    return Stepper(lambda s: (s.map(torch.empty_like),),
                   lambda carry, s, _dt: steps((carry, s), adopt),
                   "pe_rk4_kernel_fused", 4)


def _stage_stepper(grid, params, dt, phi_s) -> Stepper:
    """Four stage launches per step, the combine fused into the last (the
    values equal the separate accumulator pass up to rounding):

        s1 = s + dt/2 T(s);  s2 = s + dt/2 T(s1);  s3 = s + dt T(s2)
        s' = (-s + s1 + 2 s2 + s3)/3 + dt/6 T(s3)

    The carry holds three spare states for s1, s2 and s3; the last stage
    writes s' over s1 (a base, which the kernel reads at each point before
    it writes there), and the incoming state becomes a spare. The buffers'
    arrangement comes back every two steps, so the stepper binds 2 x 4
    launches."""
    k = column_constants(grid, float(params.coriolis_f))
    dt = float(dt)
    third = 1.0 / 3.0
    one = (1.0,)
    combine = tuple(_f32(c) for c in (-third, third, 2.0 * third, third))
    half, full, sixth = _f32(0.5 * dt), _f32(dt), _f32(dt / 6.0)

    def bind(cur, bases, coeffs, out, c_dt):
        _check(cur, bases, grid, coeffs, phi_s, out)
        return _stage_bound(device_kind(cur.ps, "pe_stage"), (
            cur, bases, coeffs, out, phi_s, grid, k, c_dt,
            level_constants(grid.levels, str(cur.ps.device))))

    def launches(s, a, b, c):
        return (bind(s, (s,), one, a, half), bind(a, (s,), one, b, half),
                bind(b, (s,), one, c, full),
                bind(c, (s, a, b, c), combine, a, sixth))

    def adopt(given):
        (a, b, c), s = given
        return (step(launches(s, a, b, c), ((s, b, c), a)),
                step(launches(a, s, b, c), given))

    steps = BoundSteps()
    return Stepper(lambda s: tuple(s.map(torch.empty_like) for _ in range(3)),
                   lambda carry, s, _dt: steps((carry, s), adopt),
                   "pe_rk4_kernel", 4)
