"""Distributed 2-D FFT and Poisson solve via all-to-all transposes.

Counterpart of ``njw_tpu/parallel/fft.py``. For a row-sharded domain each
shard FFTs its rows along x, one all-to-all transposes the array across
the shards, the second FFT runs along the now-local y, the spectral
multiply happens in the transposed layout, and one more all-to-all
brings the result home:

  rows (y-sharded) --fft_x--> all_to_all --> cols (x-sharded) --fft_y-->
  multiply(symbol) --ifft_y--> all_to_all --> --ifft_x--> rows

On a ('y', 'x') mesh one all-to-all along the x ring first trades each
(ny/py, nx/px) block for a pencil of full-x rows, numbered by the
combined index iy * px + ix; the 1-D scheme runs over the combined
('y', 'x') axis, and one more all-to-all restores the blocks.

Every function takes the mesh (``parallel/mesh.py``) and the list of
local blocks it holds, and returns the list of results; the transforms
are complex64 ``torch.fft`` (cuFFT on the card). The ``make_*`` helpers
take a whole array and return the whole result, as the JAX ones do.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Sequence

import torch

from njw_tpu_torch.ops.spectral import fd_wavenumbers
from njw_tpu_torch.parallel.mesh import Axis
from njw_tpu_torch.weather.barotropic import BarotropicState

Blocks = Sequence[torch.Tensor]


def _local_transpose_fwd(mesh, blocks: Blocks, axis: Axis = "y") -> list:
    """(ny_loc, nx) y-sharded blocks -> (nx_loc, ny) x-sharded blocks: the
    all-to-all splits x into n chunks and gathers the y blocks, then a
    local transpose orders each as (nx_loc, ny)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return [b.T for b in blocks]
    parts = []
    for b in blocks:
        ny_loc, nx = b.shape
        if nx % n:
            raise ValueError(f"nx={nx} must divide by the {n} shards of the "
                             "transpose")
        parts.append(b.reshape(ny_loc, n, nx // n))
    # each (ny_loc, n, nx/n), dim 1 now the source's y block
    swapped = mesh.all_to_all(parts, axis, 1, 1)
    return [s.permute(2, 1, 0).reshape(s.shape[2], n * s.shape[0])
            for s in swapped]


def _local_transpose_bwd(mesh, blocks: Blocks, axis: Axis = "y") -> list:
    """Inverse of ``_local_transpose_fwd``: (nx_loc, ny) -> (ny_loc, nx)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return [b.T for b in blocks]
    parts = []
    for b in blocks:
        nx_loc, ny = b.shape
        parts.append(b.reshape(nx_loc, n, ny // n).permute(2, 1, 0))
    swapped = mesh.all_to_all(parts, axis, 1, 1)  # (ny/n, n, nx_loc)
    return [s.reshape(s.shape[0], n * s.shape[2]) for s in swapped]


def _spectral_apply(mesh, blocks: Blocks, multipliers: Sequence,
                    axis: Axis) -> list:
    """The transform, the per-shard multiplier over the (nx_loc, ny)
    transposed spectrum, and back; the real part, contiguous."""
    fx = [torch.fft.fft(b, dim=-1) for b in blocks]
    ft = _local_transpose_fwd(mesh, fx, axis)
    ft = [torch.fft.ifft(torch.fft.fft(t, dim=-1) * m, dim=-1)
          for t, m in zip(ft, multipliers)]
    fx = _local_transpose_bwd(mesh, ft, axis)
    return [torch.fft.ifft(t, dim=-1).real.contiguous() for t in fx]


def _sizes(mesh, blocks: Blocks, axis: Axis) -> tuple[int, int, int]:
    """(ny, nx, n) of the whole field the row blocks cut over ``axis``."""
    ny_loc, nx = blocks[0].shape
    n = mesh.axis_size(axis)
    return ny_loc * n, nx, n


def spectral_apply_distributed(mesh, blocks: Blocks, symbol_fn: Callable,
                               axis: Axis = "y") -> list:
    """Apply a diagonal spectral operator to row-sharded real fields.
    ``symbol_fn(kx_local, ky)`` gives the multiplier over a shard's
    (nx_loc, ny) transposed spectrum: kx_local (nx_loc, 1) the shard's x
    wavenumbers, ky (1, ny) all of y (exact, unit spacing)."""
    ny, nx, n = _sizes(mesh, blocks, axis)
    nx_loc = nx // n
    dev = blocks[0].device
    kx = fd_wavenumbers(nx, 1.0, "spectral", dev)
    ky = fd_wavenumbers(ny, 1.0, "spectral", dev)
    mults = [symbol_fn(kx[i * nx_loc:(i + 1) * nx_loc, None], ky[None, :])
             for i in mesh.axis_index(axis)]
    return _spectral_apply(mesh, blocks, mults, axis)


@lru_cache(maxsize=16)
def _poisson_symbols(ny: int, nx: int, n: int, idx: tuple, dx: float,
                     dy: float, kind: str, device: str) -> tuple:
    """1 / -(kx^2 + ky^2) over each shard's (nx_loc, ny) spectrum (shard
    indices ``idx``), 0 where the denominator is 0: the k = 0 mode, on
    the shard that owns it (zero-mean gauge). Cached per shape, shards and
    device, so that a solve builds nothing."""
    kx2_all = fd_wavenumbers(nx, dx, kind, device)
    ky2 = fd_wavenumbers(ny, dy, kind, device)
    if kind != "laplacian5":
        kx2_all, ky2 = kx2_all * kx2_all, ky2 * ky2
    nx_loc = nx // n
    out = []
    for i in idx:
        kx2 = kx2_all[i * nx_loc:(i + 1) * nx_loc]
        denom = -(kx2[:, None] + ky2[None, :])
        inv = 1.0 / torch.where(denom == 0.0, 1.0, denom)
        out.append(torch.where(denom == 0.0, 0.0, inv))
    return tuple(out)


def distributed_poisson_solve(mesh, blocks: Blocks, dx: float, dy: float,
                              axis: Axis = "y", kind: str = "laplacian5"
                              ) -> list:
    """Row-sharded Poisson solve matching ``ops.spectral.poisson_solve``
    (zero-mean gauge): ``blocks`` are the (ny/n, nx) rows of the shards
    along ``axis``."""
    ny, nx, n = _sizes(mesh, blocks, axis)
    mults = _poisson_symbols(ny, nx, n, tuple(mesh.axis_index(axis)),
                             float(dx), float(dy), kind,
                             str(blocks[0].device))
    return _spectral_apply(mesh, blocks, mults, axis)


def make_distributed_poisson(mesh, ny: int, nx: int, dx: float, dy: float,
                             kind: str = "laplacian5") -> Callable:
    """Whole-array Poisson solve, rows sharded over the mesh's 'y' axis
    (a (py, 1) mesh): ``solve(f)`` takes and returns an (ny, nx)
    tensor."""
    if mesh.px != 1:
        raise ValueError("make_distributed_poisson shards rows over a "
                         f"(py, 1) mesh, not {mesh.shape}: use "
                         "make_distributed_poisson_2d")
    return _whole(mesh, lambda b: distributed_poisson_solve(
        mesh, b, dx, dy, "y", kind))


def _whole(mesh, solve: Callable) -> Callable:
    def run(f: torch.Tensor) -> torch.Tensor:
        shards = mesh.shard_state(BarotropicState(zeta=f))
        out = solve([s.zeta for s in shards])
        return mesh.gather_state([BarotropicState(zeta=o) for o in out]).zeta

    return run


# ------------------------------------------------- the ('y', 'x') mesh

def _pencilize(mesh, blocks: Blocks, x_axis: str = "x") -> list:
    """(ny_loc, nx_loc) 2-D-sharded blocks -> (ny_loc/px, nx) x-local
    pencils, whose rows are ordered by the combined row-block index
    iy * px + ix."""
    px = mesh.axis_size(x_axis)
    if px == 1:
        return list(blocks)
    parts = []
    for b in blocks:
        ny_loc, nx_loc = b.shape
        if ny_loc % px:
            raise ValueError(
                f"x-ring size {px} must divide the local rows {ny_loc}")
        parts.append(b.reshape(px, ny_loc // px, nx_loc))
    # row part j goes to x-neighbour j; the parts received stack at dim 1
    # as column chunks in source order: the full x extent
    sw = mesh.all_to_all(parts, x_axis, 0, 1)  # (ny_pen, px, nx_loc)
    return [s.reshape(s.shape[0], px * s.shape[2]) for s in sw]


def _unpencilize(mesh, pencils: Blocks, x_axis: str = "x") -> list:
    """Inverse of ``_pencilize``: (ny_pen, nx) -> (ny_loc, nx_loc)."""
    px = mesh.axis_size(x_axis)
    if px == 1:
        return list(pencils)
    parts = [p.reshape(p.shape[0], px, p.shape[1] // px) for p in pencils]
    sw = mesh.all_to_all(parts, x_axis, 1, 0)  # (px, ny_pen, nx_loc)
    return [s.reshape(px * s.shape[1], s.shape[2]) for s in sw]


def spectral_apply_distributed_2d(mesh, blocks: Blocks, symbol_fn: Callable,
                                  y_axis: str = "y", x_axis: str = "x"
                                  ) -> list:
    """``spectral_apply_distributed`` of fields sharded on both axes of a
    ('y', 'x') mesh: pencils along the x ring, the 1-D core over the
    combined axis, the blocks restored."""
    pencils = _pencilize(mesh, blocks, x_axis)
    out = spectral_apply_distributed(mesh, pencils, symbol_fn,
                                     (y_axis, x_axis))
    return _unpencilize(mesh, out, x_axis)


def distributed_poisson_solve_2d(mesh, blocks: Blocks, dx: float, dy: float,
                                 y_axis: str = "y", x_axis: str = "x",
                                 kind: str = "laplacian5") -> list:
    """2-D-block-sharded Poisson solve matching
    ``ops.spectral.poisson_solve`` (zero-mean gauge)."""
    pencils = _pencilize(mesh, blocks, x_axis)
    out = distributed_poisson_solve(mesh, pencils, dx, dy, (y_axis, x_axis),
                                    kind)
    return _unpencilize(mesh, out, x_axis)


def make_distributed_poisson_2d(mesh, ny: int, nx: int, dx: float,
                                dy: float, kind: str = "laplacian5"
                                ) -> Callable:
    """Whole-array Poisson solve sharded over a ('y', 'x') mesh:
    ``solve(f)`` takes and returns an (ny, nx) tensor."""
    py, px = mesh.shape
    n = py * px
    if ny % n or (ny // py) % px:
        raise ValueError(f"ny={ny} must divide py*px={n} with local rows "
                         f"divisible by px={px}")
    if nx % n:
        raise ValueError(f"nx={nx} must divide the total device count {n} "
                         "(the transpose FFT re-shards x)")
    return _whole(mesh, lambda b: distributed_poisson_solve_2d(
        mesh, b, dx, dy, "y", "x", kind))


def transpose_round_trip(mesh, blocks: Blocks, pencils: bool = False
                         ) -> list:
    """The all-to-alls of one Poisson solve on complex ``blocks`` with no
    transform between them (the row transpose there and back; with
    ``pencils``, the pencil exchanges around it too), for measurement."""
    axis: Axis = "y"
    if pencils:
        blocks, axis = _pencilize(mesh, blocks), ("y", "x")
    out = _local_transpose_bwd(mesh, _local_transpose_fwd(mesh, blocks,
                                                          axis), axis)
    return _unpencilize(mesh, out) if pencils else out
