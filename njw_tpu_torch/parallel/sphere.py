"""Latitude-sharded spherical-harmonic transforms and spectral cores.

Counterpart of ``njw_tpu/parallel/sphere.py``:

* Grid fields (nlat, nlon) shard along latitude over the mesh's 'y' axis;
  the longitude FFTs are local.
* The Legendre tables (m, n, lat) shard along their latitude axis
  (``shard_sht``: one transform a shard, holding 1/D of every table).
* Spectral coefficients stay replicated (one copy a shard), so synthesis
  is local: each shard computes its own latitude rows.
* Analysis is a local partial quadrature over the shard's latitudes plus
  one sum over the axis: ``mesh.all_reduce_sum``, the counterpart of
  ``lax.psum``, once a tendency (the tendency generators of
  ``njw_tpu_torch.weather.spherical`` yield all their partials at once).

The meshes are ``LocalMesh(D, 1)`` (every shard in this process) and a
``ProcessMesh(D, 1)`` (one shard a rank). The quadrature's sums run in
another order than the whole domain's, so a sharded run agrees with the
whole-domain run to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from njw_tpu_torch.ops.sht import SphericalHarmonicTransform
from njw_tpu_torch.weather.integrators import ListRK4
from njw_tpu_torch.weather.spherical import TENDENCY_PARTS

AXIS = "y"


def _lat_slab(sht: SphericalHarmonicTransform, j0: int, j1: int,
              device) -> SphericalHarmonicTransform:
    """A transform holding latitudes [j0, j1) of every lat-indexed table;
    the spectral operators stay whole."""
    local = copy.copy(sht)
    local.device = device
    local.tables = {k: t[..., j0:j1].to(device).contiguous()
                    for k, t in sht.tables.items()}
    local.mu_grid = sht.mu_grid[j0:j1].to(device).contiguous()
    local.cos_lat_grid = sht.cos_lat_grid[j0:j1].to(device).contiguous()
    for name in ("valid", "lap", "inv_lap", "m", "im", "sgn_m"):
        setattr(local, name, getattr(sht, name).to(device))
    local.slab = (j0, j1)
    return local


def shard_sht(sht: SphericalHarmonicTransform, mesh,
              axis: str = AXIS) -> list:
    """The local latitude slab transform of each shard this process holds
    (the mesh's own order)."""
    if sht.fold_parity:
        raise NotImplementedError(
            "fold_parity tables pair mirror latitudes on one shard; "
            "build the transform with fold_parity=False for lat-sharding")
    if mesh.px != 1 or axis != AXIS:
        raise ValueError("the latitude sharding runs along 'y' of a "
                         f"(D, 1) mesh, not {mesh.shape} along {axis!r}")
    d = mesh.axis_size(axis)
    if sht.nlat % d:
        raise ValueError(f"nlat={sht.nlat} not divisible by mesh axis "
                         f"{axis!r} (size {d})")
    rows = sht.nlat // d
    return [_lat_slab(sht, i * rows, (i + 1) * rows, mesh.device)
            for i in mesh.axis_index(axis)]


class _PsumSHT:
    """The local slab transforms of this process's shards and the sum of
    their quadrature partials over the latitude axis."""

    def __init__(self, shts: Sequence, mesh, axis: str = AXIS):
        self.shts = list(shts)
        self.mesh = mesh
        self.axis = axis

    def psum(self, partials: list) -> list:
        """Each shard's tuple of partial sums -> the tuple of their sums
        over the axis, in one reduction (complex values as stacked real)."""
        shapes = [p.shape for p in partials[0]]
        flat = [torch.cat([p.reshape(-1) for p in parts])
                for parts in partials]
        out = []
        for total in self.mesh.all_reduce_sum(flat, self.axis):
            out.append(tuple(t.reshape(s) for t, s in zip(
                torch.split(total, [int(np.prod(s)) for s in shapes]),
                shapes)))
        return out

    def tendencies(self, states: list, core: str, omega: float,
                   nu4: float) -> list:
        """The tendency of each shard's (replicated) spectral state."""
        gens = [TENDENCY_PARTS[core](s, t, omega, nu4)
                for s, t in zip(states, self.shts)]
        summed = self.psum([next(g) for g in gens])
        out = []
        for g, total in zip(gens, summed):
            try:
                g.send(total)
            except StopIteration as done:
                out.append(done.value)
            else:
                raise RuntimeError("a tendency yields its partials once")
        return out

    def global_mean(self, f):
        # a slab transform carries the full-length quadrature weights;
        # mixing them with a local slab would be wrong
        raise NotImplementedError(
            "global_mean is undefined on local latitude slabs")


def replicate(state, mesh) -> list:
    """The replicated spectral state of each local shard, on the mesh's
    device."""
    return [state.map(lambda a: a.to(mesh.device)) for _ in mesh.coords]


def sharded_spherical_step(sht: SphericalHarmonicTransform, mesh, *,
                           core: str = "swe", omega: float,
                           nu4: float = 0.0, n_steps: int = 1,
                           axis: str = AXIS) -> ListRK4:
    """A latitude-sharded spectral RK4 stepper over ``mesh`` (a (D, 1)
    LocalMesh or ProcessMesh; nlat divisible by D): ``step(replicate(s,
    mesh), dt)``, ``n_steps`` steps of the replicated spectral state of
    each local shard, the analyses summed across the latitude slabs. The
    counterpart of the JAX package's shard_map step."""
    if core not in TENDENCY_PARTS:
        raise ValueError(f"unknown core {core!r}: bve | swe")
    psum = _PsumSHT(shard_sht(sht, mesh, axis), mesh, axis)
    return ListRK4(f"sharded_spectral_{core}_rk4",
                   lambda states: psum.tendencies(states, core, omega, nu4),
                   n_steps)
