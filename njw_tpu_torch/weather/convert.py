"""Carry states, grids and physical constants across from the JAX package.

Both packages exchange plain values only: a state travels as the dict of
NumPy arrays that ``WeatherState.to_numpy()`` returns in either package
(the barotropic and PE states are read field by field from a dict or from
any object with the fields, such as a JAX ``BarotropicState`` or
``PEState``), and a grid or parameter set is read field by field from any
object that has the fields (a JAX ``GridSpec`` / ``PhysicsParams``, a
namespace, ...), so this module imports nothing of JAX.

A sharded state crosses the same way: the JAX package's sharded result
read as the global arrays (``np.asarray`` of each field) becomes the
shards a port mesh holds (``shards_from_numpy``), and the port's shards,
or the snapshots of a ``Simulation`` on a mesh, become the global arrays
again (``shards_to_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from njw_tpu_torch.weather.barotropic import BarotropicState
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.primitive import PEState


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device`` (a field such as phi_s)."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def state_from_numpy(d: Mapping[str, np.ndarray], device) -> WeatherState:
    """A float32 ``WeatherState`` on ``device`` from a dict of arrays."""
    return WeatherState(**{
        name: tensor_from_numpy(val, device) for name, val in d.items()
    })


def state_to_numpy(s: WeatherState) -> dict[str, np.ndarray]:
    """The dict of NumPy arrays the JAX ``WeatherState.to_numpy`` gives."""
    return s.to_numpy()


def _fields_from(cls, src, device):
    get = src.__getitem__ if isinstance(src, Mapping) else \
        (lambda name: getattr(src, name))
    return cls(**{name: tensor_from_numpy(np.asarray(get(name)), device)
                  for name in cls.FIELDS})


def baro_state_from_numpy(src, device) -> BarotropicState:
    """A ``BarotropicState`` on ``device`` from {"zeta": array} or from
    any object with a ``zeta`` field."""
    return _fields_from(BarotropicState, src, device)


def baro_state_to_numpy(s: BarotropicState) -> dict[str, np.ndarray]:
    return s.to_numpy()


def pe_state_from_numpy(src, device) -> PEState:
    """A ``PEState`` on ``device`` from a dict of u, v, T, q, ps arrays or
    from any object with those fields."""
    return _fields_from(PEState, src, device)


def pe_state_to_numpy(s: PEState) -> dict[str, np.ndarray]:
    return s.to_numpy()


def shards_from_numpy(src, mesh) -> list:
    """The shards ``mesh`` holds (``njw_tpu_torch.parallel``) of a whole
    state given as a dict of arrays or any object with the fields (a JAX
    state, sharded or not): a ``PEState`` when it has ps, a
    ``BarotropicState`` when it has zeta, else the ``WeatherState`` of u,
    v, h. The fields are read with ``np.asarray``."""
    get = src.__getitem__ if isinstance(src, Mapping) else \
        (lambda name: getattr(src, name))

    def has(name):
        return ((name in src) if isinstance(src, Mapping)
                else getattr(src, name, None) is not None)

    if has("ps"):
        state = _fields_from(PEState, src, "cpu")
    elif has("zeta"):
        state = _fields_from(BarotropicState, src, "cpu")
    else:
        state = WeatherState(**{name: tensor_from_numpy(np.asarray(get(name)),
                                                        "cpu")
                                for name in ("u", "v", "h")})
    return mesh.shard_state(state)


def shards_to_numpy(shards, mesh=None) -> dict[str, np.ndarray]:
    """The global arrays of a sharded state (``mesh.gather_state``). With
    no ``mesh``: the global arrays of snapshots that each hold a part of
    the domain and its ``block`` = (y0, y1, x0, x1), as a ``Simulation``
    on a mesh stores them (one from each process of the mesh); the parts
    must cover the domain once."""
    if mesh is not None:
        return mesh.gather_state(shards).to_numpy()
    ny = max(p["block"][1] for p in shards)
    nx = max(p["block"][3] for p in shards)
    if sum((y1 - y0) * (x1 - x0) for y0, y1, x0, x1 in
           (p["block"] for p in shards)) != ny * nx:
        raise ValueError(f"blocks {[p['block'] for p in shards]} do not "
                         f"tile the {ny}x{nx} domain once")
    out: dict[str, np.ndarray] = {}
    for p in shards:
        y0, y1, x0, x1 = p["block"]
        for name, a in p.items():
            if isinstance(a, np.ndarray):
                if name not in out:
                    out[name] = np.zeros(a.shape[:-2] + (ny, nx), a.dtype)
                out[name][..., y0:y1, x0:x1] = a
    return out


def _fields_of(cls, obj: Any) -> dict[str, Any]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if hasattr(obj, f.name)}


def grid_from_jax_fields(obj: Any) -> GridSpec:
    """A ``GridSpec`` with the field values of ``obj``."""
    vals = _fields_of(GridSpec, obj)
    for name in ("nx", "ny", "levels"):
        if name in vals:
            vals[name] = int(vals[name])
    for name in ("dx", "dy"):
        if name in vals:
            vals[name] = float(vals[name])
    return GridSpec(**vals)


def params_from_jax_fields(obj: Any) -> PhysicsParams:
    """A ``PhysicsParams`` with the (scalar) field values of ``obj``."""
    return PhysicsParams(**{k: float(v) for k, v in
                            _fields_of(PhysicsParams, obj).items()})
