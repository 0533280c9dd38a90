"""Carry states, grids and physical constants across from the JAX package.

Both packages exchange plain values only: a state travels as the dict of
NumPy arrays that ``WeatherState.to_numpy()`` returns in either package,
and a grid or parameter set is read field by field from any object that
has the fields (a JAX ``GridSpec`` / ``PhysicsParams``, a namespace, ...),
so this module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState


def state_from_numpy(d: Mapping[str, np.ndarray], device) -> WeatherState:
    """A float32 ``WeatherState`` on ``device`` from a dict of arrays."""
    return WeatherState(**{
        name: torch.from_numpy(np.array(val, dtype=np.float32)).to(device)
        for name, val in d.items()
    })


def state_to_numpy(s: WeatherState) -> dict[str, np.ndarray]:
    """The dict of NumPy arrays the JAX ``WeatherState.to_numpy`` gives."""
    return s.to_numpy()


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
