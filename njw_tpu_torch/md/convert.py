"""Carry MD states, topologies and LJ parameters across from the JAX
package and back.

Both packages exchange NumPy arrays only: a JAX ``MDState``,
``Topology`` or ``LJParams`` is read field by field, as is any object or
dict with those fields, so this module imports nothing of JAX. Index
fields become int64 tensors in the port and go back as int32 arrays (the
JAX package's type).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from njw_tpu_torch.md.system import LJParams, MDState, Topology
from njw_tpu_torch.platform.device import require_device

_INDEX_FIELDS = ("type_id", "bonds", "angles", "dihedrals")


def _get(other, key):
    return other.get(key) if isinstance(other, dict) else getattr(other, key)


def _tensors(cls, other, dev):
    out = {}
    for f in dataclasses.fields(cls):
        v = _get(other, f.name)
        if v is None:
            out[f.name] = None
            continue
        dtype = np.int64 if f.name in _INDEX_FIELDS else np.float32
        out[f.name] = torch.from_numpy(np.array(v, dtype)).to(dev)
    return cls(**out)


def _arrays(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None:
            v = v.cpu().numpy()
            if f.name in _INDEX_FIELDS:
                v = v.astype(np.int32)
        out[f.name] = v
    return out


def state_from(other: Any, device="cuda") -> MDState:
    """The port's ``MDState`` holding the values of ``other``."""
    return _tensors(MDState, other, require_device(device))


def topology_from(other: Any, device="cuda") -> Topology:
    """The port's ``Topology`` holding the values of ``other``."""
    return _tensors(Topology, other, require_device(device))


def lj_from(other: Any, device="cuda") -> LJParams:
    """The port's ``LJParams`` holding the values of ``other``."""
    return _tensors(LJParams, other, require_device(device))


def state_arrays(s: MDState) -> dict:
    """A port ``MDState`` as NumPy arrays (the JAX ``MDState``'s fields)."""
    return _arrays(s)


def topology_arrays(t: Topology) -> dict:
    """A port ``Topology`` as NumPy arrays, None where a term is absent."""
    return _arrays(t)


def lj_arrays(lj: LJParams) -> dict:
    return _arrays(lj)
