"""Carry an N-body system across from the JAX package and back.

Both packages exchange NumPy arrays only: a JAX ``NBodySystem`` is read
field by field (pos, vel, mass, G, softening), as is any object or dict
with those fields, so this module imports nothing of JAX. A saved state
needs no converter: both packages write and read the same ``.npz`` keys.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from njw_tpu_torch.nbody.system import NBodySystem
from njw_tpu_torch.platform.device import require_device


def _get(other, key):
    return other[key] if isinstance(other, dict) else getattr(other, key)


def system_from(other: Any, device="cuda") -> NBodySystem:
    """The port's ``NBodySystem`` holding the values of ``other``."""
    dev = require_device(device)

    def t(key):
        return torch.from_numpy(
            np.array(_get(other, key), np.float32)).to(dev)

    return NBodySystem(pos=t("pos"), vel=t("vel"), mass=t("mass"),
                       G=float(np.asarray(_get(other, "G"))),
                       softening=float(np.asarray(_get(other, "softening"))))


def system_arrays(s: NBodySystem) -> dict:
    """A port ``NBodySystem`` as NumPy arrays and floats (the fields of
    the JAX ``NBodySystem``)."""
    return {"pos": s.pos.cpu().numpy(), "vel": s.vel.cpu().numpy(),
            "mass": s.mass.cpu().numpy(), "G": float(s.G),
            "softening": float(s.softening)}
