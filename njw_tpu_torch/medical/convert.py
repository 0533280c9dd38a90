"""Carry medical images across from the JAX package and back.

Both packages exchange NumPy arrays only: a JAX ``MedicalImage`` (or any
object or dict with its fields) is read field by field, so this module
imports nothing of JAX. Saved images need no converter: both packages
write and read the same ``.npy`` / ``.npz`` files (the array under
``data``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from njw_tpu_torch.medical.image import MedicalImage
from njw_tpu_torch.platform.device import require_device


def _get(other, key, default=None):
    if isinstance(other, dict):
        return other.get(key, default)
    return getattr(other, key, default)


def image_from(other: Any, device="cuda") -> MedicalImage:
    """The port's ``MedicalImage`` holding the values of ``other`` (its
    array keeps its type)."""
    data = np.array(_get(other, "data"))
    return MedicalImage(
        torch.from_numpy(data).to(require_device(device)),
        spacing=tuple(_get(other, "spacing", (1.0, 1.0, 1.0))),
        modality=_get(other, "modality", "generic"),
        metadata=dict(_get(other, "metadata", None) or {}))


def image_fields(img: MedicalImage) -> dict:
    """A port ``MedicalImage`` as the JAX ``MedicalImage``'s fields, the
    array as NumPy."""
    return {"data": img.data.detach().cpu().numpy(),
            "spacing": tuple(img.spacing), "modality": img.modality,
            "metadata": dict(img.metadata)}
