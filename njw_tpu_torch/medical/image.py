"""MedicalImage container and file IO.

Counterpart of ``njw_tpu/medical/image.py``: a 2-D, 3-D or 4-D image with
its spacing, modality and metadata, loaded from and saved to .npy, .npz
(the array under the key ``data``, so a file saved by either package
loads in the other) and .png (through matplotlib, imported only when a
png is read or written).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.tensors import to_numpy


@dataclass
class MedicalImage:
    data: torch.Tensor                # (H, W) | (D, H, W) | (T, D, H, W)
    spacing: tuple = (1.0, 1.0, 1.0)  # physical voxel spacing
    modality: str = "generic"         # CT | MRI | ...
    metadata: dict = field(default_factory=dict)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def shape(self):
        return tuple(self.data.shape)

    def slice2d(self, index: int = 0) -> torch.Tensor:
        if self.data.ndim == 2:
            return self.data
        return self.data.reshape((-1,) + tuple(self.data.shape[-2:]))[index]

    def astype(self, dtype):
        return MedicalImage(self.data.to(dtype), self.spacing,
                            self.modality, dict(self.metadata))

    def statistics(self) -> dict:
        a = to_numpy(self.data).astype(np.float64)
        return {"min": float(a.min()), "max": float(a.max()),
                "mean": float(a.mean()), "std": float(a.std())}


# 64-bit arrays load as their 32-bit kind, as JAX (x64 off) loads them
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.complex128): np.complex64}


def _image(arr, device, **kw) -> MedicalImage:
    """A MedicalImage holding ``arr`` on ``device``."""
    arr = np.asarray(arr)
    arr = np.ascontiguousarray(arr, _NARROW.get(arr.dtype, arr.dtype))
    return MedicalImage(torch.from_numpy(arr).to(device), **kw)


def load_image(path: str, *, device="cuda", **kw) -> MedicalImage:
    """Read an image file onto ``device``; ``kw`` are MedicalImage's
    fields (spacing, modality, metadata)."""
    device = require_device(device)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return _image(np.load(path), device, **kw)
    if ext == ".npz":
        with np.load(path) as d:
            key = "data" if "data" in d else d.files[0]
            return _image(d[key], device, **kw)
    if ext in (".png", ".jpg", ".jpeg"):
        import matplotlib.image as mpimg

        arr = mpimg.imread(path)
        if arr.ndim == 3:
            arr = arr[..., :3].mean(axis=-1)
        return _image(np.asarray(arr, np.float32), device, **kw)
    raise ValueError(f"unsupported image format {ext!r} (npy/npz/png)")


def save_image(path: str, image) -> str:
    """Write a MedicalImage, tensor or array to .npy, .npz or .png."""
    data = image.data if isinstance(image, MedicalImage) else image
    arr = to_numpy(data)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        np.save(path, arr)
    elif ext == ".npz":
        np.savez_compressed(path, data=arr)
    elif ext == ".png":
        import matplotlib.image as mpimg

        lo, hi = arr.min(), arr.max()
        norm = (arr - lo) / (hi - lo) if hi > lo else arr * 0
        mpimg.imsave(path, norm, cmap="gray")
    else:
        raise ValueError(f"unsupported image format {ext!r}")
    return path
