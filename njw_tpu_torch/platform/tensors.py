"""Input conversion and exact scalar division for the imaging and terrain
packages.

A function of ``medical`` or ``geospatial`` takes tensors or NumPy
arrays: a tensor stays on its device, anything else goes to the device
the caller names (CUDA unless given), which must exist.

``divide`` and ``rdivide`` round as one float division on every device.
On CUDA, ``tensor / python_float`` multiplies by the float32 reciprocal
of the number (PyTorch's optimisation for a CPU scalar operand), which
may round the last bit otherwise; XLA and PyTorch's CPU divide. And
``python_float / tensor`` is the reciprocal of the tensor times the
number on both devices. Where a comparison downstream must come out the
same on both devices (D8 flow directions, point binning, the B-spline
basis, the optimisers' bias corrections), the other operand is made a
tensor on the device first.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``: a tensor stays on its device; other
    input goes to ``device`` (CUDA unless given), which must exist."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    dev = require_device("cuda" if device is None else device)
    return torch.from_numpy(np.array(x)).to(dev, dtype)


def as_complex(x, device=None) -> torch.Tensor:
    """``x`` as complex64 (real input gets a zero imaginary part)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.complex64)
    return as_tensor(x, device, torch.complex64)


def device_of(*xs, device=None) -> torch.device:
    """The device of the first tensor among ``xs``, else ``device`` (CUDA
    unless given), which must exist."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return require_device("cuda" if device is None else device)


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as a true float division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def rdivide(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as one float division (PyTorch's ``c / x`` multiplies
    ``c`` by the reciprocal of ``x``)."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def to_numpy(x) -> np.ndarray:
    """``x`` as a NumPy array (a tensor is copied from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 by JAX's formula:
    start * (1 - s) + stop * s with s = i / (num - 1), then stop. XLA may
    round s in its own way (within an ulp)."""
    if num < 2:
        return np.full(num, start, np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(start) * (np.float32(1) - step) + np.float32(stop) * step
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)
