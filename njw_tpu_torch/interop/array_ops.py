"""Array conversion and chunked host-to-device transfer.

Counterpart of ``njw_tpu/interop/array_ops.py``. ``to_numpy`` and
``to_torch`` convert between NumPy arrays, tensors and array-likes;
``zero_copy_view`` views a CPU tensor as NumPy without a copy;
``chunked_device_put`` moves a large host array to the device through
two pinned chunks. The JAX module's ``to_jax`` has no counterpart: the
port does not import JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device


def to_numpy(a: Any) -> np.ndarray:
    """Any array-like (tensor on any device, NumPy, nested list) as a
    NumPy array (a tensor is copied from its device)."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_torch(a: Any) -> torch.Tensor:
    """A tensor: a tensor stays where it is; anything else becomes a CPU
    tensor sharing the NumPy buffer where it can."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(to_numpy(a)))


def zero_copy_view(a: Any) -> np.ndarray:
    """A NumPy view of a CPU tensor or an array without copying; a CUDA
    tensor (which NumPy cannot view) is copied to the host."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        return a.detach().numpy() if a.device.type == "cpu" \
            else a.detach().cpu().numpy()
    return np.asarray(a)


def chunked_device_put(host_array, chunk_bytes: int = 64 << 20,
                       device="cuda") -> torch.Tensor:
    """Copy a host array to ``device`` in chunks of at most
    ``chunk_bytes`` along axis 0. On CUDA each chunk goes through one of
    two pinned buffers and ``copy_(non_blocking=True)`` on a side stream,
    so that filling one buffer overlaps the other's transfer and pinned
    host memory stays at two chunks. Returns the device tensor once every
    chunk has arrived."""
    dev = require_device(device)
    src = to_torch(host_array)
    if src.device.type != "cpu":
        src = src.cpu()
    if dev.type != "cuda":
        return src.clone()
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    if src.ndim == 0 or src.shape[0] == 0:
        return out.copy_(src)
    row_bytes = max(src[0:1].numel() * src.element_size(), 1)
    rows = max(min(chunk_bytes // row_bytes, src.shape[0]), 1)
    pinned = [torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                          pin_memory=True) for _ in range(2)]
    done = [None, None]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for k, i in enumerate(range(0, src.shape[0], rows)):
            slot = k % 2
            if done[slot] is not None:
                done[slot].synchronize()  # its last transfer has finished
            m = min(rows, src.shape[0] - i)
            pinned[slot][:m].copy_(src[i:i + m])
            out[i:i + m].copy_(pinned[slot][:m], non_blocking=True)
            done[slot] = torch.cuda.Event()
            done[slot].record(stream)
    for ev in done:
        if ev is not None:
            ev.synchronize()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return out
