"""Device memory manager on CUDA streams and events.

Counterpart of ``njw_tpu/interop/device_memory.py``: named device
buffers, transfers host to device, device to device and device to host
queued on the manager's own CUDA stream, each returning a
``TransferHandle`` (``wait()`` blocks until the transfer has finished,
``ready`` asks its event), and memory statistics from
``torch.cuda.memory_stats`` beside the tracked buffers. On the CPU the
transfers are plain copies, complete on return.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device


class TransferHandle:
    """A queued transfer: ``value`` is usable after ``wait()``."""

    def __init__(self, value, event: Optional[torch.cuda.Event] = None):
        self.value = value
        self._event = event

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return self.value

    @property
    def ready(self) -> bool:
        return True if self._event is None else bool(self._event.query())


class DeviceMemoryManager:
    """Named device-buffer registry with transfers and stats (CUDA
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, device="cuda"):
        self.device = require_device(device)
        self._buffers: dict[str, torch.Tensor] = {}
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _queued(self, fn, reads=()) -> TransferHandle:
        """Run ``fn()`` on the manager's stream after the work already
        queued on the device's current stream; a handle to its result.
        The device tensors it ``reads``, and a device tensor it returns,
        are marked as used on both streams, so that freeing one early
        cannot hand its memory to other work while the copy runs."""
        if self.stream is None:
            return TransferHandle(fn())
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            value = fn()
            event = torch.cuda.Event()
            event.record(self.stream)
        for t in reads:
            t.record_stream(self.stream)
        if value.is_cuda:
            value.record_stream(current)
        return TransferHandle(value, event)

    # -- transfers -------------------------------------------------------
    def to_device(self, name: str, host_array) -> TransferHandle:
        """Host to device, from pinned memory when on CUDA."""
        src = torch.from_numpy(np.ascontiguousarray(host_array))
        if self.stream is not None:
            src = src.pin_memory()
        handle = self._queued(
            lambda: src.to(self.device, non_blocking=True, copy=True))
        self._buffers[name] = handle.value
        return handle

    def to_host(self, name: str) -> TransferHandle:
        """Device to host; the handle's value is a NumPy array."""
        buf = self._buffers[name]
        host = torch.empty(buf.shape, dtype=buf.dtype,
                           pin_memory=self.stream is not None)
        handle = self._queued(lambda: host.copy_(buf, non_blocking=True),
                              reads=(buf,))
        handle.value = host.numpy()
        return handle

    def copy(self, src: str, dst: str) -> TransferHandle:
        """Device to device."""
        buf = self._buffers[src]
        handle = self._queued(buf.clone, reads=(buf,))
        self._buffers[dst] = handle.value
        return handle

    # -- registry --------------------------------------------------------
    def get(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def free(self, name: str):
        self._buffers.pop(name, None)

    def free_all(self):
        self._buffers.clear()

    @property
    def allocated_bytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self._buffers.values())

    def memory_stats(self) -> dict:
        """``torch.cuda.memory_stats`` of the device (none on the CPU),
        with the tracked buffers' count and bytes."""
        stats = (dict(torch.cuda.memory_stats(self.device))
                 if self.device.type == "cuda" else {})
        stats["tracked_buffers"] = len(self._buffers)
        stats["tracked_bytes"] = self.allocated_bytes
        return stats

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free_all()
