"""Cross-process shared NumPy arrays.

Counterpart of ``njw_tpu/interop/shared_memory.py`` (NumPy and the
standard library only): a ``SharedArray`` is a NumPy array in named
shared memory whose shape and dtype travel in a 256-byte header, so that
another process attaches by name; ``SharedMemoryManager`` owns segments
and releases them.
"""
from __future__ import annotations

import json
from multiprocessing import shared_memory
from typing import Optional

import numpy as np


class SharedArray:
    """A NumPy array backed by named shared memory.

    Producer: ``sa = SharedArray.create("weights", (1024,), np.float32)``;
    consumer (other process): ``sa = SharedArray.attach("weights")``.
    The dtype/shape header travels in the first 256 bytes, so attachment
    needs only the name.
    """

    _HEADER = 256

    def __init__(self, shm: shared_memory.SharedMemory, array: np.ndarray,
                 owner: bool):
        self._shm = shm
        self.array = array
        self._owner = owner

    # -- lifecycle -------------------------------------------------------
    @classmethod
    def create(cls, name: str, shape, dtype) -> "SharedArray":
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=cls._HEADER + nbytes)
        header = json.dumps({"shape": list(shape),
                             "dtype": dtype.str}).encode()
        if len(header) >= cls._HEADER:
            shm.close()
            shm.unlink()
            raise ValueError("shape/dtype header too large")
        shm.buf[: len(header)] = header
        shm.buf[len(header)] = 0  # terminator
        arr = np.ndarray(shape, dtype, buffer=shm.buf[cls._HEADER:])
        arr[...] = 0
        return cls(shm, arr, owner=True)

    @classmethod
    def attach(cls, name: str) -> "SharedArray":
        shm = shared_memory.SharedMemory(name=name)
        raw = bytes(shm.buf[: cls._HEADER])
        header = json.loads(raw[: raw.index(0)].decode())
        arr = np.ndarray(tuple(header["shape"]), np.dtype(header["dtype"]),
                         buffer=shm.buf[cls._HEADER:])
        return cls(shm, arr, owner=False)

    @classmethod
    def from_array(cls, name: str, source: np.ndarray) -> "SharedArray":
        sa = cls.create(name, source.shape, source.dtype)
        sa.array[...] = source
        return sa

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self):
        # the ndarray view must die before the mmap can close
        self.array = None
        self._shm.close()

    def unlink(self):
        if self._owner:
            self._shm.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self.unlink()


class SharedMemoryManager:
    """Tracks owned segments and guarantees cleanup."""

    def __init__(self, prefix: str = "njw"):
        self.prefix = prefix
        self._segments: dict[str, SharedArray] = {}
        self._counter = 0

    def allocate(self, shape, dtype, name: Optional[str] = None) -> SharedArray:
        if name is None:
            name = f"{self.prefix}_{id(self)}_{self._counter}"
            self._counter += 1
        sa = SharedArray.create(name, shape, dtype)
        self._segments[sa.name] = sa
        return sa

    def share(self, array: np.ndarray, name: Optional[str] = None) -> SharedArray:
        if name is None:
            name = f"{self.prefix}_{id(self)}_{self._counter}"
            self._counter += 1
        sa = SharedArray.from_array(name, array)
        self._segments[sa.name] = sa
        return sa

    def get(self, name: str) -> SharedArray:
        if name in self._segments:
            return self._segments[name]
        return SharedArray.attach(name)

    def release(self, name: str):
        sa = self._segments.pop(name, None)
        if sa is not None:
            sa.close()
            sa.unlink()

    def release_all(self):
        for name in list(self._segments):
            self.release(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release_all()
