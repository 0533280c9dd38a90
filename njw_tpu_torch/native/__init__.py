"""ctypes bindings for the native host library (``native/libnjw_host.so``).

Counterpart of ``njw_tpu/native/__init__.py``: the port's own loader of
the same C++ library at the repository's root (``native/``, built by
``make -C native`` at first use; the C++ is shared, not copied). It binds

* OpenMP CPU kernels: ``swe_rk4_run`` (periodic shallow-water RK4),
  ``nbody_accelerations``, ``lj_forces``, ``fir_filter``: host oracles
  for large-grid validation;
* ``AsyncSnapshotWriter``, a bounded-queue background snapshot writer.

The functions take and return NumPy arrays (``to_numpy`` a tensor
first). ``available()`` says whether the library built and loaded, and
``load_error()`` why not; a consumer guards with ``available()``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libnjw_host.so"))

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build() -> bool:
    """``make -C native``; on failure ``load_error()`` says why (with the
    first error line make or the compiler wrote)."""
    global _load_error
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        return True
    except subprocess.CalledProcessError as e:
        lines = (e.stderr or e.stdout or "").strip().splitlines()
        errors = [ln for ln in lines if "error" in ln.lower()] or lines[-1:]
        _load_error = f"build failed: {e}" + "".join(
            f": {ln}" for ln in errors[:1])
    except (OSError, subprocess.TimeoutExpired) as e:
        _load_error = f"build failed: {e}"
    return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None:
        return _lib
    # Always run make: it is a no-op when the .so is newer than the
    # sources, and it never loads a stale or foreign-built (-march=native
    # elsewhere) binary.
    if not _build() and not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _load_error = str(e)
        return None

    lib.swe_tendencies.argtypes = [_f32p] * 6 + [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.swe_rk4_step.argtypes = [_f32p] * 4 + [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.nbody_accelerations.argtypes = [
        _f32p, _f32p, _f32p, ctypes.c_int32, ctypes.c_float, ctypes.c_float]
    lib.lj_forces.argtypes = [
        _f32p, _f32p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, _f32p]
    lib.fir_filter.argtypes = [
        _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32]
    lib.omp_thread_count.restype = ctypes.c_int32

    lib.snapshot_writer_create.restype = ctypes.c_void_p
    lib.snapshot_writer_create.argtypes = [ctypes.c_int64]
    lib.snapshot_writer_enqueue.restype = ctypes.c_int32
    lib.snapshot_writer_enqueue.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _f32p, ctypes.c_int64,
        ctypes.c_int64]
    lib.snapshot_writer_flush.argtypes = [ctypes.c_void_p]
    lib.snapshot_writer_written.restype = ctypes.c_int64
    lib.snapshot_writer_written.argtypes = [ctypes.c_void_p]
    lib.snapshot_writer_destroy.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def load_error() -> Optional[str]:
    return _load_error


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------

def swe_rk4_run(u, v, h, *, dt: float, n_steps: int, dx: float = 1.0,
                dy: float = 1.0, gravity: float = 9.81,
                coriolis_f: float = 0.0):
    """Run n_steps of RK4 SWE on the native OpenMP core (periodic BC).
    Returns new (u, v, h) float32 arrays."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    u = np.ascontiguousarray(u, np.float32).copy()
    v = np.ascontiguousarray(v, np.float32).copy()
    h = np.ascontiguousarray(h, np.float32).copy()
    ny, nx = u.shape
    scratch = np.empty(12 * ny * nx, np.float32)
    for _ in range(n_steps):
        lib.swe_rk4_step(u.ravel(), v.ravel(), h.ravel(), scratch,
                         ny, nx, dx, dy, gravity, coriolis_f, dt)
    return u, v, h


def nbody_accelerations(pos, mass, G: float = 1.0,
                        softening: float = 1e-6) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    pos = np.ascontiguousarray(pos, np.float32)
    mass = np.ascontiguousarray(mass, np.float32)
    acc = np.empty_like(pos)
    lib.nbody_accelerations(pos.ravel(), mass, acc.ravel(),
                            pos.shape[0], G, softening)
    return acc


def lj_forces(pos, box, epsilon: float = 1.0, sigma: float = 1.0,
              cutoff: float = 2.5) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    pos = np.ascontiguousarray(pos, np.float32)
    box = np.ascontiguousarray(box, np.float32)
    force = np.empty_like(pos)
    lib.lj_forces(pos.ravel(), force.ravel(), pos.shape[0],
                  epsilon, sigma, cutoff, box)
    return force


def fir_filter(x, taps) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    x = np.ascontiguousarray(x, np.float32)
    taps = np.ascontiguousarray(taps, np.float32)
    y = np.empty_like(x)
    lib.fir_filter(x, taps, y, x.shape[0], taps.shape[0])
    return y


class AsyncSnapshotWriter:
    """Bounded-queue background snapshot writer (native thread)."""

    def __init__(self, max_queue: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self._lib = lib
        self._handle = lib.snapshot_writer_create(max_queue)

    def enqueue(self, path: str, data, step: int = 0) -> bool:
        arr = np.ascontiguousarray(data, np.float32).ravel()
        return bool(self._lib.snapshot_writer_enqueue(
            self._handle, path.encode(), arr, arr.size, step))

    def flush(self):
        self._lib.snapshot_writer_flush(self._handle)

    @property
    def written(self) -> int:
        return int(self._lib.snapshot_writer_written(self._handle))

    def close(self):
        if self._handle:
            self._lib.snapshot_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def read_snapshot(path: str):
        """Read back a snapshot file -> (step, float32 array)."""
        with open(path, "rb") as fh:
            header = np.fromfile(fh, np.int64, 2)
            data = np.fromfile(fh, np.float32, int(header[1]))
        return int(header[0]), data
