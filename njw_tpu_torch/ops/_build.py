"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``njw_tpu_torch/ops/build/``, named by a
hash of the source and the flags, at first use. The library is loaded with
``ctypes``. Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# No --use_fast_math: the kernels are held to their plain PyTorch versions
# at float32 tolerances. -Xptxas -v records registers/spills in the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of njw_tpu_torch are built "
            "from source at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, named by a hash of
    the source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; return
    (target, temp output, process) or None."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, job) -> None:
    target, tmp, proc = job
    log, _ = proc.communicate()
    target.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: concurrent builds agree


def build_all() -> dict[str, Path]:
    """Build every kernel source, one nvcc per source, all in parallel.
    Returns {name: library path}."""
    names = sources()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_bound: dict[str, tuple] = {}


def bind(name: str, argtypes: list) -> tuple:
    """(launch, error_string) of ``csrc/<name>.cu``: its C entries
    ``<name>_launch`` (returning a CUDA error code) and
    ``<name>_error_string``, with ``argtypes`` set once at load."""
    entry = _bound.get(name)
    if entry is None:
        lib = load(name)
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        entry = _bound[name] = (launch, err)
    return entry


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Processes that load one library at once (the ranks of a mesh) build
    it once: the first takes a lock file beside it and builds, the others
    wait on the lock and find the library built."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target = library_path(name)
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(target.with_suffix(".lock"), "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    job = _start(name)
                    if job is not None:
                        _finish(name, job)
            lib = ctypes.CDLL(str(target))
            _loaded[name] = lib
    return lib
