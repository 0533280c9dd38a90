"""Profiling and timing.

Counterpart of ``njw_tpu/utils/profiling.py``:

* ``trace(log_dir)``      a ``torch.profiler`` scope (host, and the CUDA
                          device when there is one) that writes a Chrome
                          trace into ``log_dir`` when it closes
* ``time_jitted(fn, *a)`` best-of / mean time of a call after one warm-up
                          call: CUDA events on the callable's CUDA device,
                          the host clock on the CPU
* ``Timer``               named-phase wall-clock accumulator
* ``OpStats``             per-(op, key) moving averages
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils import _pytree


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write ``trace.json`` (Chrome
    trace format) into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device(out, args) -> torch.device:
    """The device of the first tensor in the output, else in the
    arguments, else the CPU."""
    for tree in (out, args):
        for leaf in _pytree.tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return torch.device("cpu")


def time_jitted(fn: Callable, *args, repeats: int = 5, **kwargs) -> dict:
    """Best-of / mean seconds of ``fn(*args, **kwargs)`` after one warm-up
    call (which builds any kernel it launches). On a CUDA device each call
    is timed by CUDA events and synchronised; on the CPU by the host
    clock."""
    out = fn(*args, **kwargs)
    dev = _device(out, (args, kwargs))
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "repeats": repeats,
    }


class Timer:
    """Named-phase wall-clock accumulator."""

    def __init__(self):
        self.totals_ms: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals_ms[name] += (time.perf_counter() - t0) * 1e3
            self.counts[name] += 1

    def breakdown(self) -> dict[str, float]:
        return dict(self.totals_ms)

    def report(self) -> str:
        total = sum(self.totals_ms.values()) or 1e-12
        lines = [f"{'phase':<24}{'ms':>12}{'%':>8}{'calls':>8}"]
        for name, ms in sorted(self.totals_ms.items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{ms:>12.2f}{100 * ms / total:>7.1f}%"
                         f"{self.counts[name]:>8}")
        return "\n".join(lines)


class OpStats:
    """Per-(op, key) exponential moving averages of measured times."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._avg: dict[tuple, float] = {}
        self._n: dict[tuple, int] = defaultdict(int)

    def record(self, op: str, key: Any, ms: float):
        k = (op, key)
        if k in self._avg:
            self._avg[k] = (1 - self.alpha) * self._avg[k] + self.alpha * ms
        else:
            self._avg[k] = ms
        self._n[k] += 1

    def average_ms(self, op: str, key: Any) -> float:
        return self._avg.get((op, key), float("nan"))

    def best_key(self, op: str):
        """The key (e.g. block shape) with the lowest moving average."""
        cands = [(k[1], v) for k, v in self._avg.items() if k[0] == op]
        return min(cands, key=lambda kv: kv[1])[0] if cands else None
