"""Host spans and the reading of the device trace.

``Spans`` records the benchmark's own host spans around the calls into
each layer of the port (``forecast``, and inside it ``build``, ``steps``,
``output``). In a traced run each span is also a
``torch.profiler.record_function`` range, so that it lies in the trace on
the clock of the device's activities.

``summarise`` reads the profiler's raw activity records (not
``key_averages``, whose per-event tables cost seconds over tens of
thousands of kernels) into a small dict of sums:

* ``window_s``: the traced window, the summed length of the forecasts'
  spans;
* ``busy_s``: the time in it in which a kernel, copy or set ran on the
  device (the union of their intervals);
* ``kernels``: kernels launched in it (copies and sets not counted);
* ``by_kernel``: {group: [launches, seconds]}, the groups of
  ``scripts/profile_torch.py`` (the hand-written kernels by name, cuFFT,
  matmuls, the rest of PyTorch) with copies and sets apart;
* ``idle_by_span``: the idle seconds of the window by the innermost host
  span over them.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Optional

HAND_WRITTEN = ("swe_rk4_kernel", "baro_stage_kernel", "pe_stage_kernel",
                "pe_rk4_kernel", "band_kernel")
PREFIX = "bench."


def group(name: str) -> str:
    """The kernel group of a device activity's name."""
    swe = re.search(r"swe_rk4_kernel<(\d), (true|false)", name)
    if swe:
        return {("1", "false"): "swe_rk4_kernel",
                ("1", "true"): "swe_rk4_kernel_bf16",
                ("2", "false"): "swe_rk4_kernel_multi"}.get(
                    swe.groups(), "swe_rk4_kernel")
    for kernel in HAND_WRITTEN:
        if kernel in name:
            return kernel
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy " + name.split("(")[-1].rstrip(")").strip() \
            if "(" in name else "memcpy"
    if low.startswith("memset"):
        return "memset"
    if "fft" in low:
        return "cufft"
    return "matmul" if "gemm" in low else "other_torch"


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class Spans:
    """Host spans: (name, start, end) in perf_counter seconds; with
    ``traced``, each is a profiler range named ``bench.<name>`` too."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        """``fn`` inside a span named ``name`` at every call."""
        def inner(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        return inner


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clip(intervals: list, windows: list) -> list:
    """The parts of sorted disjoint ``intervals`` inside sorted disjoint
    ``windows``."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            lo, hi = max(a, windows[k][0]), min(b, windows[k][1])
            if hi > lo:
                out.append([lo, hi])
            k += 1
    return out


def summarise(prof) -> Optional[dict]:
    """The sums of one process's trace (see the module docstring), or
    None where the trace holds no forecast span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if name.startswith(PREFIX):
            # a host span; its projection on the device's timeline (a
            # user annotation of device type CUDA) is no device activity
            if e.device_type() != cuda:
                spans.append((start, end, name[len(PREFIX):]))
        elif e.device_type() == cuda:
            device.append((start, end, name))
    forecasts = _union([[a, b] for a, b, n in spans if n == "forecast"])
    if not forecasts:
        return None
    window_ns = sum(b - a for a, b in forecasts)
    inside = _clip(sorted([[a, b] for a, b, _ in device]), forecasts)
    busy = _union(inside)
    by_kernel: dict = {}
    kernels = 0
    starts = [a for a, _ in forecasts]
    for a, b, name in device:
        i = bisect.bisect_right(starts, a) - 1
        if not ((i >= 0 and forecasts[i][1] > a)
                or (i + 1 < len(starts) and starts[i + 1] < b)):
            continue
        g = group(name)
        n_s = by_kernel.setdefault(g, [0, 0.0])
        n_s[0] += 1
        n_s[1] += (b - a) / 1e9
        kernels += is_kernel(name)
    # the idle time inside each forecast, each part of a gap by the
    # innermost host span over it (the spans nest, so the latest started)
    inner = sorted((a, b, n) for a, b, n in spans if n != "forecast")
    idle: dict = {}
    for fa, fb in forecasts:
        mine = [sp for sp in inner if sp[0] < fb and sp[1] > fa]
        edges = [[fa, fa]] + [iv for iv in busy if fa <= iv[0] < fb] \
            + [[fb, fb]]
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            cuts = sorted({a, b} | {t for sa, sb, _ in mine
                                    for t in (sa, sb) if a < t < b})
            for p, q in zip(cuts[:-1], cuts[1:]):
                mid, label = (p + q) / 2, "forecast"
                for sa, sb, n in mine:
                    if sa > mid:
                        break
                    if sb > mid:
                        label = n
                idle[label] = idle.get(label, 0.0) + (q - p) / 1e9
    return {"window_s": window_ns / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "kernels": kernels, "by_kernel": by_kernel,
            "idle_by_span": idle}


def breakdown(summary: dict) -> dict:
    """The ``breakdown`` of a result line: the device's groups that took
    most time, and the idle seconds by host span (at most 10 each)."""
    ops = sorted(((g, s) for g, (_, s) in summary["by_kernel"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[g, s] for g, s in ops],
            "idle_gaps": [[g, s] for g, s in gaps]}
