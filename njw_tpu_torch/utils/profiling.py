"""Profiling and timing.

Counterpart of ``njw_tpu/utils/profiling.py``:

* ``trace(log_dir)``      a ``torch.profiler`` scope (host, and the CUDA
                          device when there is one) that writes a Chrome
                          trace into ``log_dir`` when it closes, the
                          port's spans on a track of their own
* ``spans()``             the port's spans of the latest profiler session
                          (``span``, ``record``: how the port adds them)
* ``time_jitted(fn, *a)`` best-of / mean time of a call after one warm-up
                          call: CUDA events on the callable's CUDA device,
                          the host clock on the CPU
* ``Timer``               named-phase wall-clock accumulator
* ``OpStats``             per-(op, key) moving averages
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree


# ------------------------------------------------------------- spans
#
# The port records spans on its forecast path (``weather/model.py``:
# ``sim.build``, ``sim.build.state``, ``sim.run``, ``sim.step``,
# ``sim.step.enqueue``, ``sim.output``, ``sim.output.copy``; on a mesh
# ``sim.step.exchange``, ``parallel/halo.py``) only while a
# ``torch.profiler`` session records: off, a span site costs one check of
# the profiler's flag. They are kept here, not as profiler events: the
# profiler projects a ``record_function`` range onto the device's
# timeline, where a trace reader would take it for device work.

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """One span: ``start`` and ``end`` in ns on the profiler's time base
    (kineto's event times, on ``time.time_ns``'s base), ``parent`` the
    index in ``spans()`` of the span it lies in, ``sim`` the identifier of
    its simulation, ``counters`` its counts (``steps``, ``snapshots``,
    ``bytes``, ``pinned_bytes``, ``host_allocs``, ``rank``, ``exchanges``,
    ``exchange_bytes``)."""

    name: str
    start: int
    end: Optional[int]
    parent: Optional[int]
    sim: Optional[int]
    counters: dict

    @property
    def duration_ns(self) -> int:
        return self.end - self.start


class _Session:
    """The spans of one profiler session. A new session is seen at the
    first span site that finds the profiler recording after one that
    found it off."""

    def __init__(self, fresh: bool = False):
        self.spans: list[Span] = []
        self.open: list[int] = []    # indices of the spans not yet closed
        # perf_counter to the profiler's base, one offset a session
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.fresh = fresh           # the profiler was off at a site since


_session = _Session(fresh=True)
_sim_ids = itertools.count(1)


def new_sim_id() -> int:
    """A new simulation identifier (they increase with each call)."""
    return next(_sim_ids)


def recording() -> bool:
    """Whether a profiler session records, so that span sites keep spans.
    The first call in a session starts the buffer afresh."""
    global _session
    if not _profiler_enabled():
        _session.fresh = True
        return False
    if _session.fresh:
        _session = _Session()
    return True


def spans() -> list[Span]:
    """The spans of the latest profiler session, in the order they opened
    (a span's ``parent`` indexes this list; ``end`` is None while one is
    open)."""
    return list(_session.spans)


def _ns(t: float) -> int:
    return round(t * 1e9) + _session.offset_ns


def _add(name: str, start: int, end: Optional[int], sim: Optional[int],
         parent: Optional[int], counters: dict) -> int:
    if parent is None and _session.open:
        parent = _session.open[-1]
    if sim is None and parent is not None:
        sim = _session.spans[parent].sim
    _session.spans.append(Span(name, start, end, parent, sim, counters))
    return len(_session.spans) - 1


def record(name: str, t0: float, t1: float, sim: Optional[int] = None,
           parent: Optional[int] = None, **counters) -> int:
    """Keep a closed span from two ``time.perf_counter()`` reads the
    caller took; call it only where ``recording()`` was true. Its parent
    is ``parent`` (an index ``record`` returned), else the innermost open
    ``span``; ``sim`` is inherited from the parent. Returns its index."""
    return _add(name, _ns(t0), _ns(t1), sim, parent, counters)


class _Open:
    def __init__(self, name: str, sim: Optional[int]):
        self.name, self.sim = name, sim

    def __enter__(self) -> Span:
        self.session = _session
        i = _add(self.name, time.perf_counter_ns() + _session.offset_ns,
                 None, self.sim, None, {})
        _session.open.append(i)
        self.span = _session.spans[i]
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end = time.perf_counter_ns() + self.session.offset_ns
        self.session.open.pop()


_OFF = contextlib.nullcontext()


def span(name: str, sim: Optional[int] = None):
    """A span around the enclosed block while a profiler session records
    (``with span(...) as s``: ``s`` is the ``Span``, whose counters the
    block may fill, or None when nothing records)."""
    return _Open(name, sim) if recording() else _OFF


class _Begun:
    """A span opened at a clock read the caller took; the spans kept until
    it closes lie in it. ``close(t1)`` ends it at another read, and the
    end of its ``with`` block at the latest."""

    def __init__(self, name: str, t0: float, sim: Optional[int],
                 counters: dict):
        self.session = _session
        self.index = _add(name, _ns(t0), None, sim, None, counters)
        _session.open.append(self.index)

    def close(self, t1: Optional[float] = None) -> None:
        if self.index is None:
            return
        s = self.session
        end = time.perf_counter_ns() if t1 is None else round(t1 * 1e9)
        s.spans[self.index].end = end + s.offset_ns
        s.open.remove(self.index)
        self.index = None

    def __enter__(self) -> "_Begun":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _NotBegun:
    def close(self, t1: Optional[float] = None) -> None:
        pass

    def __enter__(self) -> "_NotBegun":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOT_BEGUN = _NotBegun()


def begin(name: str, t0: float, sim: Optional[int] = None, **counters):
    """A span from ``t0`` (a ``time.perf_counter()`` read) while a profiler
    session records, for a ``with`` block that calls ``close(t1)`` on it
    at its end's clock read; spans kept meanwhile lie in it. Nothing is
    kept when nothing records."""
    return _Begun(name, t0, sim, counters) if recording() else _NOT_BEGUN


def _export_spans(path: str) -> None:
    """Append the session's spans to the Chrome trace at ``path`` as
    complete events of a track of their own, on the trace's clock."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), "njw_tpu_torch spans"
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": tid}})
    for i, s in enumerate(_session.spans):
        if s.end is None:
            continue
        events.append({"ph": "X", "cat": "njw_tpu_torch", "name": s.name,
                       "pid": pid, "tid": tid, "ts": (s.start - base) / 1e3,
                       "dur": s.duration_ns / 1e3,
                       "args": {"index": i, "parent": s.parent,
                                "sim": s.sim, **s.counters}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write ``trace.json`` (Chrome
    trace format) into ``log_dir``, with the port's spans of the block.
    Yields the profiler."""
    global _session
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _session = _Session()
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _export_spans(path)


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
