"""The one-card forecast loop, on the port's public entry.

Each forecast builds ``Simulation.from_config(config, ic, **params)`` from
parameters drawn from the seed, then ``Simulation.run(steps,
output_interval=interval)``, which leaves the snapshots on the host. A
forecast's time runs from the build call until its output can be read
(the device's work waited for, the last snapshot read once to see that
it is finite) and the harness has let go of it (kept by the sample for
the check, which copies nothing, or released). The window runs whole
forecasts, one after another, until ``seconds`` have passed, and ends
with the forecast in flight. Before it, ``warm_forecasts`` forecasts of
the same shapes (from their own draws) load the kernel and fill the
allocator's cache: that, the imports and the context are set-up.
"""
from __future__ import annotations

import sys
import time
import traceback
import weakref

from perfbench import harness
from perfbench.trace import Spans, summarise


def _forecast(Simulation, cfg, t: dict, params: dict, spans: Spans,
              fields, sync, leaks: list):
    """One forecast until its output can be read. Returns (snapshots,
    whether the last is finite, build seconds, steps, the port's output
    ms). The simulation is released before it returns; one that outlives
    its release is counted in ``leaks``."""
    with spans("forecast"):
        t0 = time.perf_counter()
        with spans("build"):
            sim = Simulation.from_config(cfg, t["ic"], **params)
        build = time.perf_counter() - t0
        # the benchmark's spans around the calls run makes into the port;
        # taken off after the run, since each refers to the simulation
        sim.step = spans.wrap("steps", sim.step)
        sim._store_output = spans.wrap("output", sim._store_output)
        try:
            sim.run(t["steps"], output_interval=t["output_interval"])
        finally:
            del sim.step, sim._store_output
        sync()
        snaps, steps = sim.snapshots, sim.step_count
        io_ms = sim.metrics.io_time_ms
        alive = weakref.ref(sim)
        del sim
        if alive() is not None:
            leaks.append(1)
        ok = bool(snaps) and harness.finite(snaps[-1], fields)
    return snaps, ok, build, steps, io_ms


def _collections() -> int:
    import gc

    return sum(g["collections"] for g in gc.get_stats())


def run(c: harness.Cell, seed: int, seconds: float, traced: bool,
        start: float, device: str = "cuda") -> harness.Record:
    import torch
    from njw_tpu_torch import ops
    from njw_tpu_torch.weather.model import SimConfig, Simulation

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = SimConfig(**c.config["sim"], device=device)
    t = c.traffic
    fields = c.config["fields"]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    leaks: list = []
    warm = harness.Draws(t, seed, stream=1)
    for _ in range(int(t["warm_forecasts"])):
        _forecast(Simulation, cfg, t, warm(), Spans(), fields, sync, leaks)
    sync()
    setup_s = time.perf_counter() - start

    draws = harness.Draws(t, seed)
    sample = harness.Sample(int(t["check_forecasts"]), seed)
    spans = Spans(traced)
    forecasts, attempted, failed = [], 0, 0
    cap = int(t["trace_forecasts"]) if traced else None
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    launches0 = ops.launch_counts()
    gc0 = _collections()
    w0 = time.perf_counter()
    end = w0 + seconds
    while True:
        params = draws()
        attempted += 1
        t0 = time.perf_counter()
        try:
            snaps, ok, build, steps, io_ms = _forecast(
                Simulation, cfg, t, params, spans, fields, sync, leaks)
        except Exception:  # a forecast that raises is counted, not fatal
            failed += 1
            traceback.print_exc(file=sys.stderr)
        else:
            failed += not ok
            n = len(snaps)
            with spans("forecast"):
                if ok:
                    sample.offer(params, snaps)
                del snaps   # the port's host arrays, freed in its time
            forecasts.append(harness.Forecast(
                seconds=time.perf_counter() - t0, build_s=build,
                steps=steps, snapshots=n, io_ms=io_ms))
        if time.perf_counter() >= end or (cap and attempted >= cap):
            break
    window_s = time.perf_counter() - w0
    host = {"gc_collections": _collections() - gc0,
            "leaked_simulations": len(leaks)}
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = summarise(prof)
        del prof

    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": 1 if cuda else 0,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if cuda else 0}
    if summary is not None and cuda:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    if cuda:
        host.update(harness.card_state())
        torch.cuda.empty_cache()
    checks = harness.check(c, sample.kept, dev)
    return harness.Record(cell=c, setup_s=setup_s, forecasts=forecasts,
                          attempted=attempted, failed=failed,
                          window_s=window_s, launches=launches,
                          trace=summary, checks=checks, device=info,
                          host=host)
