"""The forecast loop on a mesh of cards, one rank a card, on the port's
public entry: ``Simulation.from_config(config, ic, mesh=ProcessMesh(py,
px), **params)``, where each rank builds and steps its own block of the
domain (``njw_tpu_torch.weather.primitive``).

``run`` (the parent) starts the configuration's ``mesh`` py x px ranks
as processes of their own (``python -m perfbench.drivers.process_mesh``),
watches them and returns rank 0's record. Each rank runs the loop of
``drivers/simulation.py``: ``warm_forecasts`` forecasts, then whole
forecasts one after another for ``seconds``, the forecast in flight
ending the window. Rank 0's clock decides the window's end, and after
each forecast one all-reduce hands every rank that decision and whether
any rank's part of the forecast was not finite. The ranks share the
host's cores: each takes its share for torch's threads, and reads its
last snapshot once with them to see that it is finite (``_finite``). The
warm-up holds one forecast's snapshots while the next runs, as the
window holds the check's sample beside the forecast in flight, so the
window makes no new pinned host blocks. ``--trace 1`` traces rank 0
alone. Set-up runs from ``run.py``'s first line (``start``, on the clock
every process of the machine shares) to rank 0's first timed forecast;
``host["setup_parts_s"]`` splits it.

The check: each rank works out the reference of its own block of the
sampled forecasts over the block's dependence cone
(``perfbench/reference/cone.py``), and the ranks' largest gaps and
magnitudes are combined by an all-reduce, so the number is that of the
whole field.

Nothing may hang: the process group and every collective have a deadline
(``DEADLINE_S``), a rank that exits with an error has the others killed at
once, and the whole run has ``seconds + BUDGET_S``. Then the run ends
with no result and a non-zero exit.
"""
from __future__ import annotations

import time

FIRST = time.perf_counter()

import datetime  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from perfbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
DEADLINE_S = 120      # the process group's start and each collective
BUDGET_S = 420        # the rest of a run beside its window


# ------------------------------------------------------------ the parent

def run(c: harness.Cell, seed: int, seconds: float, traced: bool,
        start: float, device: str = "cuda",
        plant: str = "") -> harness.Record:
    """Rank 0's record of a run of cell ``c`` on ``mesh`` ranks (CUDA:
    one card each, NCCL; "cpu": gloo). ``plant``: "module:function" that
    each rank calls with its rank before the run (tests plant faults)."""
    py, px = c.config["mesh"]
    world = py * px
    with tempfile.TemporaryDirectory(prefix="perfbench-mesh-") as tmp:
        spec = dict(cell=c, seed=seed, seconds=seconds, traced=traced,
                    start=start, device=device, world=world, plant=plant)
        (Path(tmp) / "run.pkl").write_bytes(pickle.dumps(spec))
        env = dict(os.environ, NCCL_SOCKET_IFNAME="lo",
                   GLOO_SOCKET_IFNAME="lo")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        # the ranks write to standard error: the result line is the
        # parent's alone on standard output
        procs = [subprocess.Popen(
            [sys.executable, "-m", "perfbench.drivers.process_mesh", tmp,
             str(r)], cwd=ROOT, env=env, stdout=2) for r in range(world)]
        try:
            _watch(procs, time.monotonic() + seconds + BUDGET_S)
        finally:
            _kill(procs)
        return pickle.loads((Path(tmp) / "record.pkl").read_bytes())


def _watch(procs: list, deadline: float) -> None:
    """Wait for every rank; one that fails, or the deadline, ends the
    run (``SystemExit``, non-zero, no result)."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, rc) for r, rc in enumerate(codes) if rc not in (None, 0)]
        if bad:
            raise SystemExit(f"perfbench: rank {bad[0][0]} exited with "
                             f"{bad[0][1]}; the others were stopped; no "
                             "result")
        if all(rc == 0 for rc in codes):
            return
        if time.monotonic() > deadline:
            raise SystemExit("perfbench: the ranks outran the run's "
                             "deadline and were stopped; no result")
        time.sleep(0.05)


def _kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


# ------------------------------------------------------------- a rank

class _OnMesh:
    """``Simulation`` whose ``from_config`` is handed the mesh."""

    def __init__(self, Simulation, mesh):
        self.Simulation, self.mesh = Simulation, mesh

    def from_config(self, cfg, ic, **params):
        return self.Simulation.from_config(cfg, ic, mesh=self.mesh, **params)


def _die_with_parent() -> None:
    """SIGKILL this rank if the parent dies (Linux ``prctl``)."""
    import ctypes

    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank(tmp: str, rank: int) -> None:
    _die_with_parent()
    spec = pickle.loads((Path(tmp) / "run.pkl").read_bytes())
    c, start = spec["cell"], spec["start"]
    parts = {"spawn": FIRST - start}
    import torch
    import torch.distributed as dist

    from njw_tpu_torch import ops
    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.parallel import ProcessMesh
    from njw_tpu_torch.weather.model import SimConfig, Simulation
    from perfbench.drivers.simulation import _collections, _forecast
    from perfbench.trace import Spans, summarise

    t = time.perf_counter()
    parts["imports"] = t - start - parts["spawn"]
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // spec["world"]))
    cuda = spec["device"] == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(rank)
    flags = torch.zeros(2, device=dev)
    parts["device"] = time.perf_counter() - t
    t = time.perf_counter()

    kw = dict(backend="nccl" if cuda else "gloo",
              init_method=f"file://{tmp}/store", rank=rank,
              world_size=spec["world"],
              timeout=datetime.timedelta(seconds=DEADLINE_S))
    if cuda:
        kw["device_id"] = dev    # the communicator made now, not lazily
    dist.init_process_group(**kw)
    dist.all_reduce(flags)
    parts["process_group"] = time.perf_counter() - t
    if spec["plant"]:
        mod, fn = spec["plant"].split(":")
        getattr(importlib.import_module(mod), fn)(rank)

    py, px = c.config["mesh"]
    mesh = ProcessMesh(py, px, device="cuda" if cuda else "cpu")
    entry = _OnMesh(Simulation, mesh)
    cfg = SimConfig(**c.config["sim"], device=spec["device"])
    tr, fields = c.traffic, c.config["fields"]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def forecast(params, spans):
        snaps, ok, build, steps, io_ms = _forecast(
            entry, cfg, tr, params, spans, (), sync, leaks)
        with spans("forecast"):
            ok = ok and _finite(snaps[-1], fields, torch)
        return snaps, ok, build, steps, io_ms

    # set-up: the warm-up forecasts, the kernel's load timed apart
    loads = [0.0]
    load = _build.load

    def timed_load(name):
        t0 = time.perf_counter()
        try:
            return load(name)
        finally:
            loads[0] += time.perf_counter() - t0

    leaks: list = []
    warm = harness.Draws(tr, spec["seed"], stream=1)
    _build.load = timed_load
    try:
        held = snaps = None
        for i in range(int(tr["warm_forecasts"])):
            t0 = time.perf_counter()
            snaps, _, build, _, _ = forecast(warm(), Spans())
            held = snaps   # the one before is let go only now
            parts[f"warm{i + 1}.build"] = build
            parts[f"warm{i + 1}.rest"] = time.perf_counter() - t0 - build
        del held, snaps
    finally:
        _build.load = load
    parts["kernel_load"] = loads[0]
    parts["warm1.rest"] = parts.get("warm1.rest", 0.0) - loads[0]
    sync()
    dist.all_reduce(flags)
    setup_s = time.perf_counter() - start
    parts["other"] = setup_s - sum(parts.values())

    # the window
    lead = rank == 0
    draws = harness.Draws(tr, spec["seed"])
    sample = harness.Sample(int(tr["check_forecasts"]), spec["seed"])
    spans = Spans(spec["traced"] and lead)
    forecasts, attempted, failed = [], 0, 0
    cap = int(tr["trace_forecasts"]) if spec["traced"] else None
    prof = None
    if spec["traced"] and lead:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    launches0 = ops.launch_counts()
    gc0 = _collections()
    w0 = time.perf_counter()
    end = w0 + spec["seconds"]
    while True:
        params = draws()
        attempted += 1
        t0 = time.perf_counter()
        snaps, ok, build, steps, io_ms = forecast(params, spans)
        stop = lead and (time.perf_counter() >= end
                         or bool(cap and attempted >= cap))
        flags.copy_(torch.tensor([float(stop), float(not ok)]))
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        stop, bad = (bool(v) for v in flags.tolist())
        failed += bad
        n = len(snaps)
        with spans("forecast"):
            if not bad:
                sample.offer(params, snaps)
            del snaps
        forecasts.append(harness.Forecast(
            seconds=time.perf_counter() - t0, build_s=build, steps=steps,
            snapshots=n, io_ms=io_ms))
        if stop:
            break
    window_s = time.perf_counter() - w0
    host = {"gc_collections": _collections() - gc0,
            "leaked_simulations": len(leaks)}
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = summarise(prof)
        if summary is not None:
            summary.update(_exchange_sums(prof))
        del prof

    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": spec["world"] if cuda else 0,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if cuda else 0}
    if summary is not None and cuda:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    if cuda:
        host.update(harness.card_state())
        torch.cuda.empty_cache()
    host["setup_parts_s"] = parts
    checks = _check(c, sample.kept, mesh, dev, torch, dist)
    if lead:
        rec = harness.Record(cell=c, setup_s=setup_s, forecasts=forecasts,
                             attempted=attempted, failed=failed,
                             window_s=window_s, launches=launches,
                             trace=summary, checks=checks, device=info,
                             host=host)
        tmp_rec = Path(tmp) / "record.tmp"
        tmp_rec.write_bytes(pickle.dumps(rec))
        os.replace(tmp_rec, Path(tmp) / "record.pkl")
    dist.destroy_process_group()


def _finite(snap: dict, names, torch) -> bool:
    """``harness.finite`` on torch's threads: every named host array's
    float32 sum finite."""
    return all(bool(torch.isfinite(torch.from_numpy(snap[n]).sum()))
               for n in names)


def _exchange_sums(prof) -> dict:
    """What the per-layer readers of the halo exchange read, from this
    rank's trace and the port's spans (which live in this process):
    ``exchange_steps``, the steps of the ``sim.step`` spans;
    ``exchange_bytes``, the bytes of the ``sim.step.exchange`` spans; and
    ``exchange_exposed_s``, the device time inside the ``sim.step`` spans
    in which a NCCL kernel ran and no other kernel, copy or set did."""
    import torch

    from njw_tpu_torch.utils import profiling
    from perfbench.trace import PREFIX, _clip, _union

    spans = getattr(profiling, "spans", list)()
    steps = [s for s in spans if s.name == "sim.step" and s.end is not None]
    cuda = torch.autograd.DeviceType.CUDA
    nccl, other = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cuda or name.startswith(PREFIX):
            continue
        a = e.start_ns()
        (nccl if "nccl" in name.lower() else other).append(
            [a, a + e.duration_ns()])
    windows = _union([[s.start, s.end] for s in steps])
    comm = _union(_clip(_union(nccl), windows))
    busy = _union(other)
    exposed = sum(b - a for a, b in comm) \
        - sum(b - a for a, b in _clip(busy, comm))
    return {"exchange_exposed_s": exposed / 1e9,
            "exchange_steps": sum(s.counters.get("steps", 0) for s in steps),
            "exchange_bytes": sum(s.counters["exchange_bytes"] for s in spans
                                  if s.name == "sim.step.exchange")}


def _check(c: harness.Cell, kept: list, mesh, dev, torch, dist) -> dict:
    """{number: {"value", "limit"}} over the sampled forecasts, every
    rank's block against the reference of that block; every rank takes
    part, rank 0's answer is the run's."""
    from perfbench.reference import cone

    ref = harness.reference(c)
    numbers = c.limits["numbers"]
    t = c.traffic
    expected = -(-t["steps"] // t["output_interval"])
    names = list(numbers)
    width = max(len(numbers[n]["fields"]) for n in names)
    # per sampled forecast, snapshot, number and field: [gap, scale]
    worst = torch.zeros((max(len(kept), 1), expected, len(names), width, 2),
                        device=dev, dtype=torch.float64)
    for i, (params, snaps) in enumerate(kept):
        block = snaps[0]["block"] if snaps else None
        gen = cone.block_snapshots(ref, c.config["sim"], t["ic"], params,
                                   t["steps"], t["output_interval"], block,
                                   dev) if block else iter(())
        got = list(zip(gen, snaps))
        for j in range(expected):
            if j >= len(got) or got[j][1].get("step") != got[j][0][0] or \
                    len(snaps) != expected:
                worst[i, j, :, :, 0] = math.inf
                continue
            (_, r), snap = got[j]
            for n, name in enumerate(names):
                for f, field in enumerate(numbers[name]["fields"]):
                    p = torch.from_numpy(snap[field]).to(dev).float()
                    gap = float((p - r[field]).abs().max())
                    worst[i, j, n, f] = torch.tensor(
                        [gap if math.isfinite(gap) else math.inf,
                         float(r[field].abs().max())])
        del got, gen
    if not kept:
        worst[..., 0] = math.inf
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    out = {}
    for n, name in enumerate(names):
        gap, scale = worst[..., n, :, 0], worst[..., n, :, 1]
        rel = torch.where(scale > 0, gap / scale,
                          torch.where(gap == 0, 0.0, math.inf))
        value = float(rel.max())
        out[name] = {"value": value if math.isfinite(value) else math.inf,
                     "limit": numbers[name]["limit"]}
    return out


if __name__ == "__main__":
    _rank(sys.argv[1], int(sys.argv[2]))
    gc.collect()
