"""What every cell shares: the manifest, the lookup of a cell's files by
name, the forecast window, the check against the reference, the metric
readers and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is names only.
Its configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` and its limits ``limits/<cell>.json``; the
configuration names the driver (``drivers/<driver>.py``) that runs the
port and the reference (``reference/<reference>.py``) that judges it;
each metric is read by ``metrics/<metric>.py``. A later cell or metric
adds files and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "njw_tpu")


# ------------------------------------------------------------ the files

def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(w['name'] for w in bench['workloads'])}")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads(
            (HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def driver(c: Cell):
    return importlib.import_module(f"perfbench.drivers.{c.config['driver']}")


def reference(c: Cell):
    return importlib.import_module(
        f"perfbench.reference.{c.config['reference']}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------- the traffic

class Draws:
    """Initial-condition parameters of each forecast, drawn from the seed:
    a traffic parameter is a number (fixed), {"uniform": [lo, hi]} or
    {"integer": [lo, hi]} (both ends included). ``stream`` separates the
    warm-up forecasts (1) from the window's (0)."""

    def __init__(self, traffic: dict, seed: int, stream: int = 0):
        self.spec = traffic["ic_params"]
        self.rng = np.random.default_rng([int(seed) % 2**63, stream])

    def __call__(self) -> dict:
        out = {}
        for key in sorted(self.spec):
            v = self.spec[key]
            if isinstance(v, dict) and "uniform" in v:
                out[key] = float(self.rng.uniform(*v["uniform"]))
            elif isinstance(v, dict) and "integer" in v:
                lo, hi = v["integer"]
                out[key] = int(self.rng.integers(lo, hi, endpoint=True))
            else:
                out[key] = v
        return out


class Sample:
    """A uniform sample of ``k`` of the window's forecasts, drawn from the
    seed as they complete (reservoir sampling), kept for the check. It
    holds the port's own snapshots and copies nothing: once ``k`` are
    kept, every forecast releases one forecast's host arrays, its own or
    the one it replaces."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.kept: list = []
        self.seen = 0
        self.rng = np.random.default_rng([int(seed) % 2**63, 2])

    def offer(self, params: dict, snaps: list) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((params, snaps))
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.k:
            self.kept[slot] = (params, snaps)


# ------------------------------------------------------------ the record

@dataclasses.dataclass
class Forecast:
    seconds: float        # from the build call until its output can be
    build_s: float        # read and is released; build_s: the build alone
    steps: int
    snapshots: int
    io_ms: float          # the port's own output time (metrics.io_time_ms)


@dataclasses.dataclass
class Record:
    """One run's numbers, for the metric readers."""
    cell: Cell
    setup_s: float
    forecasts: list       # Forecast, the window's finished ones
    attempted: int        # forecasts started in the window
    failed: int           # of those, raised or gave a non-finite field
    window_s: float       # the window's wall time
    launches: dict        # the port's launch counters over the window
    trace: Optional[dict] = None  # trace.summarise
    checks: dict = dataclasses.field(default_factory=dict)
    device: dict = dataclasses.field(default_factory=dict)
    host: dict = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return sum(f.steps for f in self.forecasts)


def card_state() -> dict:
    """The card's clock, power, power limit and temperature as
    ``nvidia-smi`` reads them now ({} where it cannot)."""
    import subprocess

    keys = ("sm_clock_mhz", "max_sm_clock_mhz", "power_w", "power_limit_w",
            "temperature_c")
    try:
        p = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return dict(zip(keys, (float(v) for v in
                               p.stdout.strip().split(","))))
    except (OSError, ValueError, subprocess.SubprocessError):
        return {}


def finite(fields: dict, names) -> bool:
    """Every named host array finite (a float32 sum: a NaN or an
    infinity anywhere makes it non-finite; the fields are far from
    overflow)."""
    return all(np.isfinite(np.add.reduce(fields[n], axis=None))
               for n in names)


# ------------------------------------------------------------ the check

def compare(program: list, ref_snaps, numbers: dict, device,
            own=None) -> dict:
    """{number: worst relative gap}: for each number of ``numbers``
    ({name: {"fields": [...], "against": ...}}), the largest over the
    snapshots and fields of max|program - base| / max|base|. The base is
    the reference's snapshot, or with ``"against": "own_state"`` the
    reference's output function applied in float64 to the program's own
    state of the same snapshot (``own(snapshot)``), which judges what the
    program derives from its state apart from how far the state drifted.
    A snapshot missing, at another step, or not finite reads infinity."""
    import torch

    worst = {name: 0.0 for name in numbers}
    count = 0
    for (step, ref), snap in zip(ref_snaps, program):
        count += 1
        derived = None
        for name, spec in numbers.items():
            if snap.get("step") != step:
                worst[name] = math.inf
                continue
            if spec.get("against") == "own_state":
                if derived is None:
                    derived = own(snap)
                base, dtype = derived, torch.float64
            else:
                base, dtype = ref, torch.float32
            for f in spec["fields"]:
                p = torch.from_numpy(np.ascontiguousarray(snap[f])).to(
                    device).to(dtype)
                r = base[f].to(dtype)
                scale = float(r.abs().max())
                gap = float((p - r).abs().max())
                rel = gap / scale if scale > 0 else (0.0 if gap == 0 else
                                                     math.inf)
                if not math.isfinite(rel):
                    rel = math.inf
                worst[name] = max(worst[name], rel)
                del p
    if count == 0:
        return {name: math.inf for name in numbers}
    return worst


def check(c: Cell, kept: list, device) -> dict:
    """{number: {"value", "limit"}} over the sampled forecasts ``kept``
    ((params, snapshots) pairs), the reference run once over each."""
    import torch

    ref = reference(c)
    numbers = c.limits["numbers"]
    worst = {n: (math.inf if not kept else 0.0) for n in numbers}
    t = c.traffic

    def own(snap):
        state = {k: torch.from_numpy(np.ascontiguousarray(snap[k])).to(
            device).double() for k in ref.FIELDS}
        return ref.outputs(state, c.config["sim"])

    expected = -(-t["steps"] // t["output_interval"])
    for params, snaps in kept:
        if len(snaps) != expected:
            worst = {n: math.inf for n in numbers}
            continue
        gen = ref.snapshots(c.config["sim"], t["ic"], params, t["steps"],
                            t["output_interval"], device)
        got = compare(snaps, gen, numbers, device, own)
        worst = {n: max(worst[n], got[n]) for n in numbers}
    return {n: {"value": worst[n], "limit": numbers[n]["limit"]}
            for n in numbers}


# ---------------------------------------------------------- the result

def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def metrics(record: Record, traced: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (untraced)
    or per-layer metrics (traced); a reader that finds nothing to read
    returns None and its metric is left out."""
    c = record.cell
    on_card = record.device.get("platform") == "gpu"
    out = {}
    for m in (c.per_layer if traced else c.end_to_end):
        if m["source"] == "device_trace" and not on_card:
            continue    # never a number of another device under its name
        value = reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(record: Record, traced: bool) -> int:
    """Print the result line (and the numbers compared, last on standard
    error); return the exit code."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found} "
              "(JAX or the JAX package); no result", file=sys.stderr)
        return 3
    checks = record.checks
    correct = bool(checks) and record.failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": record.attempted,
              "failed": record.failed,
              "metrics": metrics(record, traced), "device": record.device}
    if traced and record.trace and record.device.get("platform") == "gpu":
        from perfbench import trace

        result["breakdown"] = trace.breakdown(record.trace)
    result["host"] = record.host
    result["checks"] = {k: {"value": _number(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    result["checks"]["failed_forecasts"] = {"value": record.failed,
                                            "limit": 0}
    print(json.dumps(result), flush=True)
    if record.steps:
        print("launches a step by the port's counters: " + json.dumps(
            {k: v / record.steps for k, v in record.launches.items() if v}),
            file=sys.stderr)
    print("host over the window: " + json.dumps(record.host),
          file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


def _number(x: float):
    """A finite reading as it is; a non-finite one as its name ("inf",
    "nan"), which every JSON reader takes."""
    return float(x) if math.isfinite(x) else str(float(x))
