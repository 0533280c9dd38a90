"""The harness rehearsed on the CPU at a tiny size: the forecast loop of
each cell, the metric readers, the trace's reading on made-up device
activity, and the command's refusal without a card.

A cell's tiny size (``tiny``) is a 40 x 32 grid, 4 levels where the
configuration has ``num_levels``, on the port's plain path. A
configuration's file may hold a ``"rehearsal"`` object, the ``sim`` keys
to use instead at the rehearsal: ``{"grid_width": 64, "grid_height": 32}``
for a core that takes only a 2:1 grid."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.drivers import simulation

ROOT = Path(__file__).resolve().parents[2]
ONE_CARD = [w["name"] for w in harness.manifest()["workloads"]
            if w["chips"] == 1]


def tiny(name: str, bench=None) -> harness.Cell:
    """The cell at a tiny size, on the port's plain path (the kernels'
    plain versions alias the state they hand to a CPU snapshot)."""
    c = harness.cell(name, bench)
    c.config["sim"].update(grid_width=40, grid_height=32, backend="plain")
    if "num_levels" in c.config["sim"]:
        c.config["sim"]["num_levels"] = 4
    c.config["sim"].update(c.config.get("rehearsal", {}))
    t = c.traffic
    ratio = t["steps"] // t["output_interval"]
    t["steps"] = 5 * ratio if ratio > 1 else 6
    t["output_interval"] = 5 if ratio > 1 else 6
    t["warm_forecasts"] = 1
    t["trace_forecasts"] = 3
    return c


def test_tiny_takes_a_configurations_rehearsal(tmp_path):
    """A made-up configuration that names its rehearsal's grid."""
    bench = harness.manifest()
    entry = next(w for w in bench["workloads"] if w["name"] == ONE_CARD[0])
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    made_up = json.loads((ROOT / conf["file"]).read_text())
    made_up["rehearsal"] = {"grid_width": 64, "grid_height": 32}
    path = tmp_path / "made_up.json"
    path.write_text(json.dumps(made_up))
    bench["configs"].append({**conf, "name": "made_up", "file": str(path)})
    entry["config"] = "made_up"
    sim = tiny(ONE_CARD[0], bench).config["sim"]
    assert (sim["grid_width"], sim["grid_height"]) == (64, 32)
    assert sim["backend"] == "plain"
    assert sim.get("num_levels", 4) == 4
    plain = tiny(ONE_CARD[0]).config["sim"]
    assert (plain["grid_width"], plain["grid_height"]) == (40, 32)


def emitted(record, traced, capsys) -> dict:
    assert harness.emit(record, traced) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("traced", [False, True])
def test_forecast_loop_on_the_cpu(name, traced, capsys):
    c = tiny(name)
    rec = simulation.run(c, 2**33 + 17, 0.3, traced, time.perf_counter(),
                         device="cpu")
    res, err = emitted(rec, traced, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == len(rec.forecasts) >= 1
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"] and "breakdown" not in res
    names = set(res["metrics"])
    device = {m["name"] for m in c.per_layer + c.end_to_end
              if m["source"] == "device_trace"}
    # no CPU number under a device metric
    assert not names & device
    # every metric the cell reports that the CPU can read
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)
            if m["source"] != "device_trace"}
    assert names == want and names
    assert list(res)[-1] == "checks"
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in last)


def test_the_window_holds_every_forecast_and_no_simulation_outlives_it():
    """step_ms is the window's wall time, which covers every forecast's
    time, and each simulation is freed when its forecast releases it."""
    c = tiny(ONE_CARD[0])
    rec = simulation.run(c, 2**34 + 5, 0.3, False, time.perf_counter(),
                         device="cpu")
    assert rec.host["leaked_simulations"] == 0
    assert rec.window_s >= sum(f.seconds for f in rec.forecasts) > 0
    assert harness.reader("step_ms").read(rec) == pytest.approx(
        1e3 * rec.window_s / rec.steps)
    assert set(rec.host) == {"gc_collections", "leaked_simulations"}


class _Event:
    def __init__(self, name, start, dur, cuda):
        import torch

        self._n, self._s, self._d = name, start, dur
        self._t = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {
            "events": lambda self_: events})()


def test_trace_reading_on_made_up_activity():
    ms = 1_000_000
    events = [
        _Event("bench.forecast", 0, 100 * ms, False),
        _Event("bench.build", 0, 10 * ms, False),
        _Event("bench.steps", 10 * ms, 60 * ms, False),
        _Event("bench.output", 70 * ms, 30 * ms, False),
        _Event("bench.forecast", 200 * ms, 50 * ms, False),
        _Event("void swe_rk4_kernel<1, false>(Args)", 12 * ms, 20 * ms, True),
        _Event("void swe_rk4_kernel<1, false>(Args)", 30 * ms, 20 * ms, True),
        _Event("Memcpy DtoH (Device -> Pageable)", 75 * ms, 5 * ms, True),
        _Event("elementwise_kernel", 210 * ms, 10 * ms, True),
        _Event("elementwise_kernel", 120 * ms, 10 * ms, True),  # outside
        # the host spans' projections on the device's timeline
        _Event("bench.forecast", 1 * ms, 99 * ms, True),
        _Event("bench.steps", 12 * ms, 38 * ms, True),
    ]
    s = trace.summarise(_Prof(events))
    assert s["window_s"] == pytest.approx(0.150)
    assert s["busy_s"] == pytest.approx(0.053)
    assert s["kernels"] == 3
    assert s["by_kernel"]["swe_rk4_kernel"] == [2, pytest.approx(0.040)]
    idle = s["idle_by_span"]
    assert idle["build"] == pytest.approx(0.010)
    assert idle["steps"] == pytest.approx(0.002 + 0.020)
    assert sum(idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert idle["output"] == pytest.approx(0.025)
    assert idle["forecast"] == pytest.approx(0.040)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "swe_rk4_kernel"
    assert len(b["idle_gaps"]) <= 10


def test_the_command_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        ONE_CARD[0], "--seed", str(2**31 + 9), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_the_command_refuses_without_the_port(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone holds no
    program to run."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        ONE_CARD[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
