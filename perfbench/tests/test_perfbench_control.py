"""``correct`` comes out false where it must. The control, the reference
computed in bfloat16 in the program's place, fails the cells' limits;
and a run driven with the timed path broken underneath (a step that
returns its state unchanged, an answer altered where it is produced)
reads not correct. On the CPU at a tiny
size; the control at each cell's own size on a card (marked ``cuda``)."""
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import calibrate, harness
from perfbench.drivers import simulation
from perfbench.tests import faults
from perfbench.tests.test_perfbench_rehearsal import ONE_CARD, tiny

ROOT = Path(__file__).resolve().parents[2]


def worst_over_limit(checks: dict) -> float:
    return max(v["value"] / v["limit"] for v in checks.values())


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("seed", [5, 2**31 + 11, 2**40 + 3])
def test_the_control_fails_the_limits(name, seed):
    c = tiny(name)
    # the window's first forecast of this seed, its steps as the cell's
    c.traffic["steps"] = harness.cell(name).traffic["steps"] // 4
    c.traffic["output_interval"] = min(c.traffic["output_interval"],
                                       c.traffic["steps"])
    params = harness.Draws(c.traffic, seed)()
    snaps = calibrate.control_snapshots(c, params, "cpu")
    assert worst_over_limit(harness.check(c, [(params, snaps)], "cpu")) > 1


@pytest.mark.parametrize("name", [n for n in ONE_CARD
                                  if "diag_op_err" in harness.cell(n).limits[
                                      "numbers"]])
@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**41 + 7])
def test_diagnostics_in_bfloat16_fail_their_limit(name, seed):
    """The reference's snapshots with only vorticity and divergence
    rounded to bfloat16, the state left exact: the state's number passes,
    the diagnostics' fails."""
    c = tiny(name)
    params = harness.Draws(c.traffic, seed)()
    snaps = calibrate.control_snapshots(c, params, "cpu", "derived")
    got = harness.check(c, [(params, snaps)], "cpu")
    assert got["diag_op_err"]["value"] > got["diag_op_err"]["limit"]
    assert got["state_rel_err"]["value"] == 0


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("fault", [faults.frozen_step,
                                   faults.altered_answer])
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    from njw_tpu_torch.weather import integrators
    from njw_tpu_torch.weather.model import Simulation

    # put back what the fault replaces
    monkeypatch.setitem(integrators.INTEGRATORS, "rk4",
                        integrators.INTEGRATORS["rk4"])
    monkeypatch.setattr(Simulation, "_store_output",
                        Simulation._store_output)
    c = tiny(name)
    if fault is faults.altered_answer:
        # a field that the cell's first number compares
        fault(next(iter(c.limits["numbers"].values()))["fields"][0])
    else:
        fault()
    rec = simulation.run(c, 2**35 + 1, 0.2, False, time.perf_counter(),
                         device="cpu")
    # no forecast raised or went non-finite, so every finished one was
    # offered to the sample: the check, not a failure, judges the run
    assert rec.failed == 0 and rec.forecasts
    assert rec.checks and worst_over_limit(rec.checks) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_the_control_fails_at_the_cells_size_on_a_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    seeds = ["101", "2147483659", "1099511627779"]
    p = subprocess.run([sys.executable, "perfbench/calibrate.py",
                        "--workload", name, "--control-seeds", *seeds],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    limits = harness.cell(name).limits["numbers"]
    import json

    rows = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == len(seeds)
    for row in rows:
        assert max(row[k] / limits[k]["limit"] for k in limits) > 1, row
