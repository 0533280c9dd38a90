"""The four-card cell (``drivers/process_mesh.py``) rehearsed on the CPU:
four processes over gloo at a tiny size on the kernel backend's plain
path, its manifest entries, the padded K5's bytes, faults planted in one
rank that read not correct, and a rank that raises, which ends the run."""
import json
import math
import time

import pytest

from perfbench import harness
from perfbench.cost import k5_shard, pe, peaks
from perfbench.drivers import process_mesh

CELL = "pe2048x40.mesh2x2"
MINE = ("exchange.mb_per_step", "exchange.exposed_ms_per_step",
        "kernel.k5_shard_roofline_pct", "mesh.step_mfu")


def tiny() -> harness.Cell:
    c = harness.cell(CELL)
    c.config["sim"].update(grid_width=48, grid_height=32, num_levels=4,
                           backend="kernel")
    c.traffic.update(steps=6, output_interval=3, warm_forecasts=1,
                     check_forecasts=2, trace_forecasts=3)
    return c


def _run(seed, traced=False, plant="", seconds=0.5):
    return process_mesh.run(tiny(), seed, seconds, traced,
                            time.perf_counter(), device="cpu", plant=plant)


def test_the_manifest_takes_one_four_card_cell():
    bench = harness.manifest()
    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert four == [CELL]
    c = harness.cell(CELL)
    assert c.config["mesh"] == [2, 2] and c.chips == 4
    assert {m["name"] for m in c.per_layer} == set(MINE)


def test_k5_shard_counts_the_padded_block():
    c = harness.cell(CELL)
    padded = (4 * 40 + 1) * 1026 * 1026 * 4
    inner = (4 * 40 + 1) * 1024 * 1024 * 4
    assert k5_shard.padded_bytes(c.config) == padded
    assert pe.state_bytes(c.config) == inner
    assert k5_shard.launch_bound_s(c.config, 0) == pytest.approx(
        (padded + inner) / peaks.HBM_BYTES_PER_S)
    assert k5_shard.step_bound_s(c.config) == pytest.approx(
        (4 * padded + 9 * inner) / peaks.HBM_BYTES_PER_S)
    assert k5_shard.bound_s(c.config, 400) == pytest.approx(
        100 * k5_shard.step_bound_s(c.config))


@pytest.mark.parametrize("traced", [False, True])
def test_a_gloo_rehearsal_reads_correct(traced, capsys):
    rec = _run(2**33 + 17, traced)
    assert harness.emit(rec, traced) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    # float32 rounding of 6 steps (tests/test_torch_weather_mesh.py)
    assert res["checks"]["state_rel_err"]["value"] < 1e-4
    assert res["attempted"] == len(rec.forecasts) >= 1
    parts = rec.host["setup_parts_s"]
    assert {"spawn", "imports", "device", "process_group", "kernel_load",
            "warm1.build", "warm1.rest", "other"} <= set(parts)
    assert sum(parts.values()) == pytest.approx(rec.setup_s)
    if traced:
        # 4 stages a step, each sends one column and one row of the
        # (4, 16, 24) block's 17 planes both ways
        mb = res["metrics"]["exchange.mb_per_step"]["value"]
        assert mb == pytest.approx(4 * (2 * 16 + 2 * 26) * 17 * 4 / 1e6)
    else:
        assert set(res["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["shifted_halo_column",
                                   "altered_snapshot"])
def test_a_fault_in_one_rank_reads_not_correct(fault):
    rec = _run(2**35 + 1, plant=f"perfbench.tests.mesh_faults:{fault}")
    check = rec.checks["state_rel_err"]
    assert rec.failed == 0 and check["value"] > check["limit"]


def test_a_rank_that_raises_ends_the_run():
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="rank 2 exited"):
        _run(2**36 + 9, seconds=30,
             plant="perfbench.tests.mesh_faults:raises_in_the_window")
    assert time.monotonic() - t0 < 60
    assert not math.isnan(t0)
