"""The readers of the port's own spans (``program_span`` metrics that
read ``njw_tpu_torch.utils.profiling.spans()``), rehearsed on the CPU at
a tiny size in each cell that lists them: a number in a traced run, the
run's own spans when a process holds several, and None from a port that
keeps none. A cell lists a reader only if it reports its metric."""
import math
import time

import pytest

from perfbench import harness
from perfbench.drivers import simulation
from perfbench.tests.test_perfbench_rehearsal import tiny

READERS = ("dispatch.enqueue_us_per_step", "output.d2h_gbps",
           "driver.state_ms", "forecast.outside_port_ms")


def listed(name: str) -> list:
    """The readers that the cell ``name`` reports."""
    return [m["name"] for m in harness.cell(name).per_layer
            if m["name"] in READERS]


CELLS = [w["name"] for w in harness.manifest()["workloads"]
         if listed(w["name"])]


def _traced(name: str, seed: int) -> harness.Record:
    return simulation.run(tiny(name), seed, 0.3, True, time.perf_counter(),
                          device="cpu")


def test_the_readers_are_the_manifests():
    """Each reader is listed by one cell or more, each a one-card cell
    that the forecast loop of ``drivers/simulation.py`` runs."""
    for name in READERS:
        (m,) = [m for m in harness.manifest()["per_layer"]
                if m["name"] == name]
        assert m["source"] == "program_span" and m["moves"] == "step_ms"
        cells = [harness.cell(n) for n in CELLS if name in listed(n)]
        assert cells, name
        for c in cells:
            assert c.chips == 1 and c.config["driver"] == "simulation", (
                name, c.name)


@pytest.mark.parametrize("name", CELLS)
def test_each_reader_reads_a_traced_run(name):
    rec = _traced(name, 2**33 + 101)
    assert rec.failed == 0 and rec.forecasts
    for metric in listed(name):
        value = harness.reader(metric).read(rec)
        assert value is not None and math.isfinite(value), metric
        assert value > 0 or metric == "forecast.outside_port_ms", metric


@pytest.mark.parametrize("name", CELLS)
def test_a_second_traced_run_reads_its_own_spans(name):
    from njw_tpu_torch.utils import profiling

    _traced(name, 2**34 + 3)
    rec = _traced(name, 2**34 + 7)
    spans = profiling.spans()
    assert sum(s.name == "sim.build" for s in spans) == len(rec.forecasts)
    assert sum(s.counters["steps"] for s in spans
               if s.name == "sim.step.enqueue") == rec.steps
    assert sum(s.name == "sim.output.copy" for s in spans) == sum(
        f.snapshots for f in rec.forecasts)


@pytest.mark.parametrize("missing", ["no spans", "no reader of spans"])
def test_none_without_the_ports_spans(missing, monkeypatch):
    """A run that kept no span, and a port older than
    ``profiling.spans``, give no number."""
    from njw_tpu_torch.utils import profiling

    rec = _traced(CELLS[0], 2**35 + 1)
    if missing == "no spans":
        monkeypatch.setattr(profiling, "spans", list)
    else:
        monkeypatch.delattr(profiling, "spans")
    for metric in READERS:
        assert harness.reader(metric).read(rec) is None, metric


def test_none_where_a_forecast_failed():
    rec = _traced(CELLS[0], 2**35 + 9)
    rec.failed = 1
    assert harness.reader("forecast.outside_port_ms").read(rec) is None
