"""The port's benchmark suite, cost models, reports and CLI held against
the JAX package's ``njw_tpu.bench``.

Everything runs on the CPU. The cost models are pure Python in both
packages, so every number is compared for equality, for every shipped
``configs/*.yaml``. Each workload runs at a small size with the same
repeat size (``INNER``) in both packages, from the same start (the JAX
setup's own state where that setup draws random numbers: N-body and MD
draw with threefry, which the port cannot match), and its state after
``execute(repeats=1)`` is held to the JAX workload's at the tolerance of
that workload's port tests: SWE states rtol 1e-5 / atol 1e-6
(test_torch_weather_swe.py), N-body 1e-5 and MD 1e-4 of each field's
largest value (test_torch_nbody.py, test_torch_md.py), FIR outputs
rtol / atol 1e-5 (test_torch_signal.py), FBP and terrain derivatives
1e-5 of the largest value, viewsheds equal (test_torch_medical_ct.py,
test_torch_geospatial_dem.py). The JAX files' own suite, report and CLI
tests run again on the port.
"""
import contextlib
import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import njw_tpu.bench as jb  # noqa: E402
import njw_tpu.bench.cost as jcost  # noqa: E402

import njw_tpu_torch.bench as tb  # noqa: E402
import njw_tpu_torch.bench.cost as tcost  # noqa: E402
from njw_tpu_torch.bench import (  # noqa: E402
    BenchmarkResult, BenchmarkSuite, CloudGPUCostModel, CloudTPUCostModel,
    ComputeEnvironment, CostModelFactory, OnPremTPUCostModel,
    SlurmClusterCostModel, WeatherBenchmark, compare_costs, generate_report,
    load_cost_model,
)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 if "benchmark" not in os.path.basename(p))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(want, got) -> float:
    a = np.asarray(want, np.float64)
    b = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _model_numbers(m) -> dict:
    return {"fields": dataclasses.asdict(m), "hourly": m.hourly_rate(),
            "fixed": m.fixed_cost(), "variable": m.variable_hourly_rate(),
            "cost_of": m.cost_of(1234.5),
            "per_work": m.cost_per_throughput(77.0, 3.5e9)}


class TestCostModelsAgainstJax:
    def test_every_name_exported(self):
        jax_names = {n for n in dir(jb) if not n.startswith("_")}
        port_names = {n for n in dir(tb) if not n.startswith("_")}
        assert jax_names - {"cost", "suite", "report"} <= port_names

    @pytest.mark.parametrize("path", CONFIGS,
                             ids=[os.path.basename(p) for p in CONFIGS])
    def test_shipped_config_equal(self, path):
        j, t = jcost.load_cost_model(path), tcost.load_cost_model(path)
        assert type(j).__name__ == type(t).__name__
        assert _model_numbers(t) == _model_numbers(j)

    @pytest.mark.parametrize("env", [e.value for e in ComputeEnvironment])
    def test_factory_default_equal(self, env):
        assert _model_numbers(tcost.CostModelFactory.create(env)) == \
            _model_numbers(jcost.CostModelFactory.create(env))

    @pytest.mark.parametrize("pair", [("on_prem_tpu", "cloud_tpu"),
                                      ("cloud_tpu", "cloud_gpu"),
                                      ("on_prem_tpu", "cloud_gpu"),
                                      ("slurm_cluster", "local_cpu")])
    def test_compare_costs_equal(self, pair):
        secs = {pair[0]: 100.0, pair[1]: 37.5}
        assert tcost.compare_costs(secs, work=12.0) == \
            jcost.compare_costs(secs, work=12.0)

    def test_break_even_equal(self):
        for a, b in [("on_prem_tpu", "cloud_gpu"), ("cloud_tpu", "local_cpu")]:
            assert tcost.break_even_hours(
                tcost.CostModelFactory.create(a),
                tcost.CostModelFactory.create(b)) == jcost.break_even_hours(
                jcost.CostModelFactory.create(a),
                jcost.CostModelFactory.create(b))


class TestCostModels:
    """tests/test_bench.py's cost-model cases on the port."""

    def test_on_prem_rate_components(self):
        m = OnPremTPUCostModel(node_cost=3600.0, nodes=1, power_watts=1000.0,
                               power_cost_per_kwh=0.1,
                               amortization_months=1.0, utilization=1.0,
                               maintenance_factor=0.0)
        assert m.hourly_rate() == pytest.approx(5.1, rel=1e-6)

    def test_cloud_tpu_spot_discount(self):
        full = CloudTPUCostModel(chips=4, rate_per_chip_hour=1.0)
        spot = CloudTPUCostModel(chips=4, rate_per_chip_hour=1.0,
                                 spot_discount=0.6)
        assert full.hourly_rate() == 4.0
        assert spot.hourly_rate() == pytest.approx(1.6)

    def test_cost_of_seconds(self):
        c = CloudGPUCostModel(rate_per_gpu_hour=3.6).cost_of(1000.0)
        assert c["execution_cost"] == pytest.approx(1.0)
        assert c["currency"] == "USD"

    def test_slurm_overhead(self):
        m = SlurmClusterCostModel(cost_per_node_hour=1.0, nodes=2,
                                  queue_overhead_factor=1.5)
        assert m.hourly_rate() == pytest.approx(3.0)

    def test_factory_unknown_raises(self):
        with pytest.raises(ValueError):
            CostModelFactory.create("mainframe")

    def test_shipped_configs_all_load(self):
        assert len(CONFIGS) >= 6
        envs = {type(load_cost_model(p)).__name__ for p in CONFIGS}
        assert len(envs) >= 4

    def test_h100_config(self):
        m = load_cost_model(os.path.join(REPO, "configs",
                                         "cloud_gpu_h100.yaml"))
        assert isinstance(m, CloudGPUCostModel)
        assert m.instance_type == "h100" and m.hourly_rate() == 6.98

    def test_load_cost_model_overrides_and_unknown_keys(self, tmp_path):
        p = tmp_path / "c.yaml"
        p.write_text("environment: cloud_tpu\nchips: 4\n"
                     "rate_per_chip_hour: 2.0\n")
        assert load_cost_model(str(p), chips=8).hourly_rate() == \
            pytest.approx(16.0)
        p.write_text("environment: cloud_tpu\nbogus_key: 1\n")
        with pytest.raises(ValueError, match="bogus_key"):
            load_cost_model(str(p))
        p.write_text("chips: 4\n")
        with pytest.raises(ValueError, match="environment"):
            load_cost_model(str(p))

    def test_compare_costs(self):
        out = compare_costs({ComputeEnvironment.ON_PREM_TPU: 100.0,
                             ComputeEnvironment.CLOUD_TPU: 50.0})
        assert out["cheapest"] in ("on_prem_tpu", "cloud_tpu")
        assert out["break_even_hours"] is not None
        assert out["break_even_hours"] > 0

    def test_break_even_none_for_pure_hourly_pair(self):
        out = compare_costs({ComputeEnvironment.CLOUD_TPU: 50.0,
                             ComputeEnvironment.CLOUD_GPU: 50.0})
        assert out["break_even_hours"] is None


class TestBenchmarkResult:
    def test_field_names_equal_jax(self):
        names = [f.name for f in dataclasses.fields(BenchmarkResult)]
        assert names == [f.name for f in dataclasses.fields(
            jb.BenchmarkResult)]

    def test_serialization_roundtrip(self):
        r = BenchmarkResult("weather", "cuda:NVIDIA H100 80GB HBM3", 1.5,
                            1000.0, "steps/s",
                            additional_metrics={"grid": 256})
        back = BenchmarkResult.from_dict(json.loads(json.dumps(r.to_dict())))
        assert back == r

    def test_reads_a_jax_result(self):
        j = jb.BenchmarkResult("nbody", "cpu:cpu", 0.5, 2e9,
                               "interactions/s", memory_bytes=64,
                               additional_metrics={"steps_per_repeat": 3})
        t = BenchmarkResult.from_dict(json.loads(json.dumps(j.to_dict())))
        assert t.to_dict() == j.to_dict()

    def test_cost_attachment(self):
        r = BenchmarkResult("x", "cpu", 3600.0, 1.0, "u")
        c = r.calculate_cost_metrics(CloudTPUCostModel(rate_per_chip_hour=2.0))
        assert c["execution_cost"] == pytest.approx(2.0)
        assert r.cost_metrics["execution_cost"] == pytest.approx(2.0)


def _with_jax_start(monkeypatch, name, make):
    """Make the port's factory ``name`` (nbody / md) return ``make()``:
    the port's setup then starts from the JAX setup's state."""
    import njw_tpu_torch.md as tmd
    import njw_tpu_torch.nbody as tnb

    module = tnb if name == "nbody" else tmd
    factory = ("create_random_system" if name == "nbody"
               else "create_lj_fluid")
    monkeypatch.setattr(module, factory, lambda *a, **k: make())


class TestWorkloadsAgainstJax:
    """Each workload's state after execute(1) against the JAX
    workload's, same INNER, same start."""

    def _pair(self, jcls, tcls, inner, **params):
        j, t = jcls(**params), tcls(device=CPU, **params)
        j.INNER = t.INNER = inner
        return j, t

    def test_weather(self):
        j, t = self._pair(jb.WeatherBenchmark, tb.WeatherBenchmark, 2,
                          grid_size=32, num_steps=3)
        js, ts = j.setup(), t.setup()
        j.execute(js, 1)
        t.execute(ts, 1)
        assert ts.step_count == js.step_count == 6
        for name in ("u", "v", "h"):
            np.testing.assert_allclose(getattr(ts.state, name).numpy(),
                                       np.asarray(getattr(js.state, name)),
                                       rtol=1e-5, atol=1e-6)

    def test_nbody(self, monkeypatch):
        from njw_tpu_torch.nbody import convert

        j, t = self._pair(jb.NBodyBenchmark, tb.NBodyBenchmark, 2,
                          num_particles=64, num_steps=3)
        js = j.setup()
        _with_jax_start(monkeypatch, "nbody",
                        lambda: convert.system_from(js.system, device=CPU))
        ts = t.setup()
        j.execute(js, 1)
        t.execute(ts, 1)
        for name in ("pos", "vel"):
            assert _rel(getattr(js.system, name),
                        getattr(ts.system, name)) < 1e-5

    def test_molecular_dynamics(self, monkeypatch):
        from njw_tpu.md import create_lj_fluid as j_lj_fluid
        from njw_tpu_torch.md import convert

        j, t = self._pair(jb.MDBenchmark, tb.MDBenchmark, 1,
                          num_atoms=64, num_steps=5)
        state, topo, lj = j_lj_fluid(64, T0=1.0)
        _with_jax_start(monkeypatch, "md", lambda: (
            convert.state_from(state, device=CPU),
            convert.topology_from(topo, device=CPU),
            convert.lj_from(lj, device=CPU)))
        js, ts = j.setup(), t.setup()
        np.testing.assert_array_equal(np.asarray(js.state.vel),
                                      ts.state.vel.numpy())
        j.execute(js, 1)
        t.execute(ts, 1)
        for name in ("pos", "vel"):
            assert _rel(getattr(js.state, name),
                        getattr(ts.state, name)) < 1e-4

    def test_signal(self):
        # 8 rows of 65536: fir_apply's batch branch (K7's plain version)
        j, t = self._pair(jb.SignalBenchmark, tb.SignalBenchmark, 2,
                          num_samples=65536, batch=8)
        (jx, jf), (tx, tf) = j.setup(), t.setup()
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        j.execute((jx, jf), 1)
        t.execute((tx, tf), 1)
        np.testing.assert_allclose(t.output.numpy(),
                                   np.asarray(j._run(jx, j.INNER)),
                                   rtol=1e-5, atol=1e-5)

    def test_medical(self):
        from njw_tpu.medical import filtered_backprojection

        j, t = self._pair(jb.MedicalBenchmark, tb.MedicalBenchmark, 2,
                          image_size=32, num_angles=24)
        (jsino, angles), (tsino, _) = j.setup(), t.setup()
        assert _rel(jsino, tsino) <= 1e-5
        t.execute((tsino, angles), 1)
        assert _rel(filtered_backprojection(jsino, angles), t.output) <= 1e-5

    def test_geospatial(self):
        from njw_tpu.geospatial import terrain_derivatives, viewshed

        j, t = self._pair(jb.GeospatialBenchmark, tb.GeospatialBenchmark, 2,
                          dem_size=48)
        jdem, tdem = j.setup(), t.setup()
        np.testing.assert_array_equal(np.asarray(jdem), tdem.numpy())
        t.execute(tdem, 1)
        derivs, vis = t.output
        for k, v in terrain_derivatives(jdem).items():
            assert _rel(v, derivs[k]) <= 1e-5
        np.testing.assert_array_equal(
            np.asarray(viewshed(jdem, (24, 24), n_samples=64)), vis.numpy())


SMALL = {"weather": {"grid_size": 32, "num_steps": 2},
         "nbody": {"num_particles": 64, "num_steps": 2},
         "molecular_dynamics": {"num_atoms": 27, "num_steps": 2},
         "signal": {"num_samples": 4096, "batch": 2},
         "medical": {"image_size": 32, "num_angles": 12},
         "geospatial": {"dem_size": 32}}


class TestSuite:
    @pytest.mark.parametrize("name", sorted(SMALL))
    def test_run_reports_a_result(self, name, tmp_path):
        r = BenchmarkSuite(str(tmp_path), device=CPU).run_benchmark(
            name, **SMALL[name])
        assert r.workload == name and r.device == "cpu:cpu"
        assert np.isfinite(r.throughput) and r.throughput > 0
        assert r.execution_time_s > 0
        assert set(r.additional_metrics["kernel_launches"].values()) == {0}
        assert r.throughput_unit == {
            "weather": "steps/s", "nbody": "interactions/s",
            "molecular_dynamics": "atom-steps/s", "signal": "samples/s",
            "medical": "px-angles/s", "geospatial": "cells/s"}[name]

    def test_run_small_benchmarks(self, tmp_path):
        suite = BenchmarkSuite(output_dir=str(tmp_path), device=CPU)
        r1 = suite.run_benchmark("weather", grid_size=64, num_steps=10)
        r2 = suite.run_benchmark("nbody", num_particles=128, num_steps=5)
        assert r1.throughput > 0 and r2.throughput > 0
        path = suite.save_results()
        loaded = BenchmarkSuite.load_results(path)
        assert [r.to_dict() for r in loaded] == [r1.to_dict(), r2.to_dict()]

    def test_unknown_benchmark_raises(self):
        with pytest.raises(ValueError, match="unknown benchmark"):
            BenchmarkSuite(device=CPU).run_benchmark("quantum")

    def test_registry_extension(self, tmp_path):
        suite = BenchmarkSuite(str(tmp_path), device=CPU)

        class Custom(WeatherBenchmark):
            name = "custom"

        suite.register("custom", Custom)
        r = suite.run_benchmark("custom", grid_size=32, num_steps=5)
        assert r.workload == "custom"

    def test_cost_model_integration(self, tmp_path):
        suite = BenchmarkSuite(str(tmp_path), device=CPU)
        r = suite.run_benchmark("signal", num_samples=10_000, batch=2,
                                cost_model=CloudTPUCostModel())
        assert r.cost_metrics["execution_cost"] >= 0

    def test_report_generation(self, tmp_path):
        pytest.importorskip("matplotlib")
        suite = BenchmarkSuite(str(tmp_path), device=CPU)
        suite.run_benchmark("nbody", num_particles=128, num_steps=5)
        suite.run_benchmark("geospatial", dem_size=64)
        path = suite.generate_reports()
        content = open(path).read()
        assert "nbody" in content and "geospatial" in content
        assert os.path.exists(os.path.join(str(tmp_path), "throughput.png"))


class TestReportGenerators:
    """tests/test_bench.py's generator cases on the port."""

    def _results(self):
        return [
            BenchmarkResult(
                "weather", "cuda:H100", 1.5, 1.2e10, "grid-points/s",
                memory_bytes=1 << 24,
                additional_metrics={"energy_joules": 450.0,
                                    "duty_factor": 0.83}),
            BenchmarkResult(
                "nbody", "cuda:H100", 0.8, 3.0e9, "interactions/s",
                memory_bytes=1 << 20,
                additional_metrics={"energy_joules": 210.0,
                                    "duty_factor": 0.71}),
        ]

    def _scaling(self):
        return [{"devices": d, "grid_points_per_second": g,
                 "scaling_efficiency": e}
                for d, g, e in ((1, 1e10, 1.0), (4, 3.6e10, 0.9),
                                (8, 6.4e10, 0.8))]

    def test_full_report_renders_all_generators(self, tmp_path):
        pytest.importorskip("matplotlib")
        path = generate_report(self._results(), str(tmp_path),
                               scaling_rows=self._scaling())
        page = open(path).read()
        for name in ["execution_time.png", "throughput.png", "memory.png",
                     "energy.png", "util.png", "cost.png",
                     "cost_per_op.png", "break_even.png", "scaling.png",
                     "scaling_efficiency.png"]:
            assert os.path.exists(tmp_path / name), name
            assert name in page
        assert "environment cost comparison" in page
        assert "cheapest" in page

    def test_default_environments_are_not_tpus(self):
        from njw_tpu_torch.bench.report import environment_table

        table = environment_table(self._results())
        assert "cloud_gpu" in table and "tpu" not in table

    def test_generators_skip_missing_metrics(self, tmp_path):
        from njw_tpu_torch.bench.report import (
            plot_device_utilization, plot_energy,
        )

        bare = [BenchmarkResult("md", "cpu", 1.0, 1e6, "steps/s")]
        assert plot_energy(bare, str(tmp_path / "e.png")) is None
        assert plot_device_utilization(bare, str(tmp_path / "u.png")) is None

    def test_page_without_matplotlib(self, tmp_path, monkeypatch):
        from njw_tpu_torch.bench import report

        monkeypatch.setattr(report, "_mpl", lambda: None)
        path = generate_report(self._results(), str(tmp_path))
        page = open(path).read()
        assert "weather" in page and "<img" not in page
        assert sorted(os.listdir(tmp_path)) == ["index.html"]

    def test_break_even_chart_marks_crossover(self, tmp_path):
        pytest.importorskip("matplotlib")
        from njw_tpu_torch.bench.report import plot_break_even

        assert os.path.exists(plot_break_even(str(tmp_path / "be.png")))


def _cli(argv) -> tuple[int, list]:
    from njw_tpu_torch.bench.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()]


class TestCLI:
    def test_bench_cli(self, tmp_path):
        rc, rows = _cli(["--workloads", "nbody", "--device", "cpu",
                         "--params",
                         '{"nbody": {"num_particles": 128, "num_steps": 3}}',
                         "--output-dir", str(tmp_path)])
        assert rc == 0
        assert rows[-1]["workload"] == "nbody"
        assert (tmp_path / "results.json").exists()

    def test_cli_cost_config_roundtrip(self, tmp_path):
        cfg = os.path.join(REPO, "configs", "cloud_gpu_h100.yaml")
        rc, rows = _cli(["--workloads", "signal", "--device", "cpu",
                         "--cost-config", cfg, "--params",
                         '{"signal": {"num_samples": 4096, "batch": 2}}',
                         "--output-dir", str(tmp_path)])
        assert rc == 0
        assert rows[0]["cost_metrics"]["hourly_rate"] == pytest.approx(6.98)

    def test_cli_all_with_report(self, tmp_path):
        rc, rows = _cli(["--all", "--device", "cpu", "--cost", "cloud_gpu",
                         "--params", json.dumps(SMALL), "--output-dir",
                         str(tmp_path), "--report"])
        assert rc == 0
        assert [r["workload"] for r in rows] == list(BenchmarkSuite.DEFAULT)
        assert list(rows[0]) == [f.name for f in dataclasses.fields(
            jb.BenchmarkResult)]
        assert (tmp_path / "index.html").exists()

    def test_cli_flags_are_jax_flags_and_device(self):
        import argparse

        from njw_tpu.bench import __main__ as jmain

        seen = {}

        def capture(self, argv=None, namespace=None):
            seen.setdefault("dests", {a.dest for a in self._actions})
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = capture
        try:
            for main in (jmain.main, __import__(
                    "njw_tpu_torch.bench.__main__", fromlist=["main"]).main):
                with pytest.raises(SystemExit):
                    main([])
                seen.setdefault("all", []).append(seen.pop("dests"))
        finally:
            argparse.ArgumentParser.parse_args = orig
        jax_flags, port_flags = seen["all"]
        assert port_flags == jax_flags | {"device"}

