"""The port's geo-financial integration (risk factors, aggregation,
climate, scenarios, multi-region, data, test data, realtime, batch
planning) held against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds, or built once in JAX and
carried across by ``njw_tpu_torch.geofinancial.convert``, so both
packages compute on the same portfolio. Tolerances: the NumPy copies
(aggregation, climate, scenarios and their analysis layer, multi-region,
test data, the data files) bit for bit; the elevation and flood factors
and ``assess_risk`` on them exactly (fill_sinks and the flows are
bit-equal to JAX's), the slope factor within 1e-5 (measured 1.2e-7).
Files written by either package load in the other. The JAX file's own
tests (tests/test_geofinancial.py) run again on the port.
"""
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import njw_tpu.geofinancial as J  # noqa: E402
from njw_tpu.geofinancial import multiregion as jmr  # noqa: E402
from njw_tpu.geofinancial import testdata as jtd  # noqa: E402

import njw_tpu_torch.geofinancial as T  # noqa: E402
from njw_tpu_torch.geofinancial import convert  # noqa: E402
from njw_tpu_torch.geofinancial import multiregion as tmr  # noqa: E402
from njw_tpu_torch.geofinancial import testdata as ttd  # noqa: E402
from njw_tpu_torch.geofinancial.main_paths import (  # noqa: E402
    analysis, risk_model,
)
from njw_tpu_torch.geospatial.convert import geo_transform_fields  # noqa: E402

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(a, b):
    """Equal bit for bit: arrays, floats, dicts and lists of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


def dem64():
    yy, xx = np.mgrid[0:64, 0:64] / 64
    return (30 * yy + 5 * np.sin(6 * xx)).astype(np.float32)


def _assets(p):
    p.add_asset("low1", "Low 1", 100.0, 32.0, 5.0,
                {"asset_class": "real_estate", "carbon_intensity": 0.8})
    p.add_asset("low2", "Low 2", 200.0, 10.0, 8.0,
                {"asset_class": "coastal", "carbon_intensity": 0.2})
    p.add_asset("high1", "High 1", 150.0, 40.0, 60.0,
                {"asset_class": "default", "carbon_intensity": 0.1})
    return p


def portfolio():
    """Assets: low-elevation (risky) at small y, high ground at large y."""
    return _assets(T.GeospatialPortfolio())


def both_portfolios(n=60, seed=4, extent=48.0):
    """A clustered book made in JAX and carried across."""
    jport = J.generate_assets(n, extent=extent, seed=seed)
    for i, a in enumerate(jport.assets):
        a.metadata["asset_class"] = ("real_estate", "coastal",
                                     "default")[i % 3]
        a.metadata["carbon_intensity"] = (i % 7) / 7.0
    return jport, convert.portfolio_from(jport)


DEM48 = J.generate_dem(48, seed=5)


def both_models():
    jm = J.GeospatialRiskModel([
        J.create_flood_risk_factor(DEM48),
        J.create_elevation_risk_factor(DEM48, weight=0.5),
        J.create_slope_risk_factor(DEM48, weight=0.25)])
    return jm, convert.risk_model_from(jm)


# ------------------------------------------------------------- factors

class TestFactorsAgainstJax:
    def test_elevation_exact(self):
        for low in (True, False):
            assert_same(T.create_elevation_risk_factor(DEM48,
                                                       low_is_risky=low)
                        .risk_data,
                        J.create_elevation_risk_factor(DEM48,
                                                       low_is_risky=low)
                        .risk_data)

    @pytest.mark.parametrize("cell", [1.0, 2.5])
    def test_slope_within_1e5(self, cell):
        want = J.create_slope_risk_factor(DEM48, cell_size=cell).risk_data
        got = T.create_slope_risk_factor(DEM48, cell_size=cell,
                                         device=CPU).risk_data
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-5

    @pytest.mark.parametrize("n_iterations", [8, 32, 128])
    def test_flood_exact(self, n_iterations):
        want = J.create_flood_risk_factor(DEM48, n_iterations=n_iterations)
        got = T.create_flood_risk_factor(DEM48, n_iterations=n_iterations,
                                         device=CPU)
        assert_same(got.risk_data, want.risk_data)
        assert (got.name, got.description) == (want.name, want.description)

    def test_flood_from_a_tensor_stays_on_its_device(self):
        got = T.create_flood_risk_factor(torch.from_numpy(DEM48.copy()))
        assert_same(got.risk_data, J.create_flood_risk_factor(DEM48)
                    .risk_data)

    def test_assess_risk_on_the_factors(self):
        jport, tport = both_portfolios()
        jm = J.GeospatialRiskModel([J.create_flood_risk_factor(DEM48),
                                    J.create_elevation_risk_factor(DEM48)])
        tm = T.GeospatialRiskModel([
            T.create_flood_risk_factor(DEM48, device=CPU),
            T.create_elevation_risk_factor(DEM48)])
        assert_same(tport.assess_risk(tm), jport.assess_risk(jm))
        assert tport.expected_loss(tm) == jport.expected_loss(jm)
        assert tport.value_at_risk(tm, 0.4) == jport.value_at_risk(jm, 0.4)

    def test_sample_and_transform(self):
        gt = T.geo_risk.GeoTransform(origin_x=10.0, origin_y=60.0,
                                     pixel_width=2.0, pixel_height=-1.5)
        jgt = J.geo_risk.GeoTransform(**geo_transform_fields(gt))
        data = np.random.default_rng(1).uniform(-0.2, 1.2, (20, 30))
        x = np.random.default_rng(2).uniform(0, 80, 50)
        y = np.random.default_rng(3).uniform(20, 70, 50)
        assert_same(T.SpatialRiskFactor("r", 1.0, data, gt).sample(x, y),
                    J.SpatialRiskFactor("r", 1.0, data, jgt).sample(x, y))


# --------------------------------------------------- NumPy copies, bits

RISKS = np.random.default_rng(5).uniform(size=(4, 40))


class TestAggregationBitEqual:
    @pytest.mark.parametrize("method", [m.value for m in J.AggregationMethod])
    @pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5, 3.0]])
    def test_aggregate(self, method, weights):
        corr = np.full((4, 4), 0.3) + 0.7 * np.eye(4)
        assert_same(T.RiskAggregator(method, corr).aggregate(RISKS, weights),
                    J.RiskAggregator(method, corr).aggregate(RISKS, weights))
        assert_same(T.RiskAggregator(method).aggregate(RISKS[0]),
                    J.RiskAggregator(method).aggregate(RISKS[0]))

    def test_correlation_and_surface(self):
        assert_same(T.RiskAggregator.correlation_matrix(RISKS),
                    J.RiskAggregator.correlation_matrix(RISKS))
        xs, ys = RISKS[1] * 64, RISKS[2] * 64
        for power in (1.0, 2.0, 3.0):
            assert_same(T.RiskSurfaceGenerator(power).generate(
                xs, ys, RISKS[3], (24, 20), (0, 64, 0, 48)),
                J.RiskSurfaceGenerator(power).generate(
                    xs, ys, RISKS[3], (24, 20), (0, 64, 0, 48)))


class TestClimateBitEqual:
    @pytest.mark.parametrize("scenario", [s.value for s in J.ClimateScenario])
    @pytest.mark.parametrize("horizon", [h.value for h in J.TimeHorizon])
    def test_assessor(self, scenario, horizon):
        jport, tport = both_portfolios()
        temp = np.random.default_rng(6).normal(30, 4, (48, 48))
        out = []
        for M, port in ((J, jport), (T, tport)):
            a = M.ClimateRiskAssessor(scenario, horizon)
            a.add_hazard("sea_level_rise",
                         M.create_sea_level_rise_factor(DEM48, rise_m=20.0))
            a.add_hazard("heatwave", M.create_heatwave_risk_factor(temp))
            a.set_transition_risk("policy", 0.5)
            a.set_transition_risk("market", 0.3)
            out.append([a.scale, a.physical_risk(port),
                        a.transition_risk(port), a.combined_risk(port, 0.7),
                        a.expected_portfolio_loss(port)])
        assert_same(out[1], out[0])

    def test_factors(self):
        temp = np.random.default_rng(7).normal(30, 4, (16, 16))
        for rise in (0.5, 2.0):
            assert_same(T.create_sea_level_rise_factor(dem64(), rise)
                        .risk_data,
                        J.create_sea_level_rise_factor(dem64(), rise)
                        .risk_data)
        assert_same(T.create_heatwave_risk_factor(temp).risk_data,
                    J.create_heatwave_risk_factor(temp).risk_data)


def _analyzers():
    jport, tport = both_portfolios()
    jm, tm = both_models()
    return J.ScenarioAnalyzer(jport, jm), T.ScenarioAnalyzer(tport, tm)


SETS = ("create_climate_scenarios", "create_economic_scenarios",
        "create_stress_scenarios")


class TestScenariosBitEqual:
    @pytest.mark.parametrize("factory", SETS)
    def test_sets_and_var(self, factory):
        ja, ta = _analyzers()
        jset = getattr(J, factory)()
        tset = getattr(T, factory)()
        assert_same(convert.scenario_set_from(jset).scenarios, tset.scenarios)
        assert_same(ta.evaluate_set(tset), ja.evaluate_set(jset))
        for c in (0.5, 0.95, 0.99):
            assert ta.var(tset, c) == ja.var(jset, c)

    def test_analysis_layer(self):
        ja, ta = _analyzers()
        for a, M in ((ja, J), (ta, T)):
            flood = M.Scenario("flood", risk_multipliers={"flood_risk": 1.5})
            crash = M.Scenario("crash", value_shocks={"default": 0.2,
                                                      "coastal": 0.3})
            a.analyze_scenario(M.Scenario("base"))
            a.analyze_scenario(flood)
            a.out = [
                a.compare_scenarios(["base", "flood"]),
                a.perform_sensitivity_analysis("elevation_risk",
                                               [0.5, 1.0, 2.0]),
                a.perform_stress_test([flood, crash], combination_levels=2),
                M.ScenarioAnalyzer.combine_scenarios([flood, crash]),
            ]
        assert_same(ta.out[:3], ja.out[:3])
        assert_same(vars(ta.out[3]), vars(ja.out[3]))
        assert_same(ta.scenario_results, ja.scenario_results)

    def test_export_results_across_packages(self, tmp_path):
        ja, ta = _analyzers()
        for a, M in ((ja, J), (ta, T)):
            a.analyze_scenario(M.Scenario("base"))
            a.perform_stress_test([M.Scenario("hot", risk_multipliers={
                "flood_risk": 2.0})])
        pj = ja.export_results(str(tmp_path / "j" / "r.json"))
        pt = ta.export_results(str(tmp_path / "t" / "r.json"))
        assert Path(pj).read_bytes() == Path(pt).read_bytes()
        assert "asset_risks" not in json.loads(Path(pt).read_text())["base"]


class TestMultiRegionBitEqual:
    def _models(self):
        jport, tport = both_portfolios()
        jm, tm = both_models()
        grids = (jmr.make_region_grid(0, 48, 0, 48, 3, 2),
                 tmr.make_region_grid(0, 48, 0, 48, 3, 2))
        assert_same([vars(r) for r in grids[1]],
                    [vars(convert.region_from(r)) for r in grids[0]])
        out = []
        for M, mr_mod, port, m, grid in ((J, jmr, jport, jm, grids[0]),
                                         (T, tmr, tport, tm, grids[1])):
            mrm = M.MultiRegionRiskModel()
            for region in grid[:-1]:      # one region left uncovered
                mrm.add_region(region, m)
            out.append((M, mrm, M.RegionalPortfolio(port, grid), port))
        return out

    def test_assess_rank_and_analysis(self):
        res = []
        for M, mrm, rp, port in self._models():
            rr = mrm.assess_regional_risks(port)
            res.append([
                mrm.assess(port), rr,
                mrm.identify_high_risk_assets(rr, 0.3, top_n=4),
                mrm.calculate_diversification_benefit(rr, rp),
                mrm.perform_cross_region_analysis(rp, 0.3, 5),
                [M.RegionalRiskComparator(mrm).rank(port, by)
                 for by in ("expected_loss", "mean_risk")]])
        assert_same(res[1], res[0])

    def test_split_and_region_of(self):
        (_, _, jrp, _), (_, _, trp, _) = self._models()
        assert_same({k: [a.id for a in v.assets]
                     for k, v in trp.split().items()},
                    {k: [a.id for a in v.assets]
                     for k, v in jrp.split().items()})
        assert [trp.region_of(a) for a in trp.portfolio.assets] == \
            [jrp.region_of(a) for a in jrp.portfolio.assets]


class TestTestDataBitEqual:
    def test_dem_assets_returns(self):
        assert_same(T.generate_dem(40, roughness=0.3, relief=50.0, seed=3),
                    J.generate_dem(40, roughness=0.3, relief=50.0, seed=3))
        ja = J.generate_assets(25, extent=100.0, n_clusters=3, seed=2)
        ta = T.generate_assets(25, extent=100.0, n_clusters=3, seed=2)
        assert_same(convert.portfolio_fields(ta),
                    convert.portfolio_fields(convert.portfolio_from(ja)))
        r = J.generate_returns(7, 90, seed=4)
        assert_same(T.generate_returns(7, 90, seed=4), r)
        assert_same(ttd.generate_price_series(r, 50.0),
                    jtd.generate_price_series(r, 50.0))

    def test_cli_writes_the_same_files(self, tmp_path):
        argv = ["--size", "24", "--assets", "5", "--days", "7", "--seed",
                "3"]
        assert jtd.main(["--out", str(tmp_path / "j")] + argv) == 0
        out = subprocess.run(
            [sys.executable, "-m", "njw_tpu_torch.geofinancial.testdata",
             "--out", str(tmp_path / "t")] + argv, cwd=REPO,
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        for name in ("assets.csv", "returns.csv"):
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()
        dj, tj = (np.load(tmp_path / d / "dem.npz") for d in "jt")
        assert_same({k: dj[k] for k in dj.files},
                    {k: tj[k] for k in tj.files})


# ------------------------------------------------- files across packages

class TestFilesAcrossPackages:
    @pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
    def test_asset_csv(self, tmp_path, writer, reader):
        port = writer.generate_assets(9, extent=60.0, seed=3)
        p = writer.AssetLocationDataLoader.save_asset_csv(
            port, str(tmp_path / "a.csv"))
        back = reader.AssetLocationDataLoader.load_asset_csv(p)
        mine = writer.AssetLocationDataLoader.load_asset_csv(p)
        assert_same(convert.portfolio_fields(convert.portfolio_from(back)),
                    convert.portfolio_fields(convert.portfolio_from(mine)))

    @pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
    def test_geojson(self, tmp_path, writer, reader):
        port = writer.generate_assets(6, extent=50.0, seed=4)
        risks = {a.id: i / 6 for i, a in enumerate(port.assets)}
        p = writer.export_portfolio_geojson(port, str(tmp_path / "a.json"),
                                            risks)
        other = (T if writer is J else J).export_portfolio_geojson(
            port, str(tmp_path / "b.json"), risks)
        assert Path(p).read_bytes() == Path(other).read_bytes()
        back = reader.AssetLocationDataLoader.load_asset_geojson(p)
        assert [(a.id, a.value, a.x, a.y, a.metadata) for a in back.assets] \
            == [(a.id, a.value, a.x, a.y, {"risk": risks[a.id]})
                for a in port.assets]

    @pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
    def test_dem_npz(self, tmp_path, writer, reader):
        dem = J.generate_dem(20, seed=6)
        gt = writer.geo_risk.GeoTransform(origin_x=5.0, origin_y=7.0,
                                          pixel_width=0.5, pixel_height=2.0)
        p = writer.GeoRiskDataLoader.save_dem(str(tmp_path / "d.npz"), dem,
                                              gt)
        back, t = reader.GeoRiskDataLoader.load_dem(p)
        assert_same(back, dem)
        assert (t.origin_x, t.origin_y, t.pixel_width, t.pixel_height) == \
            (5.0, 7.0, 0.5, 2.0)
        rf = reader.GeoRiskDataLoader.load_raster_as_risk_factor(
            p, "flood", 2.0, invert=True, description="d")
        want = J.GeoRiskDataLoader.load_raster_as_risk_factor(
            p, "flood", 2.0, invert=True, description="d")
        assert_same(rf.risk_data, want.risk_data)

    def test_returns_csv_and_attach(self, tmp_path):
        files = ttd.generate_dataset(str(tmp_path), size=24, n_assets=5,
                                     n_days=12, seed=5)
        jr = J.FinancialDataLoader.load_returns_csv(files["returns"])
        tr = T.FinancialDataLoader.load_returns_csv(files["returns"])
        assert_same(tr, jr)
        jport = J.AssetLocationDataLoader.load_asset_csv(files["assets"])
        tport = T.AssetLocationDataLoader.load_asset_csv(files["assets"])
        assert T.FinancialDataLoader.attach_returns_to_assets(tport, tr) == \
            J.FinancialDataLoader.attach_returns_to_assets(jport, jr) == 5
        assert_same([a.metadata for a in tport.assets],
                    [a.metadata for a in jport.assets])
        prices = np.array([[100.0, 50.0], [110.0, 49.0], [99.0, 52.0]])
        for log in (False, True):
            assert_same(T.FinancialDataLoader.calculate_returns_from_prices(
                prices, log), J.FinancialDataLoader
                .calculate_returns_from_prices(prices, log))

    @pytest.mark.parametrize("writer,reader", [(jmr, tmr), (tmr, jmr)])
    def test_regional_portfolio(self, tmp_path, writer, reader):
        M = J if writer is jmr else T
        port = M.generate_assets(8, extent=40.0, seed=7)
        port.assets[0].returns = np.array([0.01, -0.02])
        rp = writer.RegionalPortfolio(port, writer.make_region_grid(
            0, 40, 0, 40, 2, 2))
        p = rp.save(str(tmp_path / "sub" / "rp.json"))
        back = reader.RegionalPortfolio.load(p)
        again = writer.RegionalPortfolio.load(p)
        assert_same(convert.portfolio_fields(convert.portfolio_from(
            back.portfolio)), convert.portfolio_fields(
            convert.portfolio_from(again.portfolio)))
        assert [vars(r) for r in back.regions] == \
            [vars(r) for r in again.regions]
        back.save(str(tmp_path / "b.json"))
        assert (tmp_path / "b.json").read_bytes() == Path(p).read_bytes()


class TestConvert:
    def test_portfolio_both_ways(self):
        jport, tport = both_portfolios(12)
        jport.assets[1].returns = np.array([0.01, 0.02, -0.01])
        tport = convert.portfolio_from(jport)
        back = J.GeospatialPortfolio()
        for a in convert.portfolio_fields(tport)["assets"]:
            back.add_asset(a["id"], a["name"], a["value"], a["x"], a["y"],
                           a["metadata"], a["returns"])
        assert_same(convert.portfolio_fields(convert.portfolio_from(back)),
                    convert.portfolio_fields(tport))
        np.testing.assert_array_equal(tport.assets[1].returns,
                                      jport.assets[1].returns)
        assert tport.assets[0].returns is None
        tport.assets[0].metadata["x"] = 1
        tport.assets[1].returns[0] = 9.0
        assert "x" not in jport.assets[0].metadata   # copies
        assert jport.assets[1].returns[0] == 0.01

    def test_risk_factor_and_model_both_ways(self):
        jm, tm = both_models()
        for jrf, trf in zip(jm.risk_factors, tm.risk_factors):
            f = convert.risk_factor_fields(trf)
            back = J.SpatialRiskFactor(
                f["name"], f["risk_weight"], f["risk_data"],
                J.geo_risk.GeoTransform(**f["geo_transform"]),
                f["description"])
            assert_same(vars(convert.risk_factor_from(back)), vars(trf))
            assert_same(trf.risk_data, jrf.risk_data)
            assert trf.geo_transform == T.geo_risk.IDENTITY_TRANSFORM
        assert convert.risk_model_from({"risk_factors": [
            convert.risk_factor_fields(tm.risk_factors[0])]}) \
            .risk_factors[0].name == "flood_risk"

    def test_scenario_set_and_region_from_dicts(self):
        s = convert.scenario_set_from({"name": "x", "scenarios": [
            {"name": "a", "risk_multipliers": {"f": 2.0},
             "probability": 0.3}]})
        assert (s.name, s.scenarios[0].risk_multipliers,
                s.scenarios[0].value_shocks, s.scenarios[0].probability) == \
            ("x", {"f": 2.0}, {}, 0.3)
        r = convert.region_from({"name": "r", "x_min": 0, "x_max": 1,
                                 "y_min": 2, "y_max": 3})
        assert vars(r) == vars(T.RegionDefinition("r", 0, 1, 2, 3))


class TestPipeline:
    def test_example_analysis_equals_jax(self):
        """examples/geofinancial_example.py's pipeline at 64^2, 80 assets,
        both packages on the same inputs."""
        dem = J.generate_dem(64, seed=11)
        jport = J.generate_assets(80, extent=64.0, seed=11)
        jm = J.GeospatialRiskModel([
            J.create_flood_risk_factor(dem, weight=1.0),
            J.create_elevation_risk_factor(dem, weight=0.5)])
        tm = risk_model(dem, CPU)
        for a, b in zip(tm.risk_factors, jm.risk_factors):
            assert_same(a.risk_data, b.risk_data)
        got = analysis(convert.portfolio_from(jport), tm, 64.0, (2, 2))
        assert_same(got["risks"], jm.assess_risk(*jport.coords()))
        assert got["expected_loss"] == jport.expected_loss(jm)
        ja = J.ScenarioAnalyzer(jport, jm)
        for name, res in got["scenario_sets"].items():
            sset = getattr(J, f"create_{name}_scenarios")()
            agg = ja.evaluate_set(sset)
            assert res["expected_loss"] == agg["expected_loss"]
            assert res["var"] == {c: ja.var(sset, c) for c in res["var"]}
        mrm = J.MultiRegionRiskModel()
        for region in jmr.make_region_grid(0.0, 64.0, 0.0, 64.0, 2, 2):
            mrm.add_region(region, jm)
        assert got["regions"] == J.RegionalRiskComparator(mrm).rank(jport)


# ------------------------------------------ the JAX tests, on the port

class TestRiskFactors:
    def test_elevation_factor_orders_assets(self):
        rf = T.create_elevation_risk_factor(dem64())
        risks = portfolio().assess_risk(T.GeospatialRiskModel([rf]))
        assert risks["low1"] > risks["high1"]
        assert 0.0 <= min(risks.values()) and max(risks.values()) <= 1.0

    def test_slope_and_flood_factors_build(self):
        for rf in (T.create_slope_risk_factor(dem64(), device=CPU),
                   T.create_flood_risk_factor(dem64(), n_iterations=32,
                                              device=CPU)):
            assert rf.risk_data.shape == (64, 64)
            assert 0.0 <= rf.risk_data.min() and rf.risk_data.max() <= 1.0

    def test_weighted_combination(self):
        flat = T.SpatialRiskFactor("a", 1.0, np.full((8, 8), 0.2))
        hot = T.SpatialRiskFactor("b", 3.0, np.full((8, 8), 1.0))
        model = T.GeospatialRiskModel([flat, hot])
        r = model.assess_risk(np.asarray([4.0]), np.asarray([4.0]))
        assert r[0] == pytest.approx((0.2 + 3.0) / 4.0, abs=1e-5)

    def test_value_at_risk_and_expected_loss(self):
        model = T.GeospatialRiskModel([T.create_elevation_risk_factor(
            dem64())])
        p = portfolio()
        assert 0 <= p.value_at_risk(model, threshold=0.5) <= p.total_value
        assert 0 <= p.expected_loss(model) <= p.total_value


class TestAggregation:
    RISKS = np.asarray([[0.2, 0.8], [0.4, 0.6], [0.0, 1.0]])

    @pytest.mark.parametrize("method", list(T.AggregationMethod))
    def test_methods_bounded(self, method):
        out = T.RiskAggregator(method).aggregate(self.RISKS)
        assert out.shape == (2,)
        assert (out >= 0).all() and (out <= 1).all()

    def test_maximum_dominates_average(self):
        avg = T.RiskAggregator(T.AggregationMethod.WEIGHTED_AVERAGE) \
            .aggregate(self.RISKS)
        mx = T.RiskAggregator(T.AggregationMethod.MAXIMUM).aggregate(
            self.RISKS)
        assert (mx >= avg - 1e-12).all()

    def test_product_method(self):
        out = T.RiskAggregator(T.AggregationMethod.PRODUCT).aggregate(
            np.asarray([[0.5], [0.5]]))
        assert out[0] == pytest.approx(0.75)

    def test_correlation_matrix(self):
        C = T.RiskAggregator.correlation_matrix(
            np.random.default_rng(0).uniform(size=(3, 50)))
        assert C.shape == (3, 3)
        np.testing.assert_allclose(np.diag(C), 1.0)

    def test_surface_interpolates_toward_points(self):
        surf = T.RiskSurfaceGenerator().generate(
            [10.0, 50.0], [10.0, 50.0], [0.0, 1.0], (32, 32), (0, 64, 0, 64))
        assert surf[25, 25] > 0.8 and surf[5, 5] < 0.2


class TestClimate:
    def _assessor(self):
        a = T.ClimateRiskAssessor(T.ClimateScenario.PESSIMISTIC,
                                  T.TimeHorizon.LONG)
        a.add_hazard(T.ClimateHazardType.SEA_LEVEL_RISE,
                     T.create_sea_level_rise_factor(dem64(), rise_m=2.0))
        return a

    def test_physical_risk_scaled_by_scenario(self):
        p = portfolio()
        pess = self._assessor().physical_risk(p)
        opt = T.ClimateRiskAssessor(T.ClimateScenario.OPTIMISTIC,
                                    T.TimeHorizon.SHORT)
        opt.add_hazard(T.ClimateHazardType.SEA_LEVEL_RISE,
                       T.create_sea_level_rise_factor(dem64(), rise_m=2.0))
        assert pess["low1"] >= opt.physical_risk(p)["low1"]

    def test_transition_risk_uses_carbon_intensity(self):
        t = self._assessor().transition_risk(portfolio())
        assert t["low1"] > t["high1"]

    def test_combined_and_expected_loss(self):
        a = self._assessor()
        p = portfolio()
        assert set(a.combined_risk(p)) == {"low1", "low2", "high1"}
        assert 0 <= a.expected_portfolio_loss(p) <= p.total_value


def _elev_analyzer():
    model = T.GeospatialRiskModel([T.create_elevation_risk_factor(dem64())])
    return T.ScenarioAnalyzer(portfolio(), model)


class TestScenarios:
    def test_multiplier_increases_loss(self):
        an = _elev_analyzer()
        base = an.evaluate(T.Scenario("base"))
        hot = an.evaluate(T.Scenario(
            "hot", risk_multipliers={"elevation_risk": 2.0}))
        assert hot["total_loss"] >= base["total_loss"]

    def test_value_shock_applies_to_class(self):
        an = _elev_analyzer()
        shocked = an.evaluate(T.Scenario(
            "re", value_shocks={"real_estate": 0.5}))
        assert shocked["total_loss"] > an.evaluate(
            T.Scenario("base"))["total_loss"]

    def test_factory_sets_and_var(self):
        an = _elev_analyzer()
        for sset in (T.create_climate_scenarios(),
                     T.create_economic_scenarios(),
                     T.create_stress_scenarios()):
            res = an.evaluate_set(sset)
            assert res["expected_loss"] >= 0
            assert res["worst_loss"] >= res["expected_loss"] - 1e-9
        assert an.var(T.create_economic_scenarios(), 0.95) >= 0


class TestMultiRegion:
    def test_assess_and_rank(self):
        model = T.GeospatialRiskModel([T.create_elevation_risk_factor(
            dem64())])
        mr = T.MultiRegionRiskModel()
        mr.add_region(T.RegionDefinition("south", 0, 64, 0, 32), model) \
            .add_region(T.RegionDefinition("north", 0, 64, 32, 64), model)
        summary = mr.assess(portfolio())
        assert summary["south"]["n_assets"] == 2
        assert summary["north"]["n_assets"] == 1
        assert T.RegionalRiskComparator(mr).rank(portfolio())[0][0] == \
            "south"

    def test_region_grid(self):
        grid = tmr.make_region_grid(0, 100, 0, 100, 2, 2)
        assert len(grid) == 4
        assert grid[0].contains(10, 10)


class TestRealtime:
    def test_market_stream_delivers_prices(self):
        got = []
        stream = T.MarketDataStream(["AAA", "BBB"], interval_s=0.02)
        stream.subscribe(lambda p: got.append(p))
        stream.start()
        time.sleep(0.15)
        stream.stop()
        assert not stream.running
        assert len(got) >= 2
        assert set(got[0]["prices"]) == {"AAA", "BBB"}

    def test_event_stream_and_bad_subscriber_isolated(self):
        got = []
        stream = T.GeospatialEventStream(interval_s=0.02, event_rate=2.0)
        stream.subscribe(lambda p: (_ for _ in ()).throw(RuntimeError()))
        stream.subscribe(lambda p: got.append(p))
        stream.start()
        time.sleep(0.12)
        stream.stop()
        assert len(got) >= 2
        assert all("events" in p for p in got)

    def test_streams_fetch_the_same_as_jax(self):
        jm, tm = (J.MarketDataStream(["A", "B"], seed=3),
                  T.MarketDataStream(["A", "B"], seed=3))
        je, te = (J.GeospatialEventStream(event_rate=3.0, seed=4),
                  T.GeospatialEventStream(event_rate=3.0, seed=4))
        for _ in range(5):
            assert tm.fetch()["prices"] == jm.fetch()["prices"]
            assert te.fetch()["events"] == je.fetch()["events"]


class TestOptimizer:
    def test_batch_and_tile_sizes_aligned(self):
        opt = T.TPUOptimizer(device=CPU)
        bs = opt.optimal_batch_size(1024)
        assert bs % 128 == 0 and bs >= 128
        assert opt.optimal_tile_size(512 * 512) % 128 == 0

    def test_batched_assessment_matches_direct(self):
        model = T.GeospatialRiskModel([T.create_elevation_risk_factor(
            dem64())])
        p = portfolio()
        direct = p.assess_risk(model)
        batched = T.TPUOptimizer(device=CPU).batched_risk_assessment(
            p, model, batch_size=2)
        for k in direct:
            assert batched[k] == pytest.approx(direct[k], abs=1e-6)

    def test_benchmark_metrics(self):
        model = T.GeospatialRiskModel([T.create_elevation_risk_factor(
            dem64())])
        m = T.TPUOptimizer(device=CPU).benchmark(portfolio(), model,
                                                 n_repeats=1)
        assert m["assets"] == 3 and m["assets_per_second"] > 0
        assert m["device"] == "cpu"

    def test_cpu_budget_equals_jax(self):
        """Both packages take a 4 GB budget on the CPU."""
        t, j = T.TPUOptimizer(device=CPU), J.TPUOptimizer()
        for b in (4, 1024, 10 ** 6):
            assert t.optimal_batch_size(b) == j.optimal_batch_size(b)
        assert t.optimal_tile_size(5000) == j.optimal_tile_size(5000)


class TestDataConnectors:
    def test_asset_csv_roundtrip(self, tmp_path):
        port = T.generate_assets(12, extent=100.0, seed=3)
        p = T.AssetLocationDataLoader.save_asset_csv(
            port, str(tmp_path / "assets.csv"))
        back = T.AssetLocationDataLoader.load_asset_csv(p)
        assert len(back.assets) == 12
        assert back.total_value == pytest.approx(port.total_value, rel=1e-6)

    def test_asset_geojson(self, tmp_path):
        port = T.generate_assets(5, extent=50.0, seed=4)
        p = T.export_portfolio_geojson(port, str(tmp_path / "a.geojson"))
        assert json.load(open(p))["type"] == "FeatureCollection"
        assert len(T.AssetLocationDataLoader.load_asset_geojson(p).assets) \
            == 5

    def test_returns_csv_and_attach(self, tmp_path):
        files = T.generate_dataset(str(tmp_path), size=32, n_assets=6,
                                   n_days=30, seed=5)
        returns = T.FinancialDataLoader.load_returns_csv(files["returns"])
        assert len(returns) == 6
        assert next(iter(returns.values())).shape == (30,)
        port = T.AssetLocationDataLoader.load_asset_csv(files["assets"])
        assert T.FinancialDataLoader.attach_returns_to_assets(port,
                                                              returns) == 6
        assert "volatility" in port.assets[0].metadata

    def test_returns_from_prices(self):
        prices = np.array([100.0, 110.0, 99.0])
        r = T.FinancialDataLoader.calculate_returns_from_prices(prices)
        np.testing.assert_allclose(r, [0.1, -0.1], atol=1e-6)
        rl = T.FinancialDataLoader.calculate_returns_from_prices(
            prices, log_returns=True)
        np.testing.assert_allclose(rl, np.log([1.1, 0.9]), atol=1e-6)

    def test_dem_npz_risk_factor(self, tmp_path):
        dem = T.generate_dem(32, seed=6)
        p = T.GeoRiskDataLoader.save_dem(str(tmp_path / "dem.npz"), dem)
        back, _ = T.GeoRiskDataLoader.load_dem(p)
        np.testing.assert_allclose(back, dem)
        rf = T.GeoRiskDataLoader.load_raster_as_risk_factor(
            p, "flood", invert=True)
        assert rf.risk_data.min() >= 0.0 and rf.risk_data.max() <= 1.0
        lo = np.unravel_index(np.argmin(dem), dem.shape)
        assert rf.risk_data[lo] > 0.9


class TestTestDataGenerator:
    def test_assets_clustered_and_seeded(self):
        a = T.generate_assets(30, extent=200.0, n_clusters=3, seed=7)
        b = T.generate_assets(30, extent=200.0, n_clusters=3, seed=7)
        assert [x.value for x in a.assets] == [x.value for x in b.assets]
        assert len({x.metadata["cluster"] for x in a.assets}) <= 3

    def test_returns_shape_and_correlation(self):
        r = T.generate_returns(8, 500, market_beta=0.9, seed=8)
        assert r.shape == (500, 8)
        c = np.corrcoef(r.T)
        assert c[~np.eye(8, dtype=bool)].mean() > 0.5

    def test_price_series(self):
        r = T.generate_returns(2, 10, seed=9)
        p = ttd.generate_price_series(r, p0=50.0)
        assert p.shape == (11, 2)
        np.testing.assert_allclose(p[0], 50.0)
        np.testing.assert_allclose(p[1], 50.0 * (1 + r[0]), rtol=1e-5)

    def test_cli_writes_dataset(self, tmp_path):
        assert ttd.main(["--out", str(tmp_path / "d"), "--size", "32",
                         "--assets", "4", "--days", "5"]) == 0
        assert os.path.exists(tmp_path / "d" / "assets.csv")


class TestScenarioAnalysisLayer:
    def test_analyze_scenario_caches_and_structures(self):
        an = _elev_analyzer()
        res = an.analyze_scenario(T.Scenario("base"))
        assert "base" in an.scenario_results
        assert set(res["statistics"]) >= {
            "mean", "std", "min", "max", "value_weighted_risk"}
        assert res["economic_impact"]["el_ratio"] <= 1.0
        assert len(res["asset_risks"]) == 3

    def test_compare_scenarios_deltas(self):
        an = _elev_analyzer()
        an.analyze_scenario(T.Scenario("base"))
        an.analyze_scenario(T.Scenario(
            "hot", risk_multipliers={"elevation_risk": 2.0}))
        cmp_ = an.compare_scenarios(["base", "hot"], "base")
        row = cmp_["statistics_comparison"]["hot"]["mean"]
        assert row["abs_diff"] >= 0
        assert row["scenario"] == pytest.approx(
            row["baseline"] + row["abs_diff"])
        econ = cmp_["economic_comparison"]["hot"]["expected_loss"]
        assert econ["scenario"] >= econ["baseline"]

    def test_compare_unanalyzed_raises(self):
        with pytest.raises(ValueError, match="not been analyzed"):
            _elev_analyzer().compare_scenarios(["nope"])

    def test_sensitivity_curve_monotone(self):
        sens = _elev_analyzer().perform_sensitivity_analysis(
            "elevation_risk", [0.5, 1.0, 1.5, 2.0])
        assert len(sens["expected_losses"]) == 4
        assert (np.diff(sens["expected_losses"]) >= -1e-9).all()
        assert sens["comparison"]["baseline"] == sens["scenarios"][0]

    def test_stress_test_with_combinations(self):
        flood = T.Scenario("flood", risk_multipliers={"elevation_risk": 1.5})
        crash = T.Scenario("crash", value_shocks={
            "default": 0.2, "real_estate": 0.3, "coastal": 0.2})
        st = _elev_analyzer().perform_stress_test([flood, crash],
                                                  combination_levels=2)
        assert st["combinations"] == ["combo_flood_crash"]
        m = st["metrics"]
        assert m["combo_flood_crash"]["expected_loss"] >= \
            max(m["flood"]["expected_loss"],
                m["crash"]["expected_loss"]) - 1e-9
        assert m["baseline"]["expected_loss"] <= \
            m["flood"]["expected_loss"] + 1e-9

    def test_combine_scenarios_composition_rules(self):
        a = T.Scenario("a", risk_multipliers={"f": 1.5},
                       value_shocks={"c": 0.5})
        b = T.Scenario("b", risk_multipliers={"f": 2.0},
                       value_shocks={"c": 0.5})
        c = T.ScenarioAnalyzer.combine_scenarios([a, b])
        assert c.risk_multipliers["f"] == pytest.approx(3.0)
        assert c.value_shocks["c"] == pytest.approx(0.75)

    def test_export_results_roundtrips(self, tmp_path):
        an = _elev_analyzer()
        an.analyze_scenario(T.Scenario("base"))
        path = an.export_results(str(tmp_path / "sub" / "res.json"))
        data = json.loads(open(path).read())
        assert "base" in data
        assert "asset_risks" not in data["base"]
        assert data["base"]["statistics"]["mean"] >= 0


class TestMultiRegionAnalysisLayer:
    def _setup(self):
        model = T.GeospatialRiskModel([T.create_elevation_risk_factor(
            dem64())])
        mr = T.MultiRegionRiskModel()
        south = T.RegionDefinition("south", 0, 64, 0, 32)
        north = T.RegionDefinition("north", 0, 64, 32, 64)
        mr.add_region(south, model).add_region(north, model)
        return mr, T.RegionalPortfolio(portfolio(), [south, north])

    def test_assess_regional_risks_groups_assets(self):
        mr, rp = self._setup()
        rr = mr.assess_regional_risks(rp.portfolio)
        assert set(rr) == {"south", "north"}
        assert set(rr["south"]) == {"low1", "low2"}
        assert set(rr["north"]) == {"high1"}

    def test_identify_high_risk_assets_threshold_and_topn(self):
        mr, rp = self._setup()
        rr = mr.assess_regional_risks(rp.portfolio)
        high = mr.identify_high_risk_assets(rr, threshold=0.5)
        assert {a["asset_id"] for a in high["south"]} == {"low1", "low2"}
        assert high["north"] == []
        capped = mr.identify_high_risk_assets(rr, threshold=0.0, top_n=1)
        assert len(capped["south"]) == 1
        assert capped["south"][0]["risk_score"] == max(rr["south"].values())

    def test_diversification_benefit_bounds(self):
        mr, rp = self._setup()
        rr = mr.assess_regional_risks(rp.portfolio)
        assert -1.0 <= mr.calculate_diversification_benefit(rr, rp) <= 1.0

    def test_cross_region_analysis_structure(self):
        mr, rp = self._setup()
        res = mr.perform_cross_region_analysis(rp, threshold=0.5)
        assert res["statistics"]["south"]["n_assets"] == 2
        corr = np.asarray(res["risk_correlations"]["matrix"])
        assert corr.shape == (2, 2)
        assert np.allclose(np.diag(corr), 1.0)
        alloc = res["recommended_allocation"]
        assert sum(alloc.values()) == pytest.approx(1.0)
        assert alloc["north"] > alloc["south"]

    def test_save_load_roundtrip(self, tmp_path):
        _, rp = self._setup()
        rp.portfolio.assets[0].returns = np.array([0.01, -0.02])
        back = T.RegionalPortfolio.load(rp.save(str(tmp_path / "rp.json")))
        assert [a.id for a in back.portfolio.assets] == \
            [a.id for a in rp.portfolio.assets]
        assert [r.name for r in back.regions] == ["south", "north"]
        np.testing.assert_allclose(back.portfolio.assets[0].returns,
                                   [0.01, -0.02])
        assert back.split()["south"].total_value == \
            rp.split()["south"].total_value

    def test_region_of(self):
        _, rp = self._setup()
        assert rp.region_of(rp.portfolio.assets[0]) == "south"
        assert rp.region_of(rp.portfolio.assets[2]) == "north"


# ------------------------------------------------------ the package

def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_exports_every_jax_name():
    assert _public(T) == _public(J)


_DEM = np.zeros((8, 8), np.float32)
_MEAN, _COV = np.zeros(2), np.eye(2) * 1e-4
ENTRY_POINTS = {
    "slope": lambda **kw: T.create_slope_risk_factor(_DEM, **kw),
    "flood": lambda **kw: T.create_flood_risk_factor(_DEM, **kw),
    "monte_carlo_var": lambda **kw: T.monte_carlo_var(
        mean=_MEAN, cov=_COV, n_samples=100, **kw),
    "monte_carlo_simulation": lambda **kw: T.monte_carlo_simulation(
        [0.5, 0.5], mean=_MEAN, cov=_COV, n_paths=4, horizon=3, **kw),
    "black_scholes": lambda **kw: T.black_scholes(100, 100, 1, 0.05, 0.2,
                                                  **kw),
    "greeks": lambda **kw: T.greeks(100, 100, 1, 0.05, 0.2, **kw),
    "binomial_tree": lambda **kw: T.binomial_tree(100, 100, 1, 0.05, 0.2,
                                                  n_steps=4, **kw),
    "monte_carlo_price": lambda **kw: T.monte_carlo_price(
        100, 100, 1, 0.05, 0.2, n_paths=10, **kw),
    "barrier": lambda **kw: T.barrier_option_price(
        100, 100, 130, 1, 0.05, 0.2, n_paths=10, n_steps=3, **kw),
    "asian": lambda **kw: T.asian_option_price(
        100, 100, 1, 0.05, 0.2, n_paths=10, n_steps=3, **kw),
    "optimizer": lambda **kw: T.TPUOptimizer(**kw),
    "analyzer_mc": lambda **kw: T.RiskMetricsAnalyzer(**kw).calculate_var(
        np.random.default_rng(0).normal(size=(50, 2)), 0.9, "monte_carlo"),
    "pricer": lambda **kw: T.OptionsPricer(**kw).greeks(100, 100, 1, 0.05,
                                                        0.2),
    "portfolio_mc": lambda **kw: T.PortfolioOptimizer(**kw)
    .monte_carlo_simulation([1.0], mean=[0.0], cov=[[1e-4]], n_paths=2,
                            horizon=2),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_runs_on_the_cpu(name):
    ENTRY_POINTS[name](device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()
