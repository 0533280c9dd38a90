"""The port's dashboard (njw_tpu_torch.dashboard) held against the JAX
package's, on the CPU.

Every case of tests/test_dashboard.py runs again on the port's server on
127.0.0.1, port 0, with ``device="cpu"``. The geo-financial views are
built in both packages on the same DEM and portfolio: the portfolio and
scenario views' JSON must be equal, and so must the risk map's (rounded
to 4 decimals by both); the risk grid before rounding agrees within
1e-5. The schema endpoint serves the same proto, /api/cluster carries
every key of the JAX view, and the server refuses CUDA without a card.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from njw_tpu_torch.dashboard import DashboardServer  # noqa: E402

CPU = "cpu"
ROW = {
    "workload": "weather", "device": "cuda:sm_90",
    "execution_time_s": 1.0, "throughput": 5e9,
    "throughput_unit": "grid-points/s", "memory_bytes": 1000,
    "additional_metrics": {}, "cost_metrics": {},
    "timestamp": "2026-01-01T00:00:00",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def server(tmp_path):
    path = tmp_path / "results.json"
    path.write_text(json.dumps([ROW]))
    srv = DashboardServer(str(path), port=0, device=CPU).start()
    yield srv
    srv.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def test_api_results(server):
    status, body = _get(server.url + "/api/results")
    assert status == 200
    rows = json.loads(body)
    assert rows[0]["workload"] == "weather"
    assert rows == [ROW]


def test_api_workloads(server):
    _, body = _get(server.url + "/api/workloads")
    assert json.loads(body) == ["weather"]


def test_api_cluster(server):
    """Device info of the server's device + per-workload summaries from
    the results history; every key of the JAX view."""
    from njw_tpu.dashboard.server import DashboardServer as JaxServer

    _, body = _get(server.url + "/api/cluster")
    c = json.loads(body)
    assert c["platform"] == "cpu" and c["generation"] == "cpu"
    assert c["num_devices"] >= 1
    assert c["total_runs"] == 1
    (wl,) = c["workloads"]
    assert wl["workload"] == "weather"
    assert wl["runs"] == 1
    assert wl["best_throughput"] == 5e9
    want = JaxServer(server.results_path)._cluster_view()
    assert set(c) == set(want)
    assert c["workloads"] == want["workloads"]
    assert c["hbm_gb"] == 0.0 and c["peak_bf16_tflops"] is None


def test_api_history(server):
    _, body = _get(server.url + "/api/history")
    series = json.loads(body)
    (s,) = series
    assert s["workload"] == "weather"
    assert [p["throughput"] for p in s["points"]] == [5e9]
    ts = [p["timestamp"] for p in s["points"]]
    assert ts == sorted(ts)


def test_api_schema_matches_python_dataclass(server):
    """The served schema comes from proto/dashboard.proto, agrees field
    for field with the port's BenchmarkResult, and equals the JAX one."""
    from njw_tpu.dashboard.schema import parse_proto_messages as jparse
    from njw_tpu_torch.dashboard.schema import (
        _PROTO_PATH, check_result_schema, parse_proto_messages,
    )
    from njw_tpu.dashboard.schema import _PROTO_PATH as JAX_PROTO_PATH

    assert _PROTO_PATH == JAX_PROTO_PATH
    check_result_schema()
    assert parse_proto_messages() == jparse()
    _, body = _get(server.url + "/api/schema")
    schema = json.loads(body)
    assert "BenchmarkResultRow" in schema
    assert schema["BenchmarkResultRow"]["throughput"]["type"] == "double"
    assert "ClusterInfo" in schema and "HistorySeries" in schema


def test_rows_are_normalized(tmp_path):
    """Rows missing optional fields are coerced to the typed schema, as
    the JAX normalize_row does."""
    from njw_tpu.dashboard.schema import normalize_row as jnorm

    raw = {"workload": "x", "device": "cpu", "execution_time_s": 1,
           "throughput": 2, "throughput_unit": "u",
           "timestamp": "2026-01-01T00:00:00"}
    path = tmp_path / "r.json"
    path.write_text(json.dumps([raw]))
    srv = DashboardServer(str(path), port=0, device=CPU).start()
    try:
        _, body = _get(srv.url + "/api/results")
        (row,) = json.loads(body)
        assert row["memory_bytes"] == 0
        assert row["additional_metrics"] == {}
        assert isinstance(row["throughput"], float)
        assert row == jnorm(raw)
    finally:
        srv.stop()


def test_cluster_and_perf_pages_served(server):
    for page, marker in (("/cluster", b"cluster overview"),
                         ("/perf", b"throughput over run history")):
        status, body = _get(server.url + page)
        assert status == 200
        assert marker in body


def test_index_served(server):
    status, body = _get(server.url + "/")
    assert status == 200
    assert b"njw_tpu_torch" in body


def test_404(server):
    with pytest.raises(urllib.error.HTTPError):
        _get(server.url + "/nope")


def test_server_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DashboardServer(str(tmp_path / "r.json"), port=0)


def _both_geofin(n_dem=64, n_assets=20, seed=2):
    """The same geo-financial context in both packages."""
    from njw_tpu.dashboard.geofin import GeoFinDashboard as JGF
    from njw_tpu.geofinancial import geo_risk as jgr
    from njw_tpu.geofinancial import scenarios as jsc
    from njw_tpu.geofinancial import testdata as jtd
    from njw_tpu_torch.dashboard.geofin import GeoFinDashboard
    from njw_tpu_torch.geofinancial import geo_risk as tgr
    from njw_tpu_torch.geofinancial import scenarios as tsc
    from njw_tpu_torch.geofinancial import testdata as ttd

    dem = jtd.generate_dem(n_dem, seed=seed)
    jgf = JGF(jtd.generate_assets(n_assets, extent=float(n_dem), seed=seed),
              jgr.GeospatialRiskModel([jgr.create_flood_risk_factor(dem)]),
              scenarios=jsc.create_climate_scenarios())
    tgf = GeoFinDashboard(
        ttd.generate_assets(n_assets, extent=float(n_dem), seed=seed),
        tgr.GeospatialRiskModel([tgr.create_flood_risk_factor(
            torch.from_numpy(dem), device=CPU)]),
        scenarios=tsc.create_climate_scenarios())
    return jgf, tgf


class TestGeoFinDashboard:
    @pytest.fixture
    def geofin_server(self, tmp_path):
        jgf, gf = _both_geofin()
        path = tmp_path / "results.json"
        path.write_text("[]")
        srv = DashboardServer(str(path), port=0, geofin=gf,
                              device=CPU).start()
        yield srv, gf, jgf
        srv.stop()

    def test_portfolio_view(self, geofin_server):
        srv, _, jgf = geofin_server
        _, body = _get(srv.url + "/api/geofin/portfolio")
        p = json.loads(body)
        assert len(p["assets"]) == 20
        assert p["total_value"] > 0
        assert 0.0 <= p["value_weighted_risk"] <= 1.0
        assert p == json.loads(json.dumps(jgf.portfolio_view()))

    def test_riskmap_view(self, geofin_server):
        srv, gf, jgf = geofin_server
        _, body = _get(srv.url + "/api/geofin/riskmap?w=32&h=16")
        m = json.loads(body)
        assert len(m["grid"]) == 16 and len(m["grid"][0]) == 32
        assert all(0.0 <= v <= 1.0 for row in m["grid"] for v in row)
        assert len(m["assets"]) == 20
        assert m == json.loads(json.dumps(jgf.risk_map(32, 16)))
        grid, extent = gf.risk_grid(32, 16)
        h0, w0 = jgf.model.risk_factors[0].risk_data.shape
        gx, gy = np.meshgrid(np.linspace(0, w0 - 1, 32),
                             np.linspace(0, h0 - 1, 16))
        want = np.asarray(jgf.model.assess_risk(gx.ravel(), gy.ravel()),
                          np.float64).reshape(16, 32)
        np.testing.assert_allclose(grid, want, rtol=0, atol=1e-5)
        assert extent == m["extent"]

    def test_scenarios_view(self, geofin_server):
        srv, _, jgf = geofin_server
        _, body = _get(srv.url + "/api/geofin/scenarios")
        s = json.loads(body)
        assert len(s["scenarios"]) >= 3
        assert s["worst_loss"] >= s["scenarios"][0]["total_loss"] * 0 \
            and s["expected_loss"] > 0
        assert s == json.loads(json.dumps(jgf.scenario_view()))

    def test_geofin_page_served(self, geofin_server):
        srv, _, _ = geofin_server
        status, body = _get(srv.url + "/geofin")
        assert status == 200 and b"risk map" in body

    def test_sse_stream_delivers_published_events(self, geofin_server):
        srv, gf, _ = geofin_server
        got = {}

        def read_stream():
            req = urllib.request.urlopen(srv.url + "/api/stream",
                                         timeout=10)
            while True:
                line = req.readline()
                if line.startswith(b"data:"):
                    got["event"] = json.loads(line[5:].decode())
                    return

        t = threading.Thread(target=read_stream, daemon=True)
        t.start()
        time.sleep(0.3)
        gf.on_stream_event({"ts": 1.0, "prices": {"NJW": 100.0}})
        t.join(timeout=10)
        assert got["event"]["type"] == "portfolio_update"

    def test_stream_event_reprices_assets(self, geofin_server):
        _, gf, jgf = geofin_server
        for a in gf.portfolio.assets + jgf.portfolio.assets:
            a.metadata["symbol"] = "NJW"
        v0 = gf.portfolio.total_value
        for d in (gf, jgf):
            d.on_stream_event({"ts": 1.0, "prices": {"NJW": 100.0}})
            d.on_stream_event({"ts": 2.0, "prices": {"NJW": 110.0}})
        assert gf.portfolio.total_value == pytest.approx(1.1 * v0, rel=1e-6)
        assert gf.portfolio.total_value == jgf.portfolio.total_value

    def test_geofin_404_without_context(self, server):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(server.url + "/api/geofin/portfolio")
        assert exc.value.code == 404


def test_demo_geofin_views_match_jax():
    """``--demo-geofin``'s context built on the CPU gives the JAX demo's
    views (the JAX demo built by its own main's recipe)."""
    from njw_tpu.dashboard.geofin import GeoFinDashboard as JGF
    from njw_tpu.geofinancial import geo_risk as jgr
    from njw_tpu.geofinancial import scenarios as jsc
    from njw_tpu.geofinancial import testdata as jtd
    from njw_tpu_torch.dashboard.server import demo_geofin

    gf, stream = demo_geofin(CPU)
    assert stream._thread is None and stream._subscribers == [
        gf.on_stream_event]
    dem = jtd.generate_dem(256, seed=1)
    jport = jtd.generate_assets(60, extent=256.0, seed=1)
    jgf = JGF(jport, jgr.GeospatialRiskModel([
        jgr.create_flood_risk_factor(dem, weight=1.0),
        jgr.create_elevation_risk_factor(dem, weight=0.5)]),
        scenarios=jsc.create_climate_scenarios())
    assert gf.portfolio_view() == jgf.portfolio_view()
    assert gf.scenario_view() == json.loads(json.dumps(jgf.scenario_view()))
    assert gf.risk_map(24, 12) == json.loads(json.dumps(jgf.risk_map(24, 12)))
    assert [a.metadata["symbol"] for a in gf.portfolio.assets][:4] == [
        "NJW", "TPU", "XLA", "NJW"]
