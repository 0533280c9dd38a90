"""The port's DEM module held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the associative scan equal to
``jax.lax.associative_scan`` bit for bit (the same recursion, so the
same order of every combination) and to a sequential fold exactly on
integer-valued triples (exact sums) and within 1e-6 of the largest value
on random ones; shear and unshear exact; terrain derivatives at 1e-5 of
the largest |value| (measured 9e-8); viewshed masks, D8 directions, both
flow accumulations and least-cost paths exactly equal; fill_sinks equal
bit for bit (measured; elementwise min, max and adds in JAX's order);
cost distance at 1e-5 of the largest (torch.cumsum against XLA's
cumulative sum: measured 6e-7) and against the Dijkstra oracle at the
JAX test's rtol 2e-5 / atol 1e-4; resampling at 1e-5; the statistics at
rtol 1e-6. The JAX file's own DEM tests run again on the port.
"""
import heapq

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import njw_tpu.geospatial as jg  # noqa: E402
from njw_tpu.geospatial import dem as jd  # noqa: E402

import njw_tpu_torch.geospatial as tg  # noqa: E402
from njw_tpu_torch.geospatial import convert, dem as td  # noqa: E402
from njw_tpu_torch.geospatial.main_paths import measure_dem  # noqa: E402

CPU = "cpu"
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(jax_out, port_out) -> float:
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _equal(jax_out, port_out):
    np.testing.assert_array_equal(port_out.cpu().numpy(), np.asarray(jax_out))


def hills(n=64, seed=0):
    """tests/test_geospatial.py's synthetic_dem: hills and a central peak."""
    yy, xx = np.mgrid[0:n, 0:n] / n
    return (20 * np.exp(-((yy - 0.5) ** 2 + (xx - 0.5) ** 2) / 0.05)
            + 5 * np.sin(4 * np.pi * xx) * np.cos(3 * np.pi * yy)
            ).astype(np.float32)


DEMS = {"measure_40": lambda: measure_dem(40),
        "measure_48x31": lambda: measure_dem(48)[:, :31].copy(),
        "hills_32": lambda: hills(32)}


def _triples(shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        a, b, m = (rng.integers(-50, 50, shape).astype(np.float32)
                   for _ in range(3))
    else:
        a, b = rng.normal(0, 10, shape), rng.normal(0, 10, shape)
        m = rng.uniform(0, 1e-2, shape)
        a, b, m = (x.astype(np.float32) for x in (a, b, m))
    return a, b, m


class TestAssociativeScan:
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 64, 100])
    def test_equals_jax_associative_scan(self, n):
        a, b, m = _triples((3, n), n)

        def jcompose(l, r):
            a1, b1, m1 = l
            a2, b2, m2 = r
            return (jnp.minimum(a2, jnp.maximum(b2, a1 + m2)),
                    jnp.maximum(b2, b1 + m2), m1 + m2)

        want = jax.lax.associative_scan(jcompose, (a, b, m), axis=1)
        got = td.associative_scan(td._compose, tuple(
            torch.from_numpy(x) for x in (a, b, m)))
        for w, g in zip(want, got):
            _equal(w, g)

    @pytest.mark.parametrize("n", [1, 2, 5, 16, 31, 64])
    @pytest.mark.parametrize("integer", [True, False])
    def test_equals_a_sequential_fold(self, n, integer):
        a, b, m = _triples((2, n), 100 + n, integer)
        got = td.associative_scan(td._compose, tuple(
            torch.from_numpy(x) for x in (a, b, m)))
        acc = (a[:, 0], b[:, 0], m[:, 0])
        want = [acc]
        for j in range(1, n):
            r = (a[:, j], b[:, j], m[:, j])
            acc = (np.minimum(r[0], np.maximum(r[1], acc[0] + r[2])),
                   np.maximum(r[1], acc[1] + r[2]), acc[2] + r[2])
            want.append(acc)
        for k in range(3):
            w = np.stack([t[k] for t in want], axis=1)
            g = got[k].numpy()
            if integer:
                np.testing.assert_array_equal(g, w)
            else:
                assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1)


class TestShear:
    @pytest.mark.parametrize("h,w", [(5, 9), (9, 5), (7, 7), (1, 4)])
    def test_round_trip_and_jax_bits(self, h, w):
        a = np.random.default_rng(h * w).random((h, w)).astype(np.float32)
        s = td._shear(torch.from_numpy(a), -3.0)
        _equal(jd._shear(jnp.asarray(a), -3.0), s)
        np.testing.assert_array_equal(td._unshear(s, h, w).numpy(), a)
        for i in range(h):
            np.testing.assert_array_equal(s[i, i:i + w].numpy(), a[i])


class TestAgainstJax:
    @pytest.mark.parametrize("dem", sorted(DEMS))
    @pytest.mark.parametrize("cell", [1.0, 2.5])
    def test_terrain_derivatives(self, dem, cell):
        z = DEMS[dem]()
        j = jg.terrain_derivatives(z, cell)
        t = tg.terrain_derivatives(z, cell, device=CPU)
        for k in ("slope", "aspect", "curvature"):
            assert _rel(j[k], t[k]) <= REL

    @pytest.mark.parametrize("dem", sorted(DEMS))
    @pytest.mark.parametrize("obs,height", [((20, 20), 1.8), ((3, 7), 10.0)])
    def test_viewshed_equal(self, dem, obs, height):
        z = DEMS[dem]()
        _equal(jg.viewshed(z, obs, height), tg.viewshed(z, obs, height,
                                                        device=CPU))

    @pytest.mark.parametrize("dem", sorted(DEMS))
    def test_fill_sinks_equal(self, dem):
        z = DEMS[dem]()
        _equal(jg.fill_sinks(z), tg.fill_sinks(z, device=CPU))

    def test_fill_sinks_cycle_cap(self):
        z = hills(32)
        z[10, 10] -= 30.0
        for n, eps in ((1, 1e-3), (3, 1e-2)):
            _equal(jg.fill_sinks(z, n, eps),
                   tg.fill_sinks(z, n, eps, device=CPU))

    @pytest.mark.parametrize("dem", sorted(DEMS))
    def test_flow_equal(self, dem):
        z = DEMS[dem]()
        _equal(jg.flow_direction(z), tg.flow_direction(z, device=CPU))
        for method in ("push", "doubling"):
            for cap in (0, 3):
                _equal(jg.flow_accumulation(z, cap, method),
                       tg.flow_accumulation(z, cap, method, device=CPU))

    def test_push_checks_every_few_rounds(self, monkeypatch):
        """The push loop reads "mass moves" once every PUSH_CHECK rounds;
        any cadence gives the same accumulation."""
        z = hills(32)
        want = tg.flow_accumulation(z, device=CPU)
        for every in (1, 5):
            monkeypatch.setattr(td, "PUSH_CHECK", every)
            assert torch.equal(tg.flow_accumulation(z, device=CPU), want)

    @pytest.mark.parametrize("dem", sorted(DEMS))
    def test_cost_distance(self, dem):
        z = DEMS[dem]()
        cost = np.abs(z) * 0.01 + 1.0
        src = (z.shape[0] // 2, z.shape[1] // 3)
        assert _rel(jg.cost_distance(cost, src),
                    tg.cost_distance(cost, src, device=CPU)) <= REL

    def test_least_cost_path_equal(self):
        z = hills(32)
        cost = 1.0 + np.asarray(jg.terrain_derivatives(z)["slope"]) * 10.0
        assert tg.least_cost_path(cost, (2, 2), (28, 29), device=CPU) == \
            jg.least_cost_path(cost, (2, 2), (28, 29))

    @pytest.mark.parametrize("method", ["bilinear", "nearest"])
    @pytest.mark.parametrize("shape", [(63, 63), (16, 16), (20, 45)])
    def test_resample(self, method, shape):
        z = hills(32)
        assert _rel(jg.resample(z, *shape, method),
                    tg.resample(z, *shape, method, device=CPU)) <= REL

    def test_dem_statistics(self):
        z = measure_dem(40)
        z[3, 4] = np.nan
        j, t = jg.dem_statistics(z), tg.dem_statistics(z, device=CPU)
        assert set(j) == set(t)
        for k in j:
            if k != "mean_slope":
                assert t[k] == j[k]
        assert t["mean_slope"] == j["mean_slope"] or np.isnan(j["mean_slope"])

    def test_dem_processor(self):
        z = hills(32)
        gt = jg.GeoTransform(origin_x=10.0, pixel_width=2.0)
        j = jg.DEMProcessor(z, gt, cell_size=2.0)
        t = tg.DEMProcessor(z, convert.geo_transform_from(gt), cell_size=2.0,
                            device=CPU)
        _equal(j.viewshed((16, 16)), t.viewshed((16, 16)))
        for k, v in j.terrain_derivatives().items():
            assert _rel(v, t.terrain_derivatives()[k]) <= REL
        jh, th = j.hydrology(), t.hydrology()
        assert set(jh) == set(th)
        for k in jh:
            _equal(jh[k], th[k])
        assert t.least_cost_path((2, 2), (29, 30)) == \
            j.least_cost_path((2, 2), (29, 30))
        _equal(j.fill_sinks(n_iterations=5), t.fill_sinks(n_iterations=5))
        assert t.statistics()["max"] == j.statistics()["max"]
        assert _rel(j.resample(20, 24), t.resample(20, 24)) <= REL

    def test_geo_transform(self):
        gt = tg.GeoTransform(origin_x=1000.0, origin_y=2000.0,
                             pixel_width=5.0, pixel_height=-5.0,
                             rotation_x=0.5, rotation_y=0.25)
        jgt = jg.GeoTransform(**convert.geo_transform_fields(gt))
        assert gt.pixel_to_geo(10, 20) == jgt.pixel_to_geo(10, 20)
        assert gt.geo_to_pixel(1100.0, 1950.0) == \
            jgt.geo_to_pixel(1100.0, 1950.0)
        assert convert.geo_transform_from(jgt) == gt


def _dijkstra_oracle(cost, source):
    """Exact D8 shortest path with edge cost hypot * (c_a + c_b) / 2."""
    h, w = cost.shape
    dist = np.full((h, w), np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    offs = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1),
            (-1, -1)]
    while pq:
        d, (y, x) = heapq.heappop(pq)
        if d > dist[y, x]:
            continue
        for dy, dx in offs:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w:
                nd = d + np.hypot(dy, dx) * 0.5 * (cost[y, x] + cost[ny, nx])
                if nd < dist[ny, nx] - 1e-9:
                    dist[ny, nx] = nd
                    heapq.heappush(pq, (nd, (ny, nx)))
    return dist


class TestInvariants:
    """tests/test_geospatial.py's DEM tests, on the port."""

    def test_geotransform_roundtrip(self):
        gt = tg.GeoTransform(origin_x=1000.0, origin_y=2000.0,
                             pixel_width=5.0, pixel_height=-5.0)
        x, y = gt.pixel_to_geo(10, 20)
        assert (x, y) == (1100.0, 1950.0)
        row, col = gt.geo_to_pixel(x, y)
        assert (round(row), round(col)) == (10, 20)

    def test_flat_dem_zero_slope(self):
        d = tg.terrain_derivatives(np.full((16, 16), 5.0, np.float32),
                                   device=CPU)
        np.testing.assert_allclose(d["slope"], 0.0, atol=1e-6)

    def test_inclined_plane_slope(self):
        plane = np.mgrid[0:32, 0:32][1].astype(np.float32)
        d = tg.terrain_derivatives(plane, cell_size=1.0, device=CPU)
        np.testing.assert_allclose(d["slope"][2:-2, 2:-2], np.pi / 4,
                                   atol=1e-3)
        assert abs(float(d["aspect"][16, 16])) < 1e-3

    def test_peak_has_negative_curvature(self):
        assert float(tg.terrain_derivatives(hills(), device=CPU)[
            "curvature"][32, 32]) < 0

    def test_wall_blocks_view(self):
        dem = np.zeros((32, 32), np.float32)
        dem[:, 16] = 50.0
        vis = tg.viewshed(dem, (16, 4), observer_height=2.0,
                          device=CPU).numpy()
        assert vis[16, 4] and vis[16, 10] and not vis[16, 28]

    def test_flat_dem_all_visible(self):
        vis = tg.viewshed(np.zeros((24, 24), np.float32), (12, 12),
                          observer_height=2.0, device=CPU)
        assert float(vis.float().mean()) > 0.99

    def test_fill_sinks_removes_pit(self):
        dem = hills(32)
        dem[10, 10] -= 30.0
        filled = tg.fill_sinks(dem, n_iterations=128, device=CPU).numpy()
        assert filled[10, 10] > dem[10, 10] + 10.0
        assert abs(filled[0, 0] - dem[0, 0]) < 1e-3

    def test_flow_direction_points_downhill(self):
        plane = np.mgrid[0:16, 0:16][1].astype(np.float32)
        assert (tg.flow_direction(plane, device=CPU).numpy()[4:-4, 4:-4]
                == 6).all()

    def test_flow_accumulation_on_valley(self):
        yy, xx = np.mgrid[0:32, 0:32]
        dem = (np.abs(xx - 16) * 2.0 + (31 - yy) * 0.5).astype(np.float32)
        acc = tg.flow_accumulation(dem, n_iterations=64, device=CPU).numpy()
        assert acc[-1, 16] > 10 * acc[-1, 4]

    def test_cost_distance_matches_dijkstra(self):
        rng = np.random.default_rng(12)
        cost = (0.2 + rng.random((24, 24))).astype(np.float32)
        cost[5:20, 12] = 25.0
        d = tg.cost_distance(cost, (3, 3), n_iterations=64,
                             device=CPU).numpy()
        np.testing.assert_allclose(
            d, _dijkstra_oracle(cost.astype(np.float64), (3, 3)),
            rtol=2e-5, atol=1e-4)

    def test_fill_sinks_matches_jacobi_fixed_point(self):
        yy, xx = np.mgrid[0:32, 0:32] / 32
        dem = (20 * np.exp(-((yy - 0.5) ** 2 + (xx - 0.5) ** 2) / 0.05)
               + 5 * np.sin(4 * np.pi * xx) * np.cos(3 * np.pi * yy)
               ).astype(np.float32)
        dem[8:11, 8:11] -= 25.0
        eps = 1e-3
        z = dem.astype(np.float64)
        wv = np.full_like(z, 1e30)
        wv[0, :], wv[-1, :], wv[:, 0], wv[:, -1] = (z[0, :], z[-1, :],
                                                    z[:, 0], z[:, -1])
        for _ in range(10000):
            p = np.pad(wv, 1, constant_values=1e30)
            mn = np.min([p[1 + dy:1 + dy + 32, 1 + dx:1 + dx + 32]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if (dy, dx) != (0, 0)], axis=0)
            new = np.minimum(wv, np.maximum(z, mn + eps))
            if np.abs(new - wv).max() < eps * 1e-4:
                wv = new
                break
            wv = new
        filled = tg.fill_sinks(dem, n_iterations=64, epsilon=eps,
                               device=CPU).numpy()
        np.testing.assert_allclose(filled, wv, atol=5e-3)

    @pytest.mark.parametrize("n,seed", [(48, 5), (40, 0)])
    def test_flow_push_matches_doubling(self, n, seed):
        dem = measure_dem(n) if seed == 0 else hills(n, seed)
        assert torch.equal(tg.flow_accumulation(dem, device=CPU),
                           tg.flow_accumulation(dem, method="doubling",
                                                device=CPU))

    def test_flow_accumulation_matches_topological_sum(self):
        dem = measure_dem(24)
        acc = tg.flow_accumulation(dem, method="doubling",
                                   device=CPU).numpy()
        fdir = tg.flow_direction(dem, device=CPU).numpy()
        offs = td._D8_OFFSETS
        ref = np.ones((24, 24))
        for flat in np.argsort(-dem, axis=None):
            y, x = divmod(int(flat), 24)
            d = int(fdir[y, x])
            if d >= 0:
                ny, nx = y + offs[d][0], x + offs[d][1]
                if 0 <= ny < 24 and 0 <= nx < 24:
                    ref[ny, nx] += ref[y, x]
        np.testing.assert_allclose(acc, ref, rtol=1e-6)

    def test_cost_distance_prefers_cheap_cells(self):
        cost = np.ones((16, 16), np.float32)
        cost[:, 8] = 100.0
        cost[0, 8] = 1.0
        d = tg.cost_distance(cost, (8, 2), n_iterations=128, device=CPU)
        assert float(d[8, 14]) < 100.0

    def test_path_connects_endpoints(self):
        proc = tg.DEMProcessor(hills(32), device=CPU)
        path = proc.least_cost_path((2, 2), (28, 28), n_iterations=256)
        assert path[0] == (2, 2) and path[-1] == (28, 28)
        for (y0, x0), (y1, x1) in zip(path, path[1:]):
            assert max(abs(y1 - y0), abs(x1 - x0)) == 1

    def test_resample_shapes_and_values(self):
        dem = hills(32)
        up = tg.resample(dem, 63, 63, device=CPU).numpy()
        assert up.shape == (63, 63)
        np.testing.assert_allclose(up[::2, ::2], dem, atol=1e-4)
        assert tg.resample(dem, 16, 16, method="nearest",
                           device=CPU).shape == (16, 16)

    def test_statistics_keys(self):
        st = tg.dem_statistics(hills(), device=CPU)
        assert set(st) == {"min", "max", "mean", "std", "mean_slope"}
        assert st["max"] > st["min"]
