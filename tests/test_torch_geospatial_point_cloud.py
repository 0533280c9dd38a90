"""The port's point-cloud, dataset and metrics modules held against the
JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the synthetic DEM and point
cloud bit for bit (NumPy in both); the min and max rasters bit for bit
(NaN where empty: a scatter of min or max is exact in any order); the
mean raster at 1e-6 of its largest |value| (index_add_ against XLA's
scatter-add: measured 0); ground and building classes exactly equal;
normals within 1e-6 absolute (measured 1.2e-7). The metrics module is
the port's copy and behaves as JAX's on the same calls. The JAX file's
own point-cloud tests run again on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import njw_tpu.geospatial as jg  # noqa: E402
from njw_tpu.geospatial import datasets as jds, metrics as jmet  # noqa: E402
from njw_tpu.geospatial.point_cloud import PointClass as JClass  # noqa: E402

import njw_tpu_torch.geospatial as tg  # noqa: E402
from njw_tpu_torch.geospatial import (  # noqa: E402
    convert, datasets as tds, metrics as tmet,
)
from njw_tpu_torch.geospatial.point_cloud import PointClass  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0):
    """tests/test_geospatial.py's scene: flat ground, a 10 m flat-roofed
    building, scattered trees."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(0, 50, 4000), rng.uniform(0, 50, 4000),
                       rng.normal(0.0, 0.05, 4000)], axis=1)
    bx, by = rng.uniform(20, 30, 800), rng.uniform(20, 30, 800)
    building = np.stack([bx, by, np.full(800, 10.0)
                         + rng.normal(0, 0.05, 800)], axis=1)
    tx, ty = rng.uniform(5, 10, 200), rng.uniform(35, 45, 200)
    trees = np.stack([tx, ty, rng.uniform(3, 8, 200)], axis=1)
    return np.concatenate([ground, building, trees])


def _clouds(kind, seed):
    if kind == "scene":
        xyz = _scene(seed)
        return jg.PointCloud(xyz), tg.PointCloud(xyz)
    return (jds.synthetic_point_cloud(20_000, seed=seed),
            tds.synthetic_point_cloud(20_000, seed=seed))


CLOUDS = [("scene", 0), ("scene", 3), ("synthetic", 1)]


class TestDatasets:
    @pytest.mark.parametrize("size,rough,seed", [(64, 0.5, 3), (48, 0.1, 0)])
    def test_synthetic_dem_bit_equal(self, size, rough, seed):
        np.testing.assert_array_equal(
            tds.synthetic_dem(size, roughness=rough, seed=seed),
            jds.synthetic_dem(size, roughness=rough, seed=seed))

    @pytest.mark.parametrize("n,seed", [(20_000, 1), (5_000, 7)])
    def test_synthetic_point_cloud_bit_equal(self, n, seed):
        j = jds.synthetic_point_cloud(n, seed=seed)
        t = tds.synthetic_point_cloud(n, seed=seed)
        for f in ("xyz", "classification", "intensity"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


class TestAgainstJax:
    @pytest.mark.parametrize("kind,seed", CLOUDS)
    @pytest.mark.parametrize("cell", [1.0, 2.0, 3.3])
    def test_rasterize(self, kind, seed, cell):
        j, t = _clouds(kind, seed)
        for st in ("min", "max", "mean"):
            jgrid, jo = jg.rasterize_dem(j, cell, st)
            tgrid, to = tg.rasterize_dem(t, cell, st, device=CPU)
            assert to == jo
            a, b = np.asarray(jgrid), tgrid.numpy()
            if st == "mean":
                assert np.array_equal(np.isnan(a), np.isnan(b))
                assert np.nanmax(np.abs(a - b)) <= 1e-6 * np.nanmax(
                    np.abs(a))
            else:
                np.testing.assert_array_equal(b, a)

    def test_rasterize_refuses_an_unknown_statistic(self):
        with pytest.raises(ValueError, match="unknown statistic"):
            tg.rasterize_dem(tg.PointCloud(_scene()), 2.0, "median",
                             device=CPU)

    @pytest.mark.parametrize("kind,seed", CLOUDS)
    def test_classify_ground_equal(self, kind, seed):
        j, t = _clouds(kind, seed)
        for cell, thr in ((2.0, 0.3), (1.5, 0.5)):
            np.testing.assert_array_equal(
                tg.classify_ground(t, cell, thr, device=CPU).classification,
                jg.classify_ground(j, cell, thr).classification)

    @pytest.mark.parametrize("kind,seed", CLOUDS)
    def test_compute_normals(self, kind, seed):
        j, t = _clouds(kind, seed)
        for cell in (2.0, 3.0):
            np.testing.assert_allclose(
                tg.compute_normals(t, cell, device=CPU),
                jg.compute_normals(j, cell), rtol=0, atol=1e-6)

    def test_gradient_is_jax_gradient(self):
        import jax.numpy as jnp
        from njw_tpu_torch.geospatial import point_cloud as tp

        f = np.random.default_rng(2).random((7, 9)).astype(np.float32)
        for h in (2.0, 0.7):
            for got, want in zip(tp._gradient(torch.from_numpy(f), h),
                                 jnp.gradient(jnp.asarray(f), h)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("kind,seed", CLOUDS)
    def test_extract_buildings_equal(self, kind, seed):
        j, t = _clouds(kind, seed)
        jc = jg.classify_ground(j, 2.0)
        tc = tg.classify_ground(t, 2.0, device=CPU)
        for mh, mr in ((3.0, 0.5), (2.0, 1.0)):
            np.testing.assert_array_equal(
                tg.extract_buildings(tc, 2.0, mh, mr,
                                     device=CPU).classification,
                jg.extract_buildings(jc, 2.0, mh, mr).classification)

    def test_point_class_and_cloud(self):
        assert {c.name: int(c) for c in PointClass} == \
            {c.name: int(c) for c in JClass}
        t = tg.PointCloud(_scene())
        j = jg.PointCloud(_scene())
        assert t.n == j.n
        for a, b in zip(t.bounds(), j.bounds()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.classification, j.classification)

    def test_convert_round_trip(self):
        j = jg.classify_ground(jg.PointCloud(_scene()), 2.0)
        t = convert.point_cloud_from(j)
        back = jg.PointCloud(**convert.point_cloud_fields(t))
        for f in ("xyz", "classification", "intensity"):
            np.testing.assert_array_equal(getattr(back, f), getattr(j, f))
        assert t.classification is not j.classification


@pytest.mark.parametrize("mod", [jmet, tmet], ids=["jax", "port"])
class TestMetrics:
    """tests/test_geospatial.py's metrics tests, on both packages' copies."""

    def test_series_and_averages(self, mod):
        m = mod.GeospatialMetrics()
        m.record_metric("x", 1.0, timestamp=5.0)
        m.record_metric("x", 3.0)
        assert m.get_latest_metric("x") == 3.0
        assert m.get_average_metric("x") == 2.0
        assert m.get_metric("x")[0] == {"value": 1.0, "timestamp": 5.0}
        assert m.get_metric("missing") == []
        assert m.get_latest_metric("missing") is None
        assert m.get_average_metric("missing") is None

    def test_throughput_records(self, mod):
        m = mod.GeospatialMetrics()
        assert m.record_viewshed_performance(512, 512, 0.5) == \
            pytest.approx(512 * 512 / 0.5)
        assert m.record_point_classification_performance(10000, 0.1) == \
            pytest.approx(1e5)
        m.record_dem_derivatives_performance(8, 8, 1.0)
        m.record_hydro_features_performance(8, 8, 2.0)
        m.record_surface_reconstruction_performance(100, 1.0)
        m.record_feature_extraction_performance(100, 4.0)
        assert m.record_cost_efficiency("v", 2.0, 10.0) == 5.0
        assert m.record_energy_efficiency("v", 4.0, 10.0) == 2.5
        s = m.summary()
        assert "viewshed_throughput_cells_per_s" in s
        assert s["feature_extraction_throughput_points_per_s"] == 25.0

    def test_accuracy_metrics(self, mod):
        assert mod.raster_rmse(np.zeros((4, 4)), np.ones((4, 4))) == \
            pytest.approx(1.0)
        assert mod.viewshed_agreement([1, 0, 1], [1, 0, 0]) == \
            pytest.approx(2 / 3)
        scores = mod.classification_scores([0, 0, 1, 1], [0, 1, 1, 1])
        assert scores[1]["precision"] == 1.0
        assert scores[1]["recall"] == pytest.approx(2 / 3)


def test_metrics_copies_agree():
    rng = np.random.default_rng(9)
    a, b = rng.random((8, 8)), rng.random((8, 8))
    assert tmet.raster_rmse(a, b) == jmet.raster_rmse(a, b)
    p, t = rng.integers(1, 7, 200), rng.integers(1, 7, 200)
    assert tmet.classification_scores(p, t) == \
        jmet.classification_scores(p, t)


class TestInvariants:
    """tests/test_geospatial.py's point-cloud tests, on the port."""

    def test_rasterize_min_max(self):
        pc = tg.PointCloud(_scene())
        dem, _ = tg.rasterize_dem(pc, 2.0, "min", device=CPU)
        dsm, _ = tg.rasterize_dem(pc, 2.0, "max", device=CPU)
        dem, dsm = dem.numpy(), dsm.numpy()
        m = np.isfinite(dem) & np.isfinite(dsm)
        assert (dsm[m] >= dem[m] - 1e-5).all()

    def test_classify_ground(self):
        out = tg.classify_ground(tg.PointCloud(_scene()), cell_size=2.0,
                                 device=CPU)
        ground = out.classification == PointClass.GROUND
        assert ground[:4000].mean() > 0.9 and ground[4000:4800].mean() < 0.1

    def test_extract_buildings(self):
        pc = tg.classify_ground(tg.PointCloud(_scene()), cell_size=2.0,
                                device=CPU)
        b = tg.extract_buildings(pc, cell_size=2.0, min_height=3.0,
                                 device=CPU).classification \
            == PointClass.BUILDING
        assert b[4000:4800].mean() > 0.7 and b[:4000].mean() < 0.05

    def test_normals_flat_ground_point_up(self):
        n = tg.compute_normals(tg.PointCloud(_scene()), cell_size=2.0,
                               device=CPU)
        assert (n[:4000, 2] > 0.9).mean() > 0.85
