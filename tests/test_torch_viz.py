"""The port's views (njw_tpu_torch.viz) held against the JAX package's, on
the CPU.

Every case of tests/test_viz.py runs again on the port, with the same
seeded inputs passed as CPU tensors: each view must draw the same data
as the JAX view draws from the NumPy arrays. A figure's data is what its
axes hold (image arrays, line data, collection offsets, colours and
segments, bar rectangles, titles); figures that a view saves and closes
are caught at ``savefig``. Inputs are equal, so the data must be equal
(rtol 1e-6 where floating point is compared). ``hillshade`` matches to
1e-6 and the reports' HTML tables match. Without matplotlib the views
raise an ImportError naming it, the reports write their tables alone,
and the package imports.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.figure  # noqa: E402

import njw_tpu.viz as J  # noqa: E402
import njw_tpu_torch.viz as T  # noqa: E402
from njw_tpu.viz import geofinancial as jgf  # noqa: E402
from njw_tpu.viz import geospatial as jgs  # noqa: E402
from njw_tpu_torch.viz import geofinancial as tgf  # noqa: E402
from njw_tpu_torch.viz import geospatial as tgs  # noqa: E402
from njw_tpu_torch.viz._common import to_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def F32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def tt(x):
    """A NumPy input as the port's CPU tensor (dicts and lists too)."""
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    if isinstance(x, list):
        return [tt(v) for v in x]
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return x


def _arr(a):
    a = np.ma.asarray(a)
    return np.ma.filled(a.astype(np.float64), np.nan)


def figure_data(fig) -> list:
    """What each axes of ``fig`` draws, as plain arrays and strings."""
    out = []
    for ax in fig.axes:
        colls = []
        for c in ax.collections:
            entry = [_arr(c.get_offsets())]
            if c.get_array() is not None:
                entry.append(_arr(c.get_array()))
            if hasattr(c, "get_segments"):
                entry += [_arr(s) for s in c.get_segments()]
            for attr in ("U", "V"):
                if hasattr(c, attr):
                    entry.append(_arr(getattr(c, attr)))
            colls.append(entry)
        out.append({
            "title": ax.get_title(),
            "images": [_arr(im.get_array()) for im in ax.images],
            "lines": [_arr(ln.get_xydata()) for ln in ax.lines],
            "collections": colls,
            "bars": [np.array([p.get_x(), p.get_y(), p.get_width(),
                               p.get_height()])
                     for p in ax.patches if hasattr(p, "get_height")],
            "texts": [t.get_text() for t in ax.texts],
        })
    return out


def assert_same_data(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_data(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_data(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, equal_nan=True)


def same_figure(jfig, tfig):
    assert_same_data(figure_data(jfig), figure_data(tfig))


@pytest.fixture
def saved(monkeypatch):
    """Every figure saved while the test runs: {basename: [figures]}."""
    figs = {}
    orig = matplotlib.figure.Figure.savefig

    def savefig(self, fname, *a, **kw):
        figs.setdefault(os.path.basename(str(fname)), []).append(self)
        return orig(self, fname, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return figs


def run_both(tmp_path, name, jfn, tfn, args, **kw):
    """The JAX view on NumPy inputs and the port's on CPU tensors, each
    saving to its own file; the files exist and the figures agree."""
    pj = str(tmp_path / f"jax_{name}")
    pt = str(tmp_path / f"port_{name}")
    jfig = jfn(*args, path=pj, **kw)
    tfig = tfn(*tt(list(args)), path=pt, **kw)
    assert os.path.getsize(pj) > 0 and os.path.getsize(pt) > 0
    return jfig, tfig


class TestWeatherViz:
    def test_fields(self, tmp_path):
        for name, args in [
            ("visualize_field", (F32(16, 16),)),
            ("visualize_height", (F32(16, 16) + 10,)),
            ("visualize_vorticity", (F32(16, 16), F32(16, 16, seed=1))),
        ]:
            same_figure(*run_both(tmp_path, f"{name}.png", getattr(J, name),
                                  getattr(T, name), args))

    @pytest.mark.parametrize("mode", ["quiver", "streamlines"])
    def test_velocity_modes(self, tmp_path, mode):
        same_figure(*run_both(tmp_path, f"v_{mode}.png",
                              J.visualize_velocity, T.visualize_velocity,
                              (F32(32, 32), F32(32, 32, seed=1)), mode=mode))

    def test_animation_gif(self, tmp_path):
        snaps = [{"h": F32(8, 8, seed=i), "step": i} for i in range(3)]
        pj, pt = str(tmp_path / "j.gif"), str(tmp_path / "t.gif")
        ja = J.animate_simulation(snaps, "h", path=pj, fps=2)
        ta = T.animate_simulation(tt(snaps), "h", path=pt, fps=2)
        assert os.path.getsize(pj) > 0 and os.path.getsize(pt) > 0
        same_figure(ja._fig, ta._fig)

    def test_performance_plot(self, tmp_path):
        m = {"total_time_ms": 120.0, "steps_per_second": 50.0,
             "note": "skip-me"}
        same_figure(*run_both(tmp_path, "perf.png", J.plot_performance,
                              T.plot_performance, (m,)))


class TestParticleViz:
    def test_particles_and_trajectory(self, tmp_path):
        pos = F32(64, 3)
        masses = np.abs(F32(64, seed=1)) + 0.1
        same_figure(*run_both(tmp_path, "p3d.png", J.plot_particles_3d,
                              T.plot_particles_3d, (pos,), masses=None))
        jf = J.plot_particles_3d(pos, masses=masses,
                                 path=str(tmp_path / "j3.png"))
        tf = T.plot_particles_3d(tt(pos), masses=tt(masses),
                                 path=str(tmp_path / "t3.png"))
        same_figure(jf, tf)
        frames = [pos + np.float32(0.1 * i) for i in range(4)]
        same_figure(*run_both(tmp_path, "traj.png", J.plot_trajectory,
                              T.plot_trajectory, (frames,)))

    def test_energy_history(self, tmp_path):
        t = np.linspace(0, 1, 20)
        same_figure(*run_both(tmp_path, "e.png", J.plot_energy_history,
                              T.plot_energy_history,
                              (t, {"kinetic": t, "total": t * 0 + 1})))


class TestImagingViz:
    def test_image_sinogram_compare(self, tmp_path):
        img = F32(24, 24)
        for name, args in [
            ("show_image", (img,)),
            ("show_sinogram", (F32(30, 24, seed=1),)),
            ("compare_images", ({"a": img, "b": img * 2},)),
        ]:
            same_figure(*run_both(tmp_path, f"{name}.png", getattr(J, name),
                                  getattr(T, name), args))


class TestImagingVizFullSurface:
    def test_overlay_histogram_difference_surface(self, tmp_path):
        img = F32(24, 24)
        seg = (img > 0).astype(np.int32)
        for name, args in [
            ("plot_overlay", (img, seg)),
            ("plot_histogram", (img,)),
            ("plot_difference", (img, img * 0.5)),
            ("plot_surface_3d", (img,)),
        ]:
            same_figure(*run_both(tmp_path, f"{name}.png", getattr(J, name),
                                  getattr(T, name), args))

    def test_volume_views(self, tmp_path, saved):
        vol = F32(10, 20, 20)
        same_figure(*run_both(tmp_path, "slice.png", J.plot_slice,
                              T.plot_slice, (vol,), axis=0))
        same_figure(*run_both(tmp_path, "ortho.png",
                              J.plot_orthogonal_slices,
                              T.plot_orthogonal_slices, (vol,)))
        pj, pt = str(tmp_path / "j.gif"), str(tmp_path / "t.gif")
        assert J.create_volume_animation(vol[:4], path=pj) == pj
        assert T.create_volume_animation(tt(vol[:4]), path=pt) == pt
        assert os.path.getsize(pj) > 0 and os.path.getsize(pt) > 0
        ja = J.create_volume_animation(vol[:4])
        ta = T.create_volume_animation(tt(vol[:4]))
        same_figure(ja._fig, ta._fig)
        with pytest.raises(ValueError):
            T.plot_orthogonal_slices(tt(F32(8, 8)))

    def test_colormap_and_aliases(self):
        jc, tc = J.create_medical_colormap(), T.create_medical_colormap()
        x = np.linspace(0, 1, 11)
        np.testing.assert_array_equal(tc(x), jc(x))
        assert T.plot_image is T.show_image
        assert T.plot_ct_projection is T.show_sinogram
        assert T.plot_images is T.compare_images
        assert T.plot_comparison is T.compare_images

    def test_md_temperature_plot(self, tmp_path):
        same_figure(*run_both(tmp_path, "temp.png", J.plot_temperature,
                              T.plot_temperature,
                              (np.linspace(280, 300, 50),),
                              target_temp=295.0))


def _geo_inputs(n_dem, n_assets, seed, factors=("flood",)):
    """The same DEM, portfolio and model in both packages."""
    from njw_tpu.geofinancial import geo_risk as jgr
    from njw_tpu.geofinancial import testdata as jtd
    from njw_tpu_torch.geofinancial import geo_risk as tgr
    from njw_tpu_torch.geofinancial import testdata as ttd

    dem = jtd.generate_dem(n_dem, seed=seed)
    make = {"flood": lambda m, **kw: m.create_flood_risk_factor(dem, **kw),
            "elevation": lambda m, **kw: m.create_elevation_risk_factor(
                dem, weight=0.5)}
    jmodel = jgr.GeospatialRiskModel([make[f](jgr) for f in factors])
    tmodel = tgr.GeospatialRiskModel(
        [make[f](tgr, **({"device": "cpu"} if f == "flood" else {}))
         for f in factors])
    jport = jtd.generate_assets(n_assets, extent=float(n_dem), seed=seed)
    tport = ttd.generate_assets(n_assets, extent=float(n_dem), seed=seed)
    return dem, (jmodel, jport), (tmodel, tport)


def _same_saved(saved):
    """The figures saved under jax/ and port/ directories agree by name."""
    names = {n for n in saved}
    assert names
    for n in names:
        figs = saved[n]
        assert len(figs) % 2 == 0, n
        half = len(figs) // 2
        for jf, tf in zip(figs[:half], figs[half:]):
            same_figure(jf, tf)


class TestGeoFinancialViz:
    def test_report_renders_all_views(self, tmp_path, saved):
        from njw_tpu.geofinancial.scenarios import create_climate_scenarios
        from njw_tpu.geofinancial.testdata import generate_returns
        from njw_tpu_torch.geofinancial import scenarios as tsc

        _, (jm, jp), (tm, tp) = _geo_inputs(64, 25, 3)
        rets = generate_returns(6, 60, seed=3)
        jpage = jgf.generate_geofin_report(
            str(tmp_path / "jax"), jp, jm,
            scenarios=create_climate_scenarios(), returns=rets)
        tpage = tgf.generate_geofin_report(
            str(tmp_path / "port"), tp, tm,
            scenarios=tsc.create_climate_scenarios(), returns=tt(rets))
        for f in ("risk_map.png", "portfolio.png", "distribution.png",
                  "scenarios.png", "returns.png", "index.html"):
            assert os.path.exists(tmp_path / "port" / f), f
        assert "expected loss" in open(tpage).read()
        assert open(tpage).read() == open(jpage).read()
        _same_saved(saved)

    def test_scenario_visualizer(self, tmp_path, saved):
        from njw_tpu.geofinancial import scenarios as jsc
        from njw_tpu_torch.geofinancial import scenarios as tsc

        _, (jm, jp), (tm, tp) = _geo_inputs(64, 20, 5,
                                            ("flood", "elevation"))
        outs = []
        for pkg, sc, m, p, d in ((jgf, jsc, jm, jp, "jax"),
                                 (tgf, tsc, tm, tp, "port")):
            (tmp_path / d).mkdir()
            viz = pkg.ScenarioVisualizer(sc.ScenarioAnalyzer(p, m))
            sset = sc.create_climate_scenarios()
            outs += [
                viz.plot_scenario_comparison(sset,
                                             str(tmp_path / d / "cmp.png")),
                viz.plot_sensitivity_analysis(str(tmp_path / d / "sens.png")),
                viz.plot_stress_test_results(
                    sc.create_stress_scenarios(),
                    str(tmp_path / d / "stress.png"),
                    baseline=sset.scenarios[0]),
                viz.create_scenario_dashboard(sset,
                                              str(tmp_path / d / "dash.png")),
            ]
        for p in outs:
            assert os.path.exists(p) and os.path.getsize(p) > 1000
        _same_saved(saved)

    def test_multi_region_visualizer(self, tmp_path, saved):
        from njw_tpu.geofinancial import geo_risk as jgr
        from njw_tpu.geofinancial import multiregion as jmr
        from njw_tpu_torch.geofinancial import geo_risk as tgr
        from njw_tpu_torch.geofinancial import multiregion as tmr

        dem, (_, jp), (_, tp) = _geo_inputs(64, 30, 7)
        outs = []
        for pkg, mr_mod, gr, p, d, kw in (
                (jgf, jmr, jgr, jp, "jax", {}),
                (tgf, tmr, tgr, tp, "port", {"device": "cpu"})):
            (tmp_path / d).mkdir()
            mr = mr_mod.MultiRegionRiskModel()
            for region in mr_mod.make_region_grid(0, 64, 0, 64, 2, 2):
                mr.add_region(region, gr.GeospatialRiskModel(
                    [gr.create_flood_risk_factor(dem, **kw)]))
            viz = pkg.MultiRegionVisualizer(mr)
            outs += [
                viz.plot_multi_region_risk_map(p, str(tmp_path / d / "m.png")),
                viz.plot_region_risk_comparison(p,
                                                str(tmp_path / d / "c.png")),
                viz.plot_risk_correlation_matrix(p,
                                                 str(tmp_path / d / "r.png")),
                viz.plot_recommended_allocation(p,
                                                str(tmp_path / d / "a.png")),
                viz.create_multi_region_dashboard(p,
                                                  str(tmp_path / d / "d.png")),
            ]
        for p in outs:
            assert os.path.exists(p) and os.path.getsize(p) > 1000
        _same_saved(saved)


class TestGeospatialViz:
    def test_hillshade_matches_jax(self):
        from njw_tpu.geospatial.datasets import synthetic_dem

        dem = synthetic_dem(64, seed=4)
        want = jgs.hillshade(dem, azimuth_deg=300.0, altitude_deg=30.0)
        for x in (dem, torch.from_numpy(dem)):
            got = tgs.hillshade(x, azimuth_deg=300.0, altitude_deg=30.0)
            assert isinstance(got, np.ndarray) and got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_report_and_views(self, tmp_path, saved):
        from njw_tpu.geospatial.datasets import synthetic_dem

        dem = synthetic_dem(32, seed=2)
        rng = np.random.default_rng(2)
        visible = (rng.random((32, 32)) > 0.5).astype(np.float32)
        slope, aspect = rng.random((2, 32, 32)).astype(np.float32)
        flow = rng.integers(1, 50, (32, 32)).astype(np.float32)
        points = rng.random((200, 3)).astype(np.float32)
        metrics = {"viewshed_ms": 1.25, "cells": 1024.0, "none": None}
        pages = []
        for pkg, conv, d in ((jgs, lambda x: x, "jax"), (tgs, tt, "port")):
            pages.append(pkg.generate_geospatial_report(
                str(tmp_path / d), conv(dem), visible=conv(visible),
                observer_xy=(16, 16), slope=conv(slope),
                aspect=conv(aspect), flow_acc=conv(flow),
                points=conv(points), metrics=metrics))
        assert open(pages[1]).read() == open(pages[0]).read()
        path_cells = np.array([[1, 1], [2, 3], [5, 8]])
        jgs.plot_least_cost_path(dem, path_cells, str(tmp_path / "jax" /
                                                      "lcp.png"))
        tgs.plot_least_cost_path(tt(dem), tt(path_cells),
                                 str(tmp_path / "port" / "lcp.png"))
        _same_saved(saved)


class TestHostArrays:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16, torch.int32])
    def test_to_numpy_dtypes(self, dtype):
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(dtype)
        a = to_numpy(x)
        np.testing.assert_array_equal(a, np.arange(6).reshape(2, 3))
        assert to_numpy(x, np.float64).dtype == np.float64

    def test_to_numpy_lists(self):
        frames = [torch.ones(2, 3), torch.zeros(2, 3)]
        assert to_numpy(frames).shape == (2, 2, 3)
        assert to_numpy([1.0, 2.0]).tolist() == [1.0, 2.0]
        assert to_numpy(np.eye(2)).shape == (2, 2)


class TestWithoutMatplotlib:
    @pytest.fixture
    def hidden(self, monkeypatch):
        for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "matplotlib", None)

    @pytest.mark.parametrize("call", [
        lambda: T.visualize_field(torch.zeros(4, 4)),
        lambda: T.plot_particles_3d(torch.zeros(4, 3)),
        lambda: T.show_image(torch.zeros(4, 4)),
        lambda: T.create_medical_colormap(),
        lambda: tgs.plot_dem(torch.zeros(4, 4), "x.png"),
        lambda: tgf.plot_returns(torch.zeros(5, 2), "x.png"),
    ])
    def test_views_raise_named_import_error(self, hidden, call):
        with pytest.raises(ImportError, match="matplotlib"):
            call()

    def test_reports_write_tables_alone(self, hidden, tmp_path):
        from njw_tpu_torch.geofinancial import geo_risk as tgr
        from njw_tpu_torch.geofinancial import scenarios as tsc
        from njw_tpu_torch.geofinancial import testdata as ttd

        dem = ttd.generate_dem(32, seed=1)
        np.testing.assert_allclose(tgs.hillshade(dem), jgs.hillshade(dem),
                                   atol=1e-6)
        page = tgs.generate_geospatial_report(
            str(tmp_path / "geo"), dem, metrics={"cells": 1024.0})
        assert os.listdir(tmp_path / "geo") == ["index.html"]
        assert "<td>1024</td>" in open(page).read()
        model = tgr.GeospatialRiskModel(
            [tgr.create_elevation_risk_factor(dem)])
        port = ttd.generate_assets(10, extent=32.0, seed=1)
        page = tgf.generate_geofin_report(
            str(tmp_path / "fin"), port, model,
            scenarios=tsc.create_climate_scenarios(),
            returns=np.zeros((5, 2)))
        assert os.listdir(tmp_path / "fin") == ["index.html"]
        text = open(page).read()
        assert "total value" in text and "expected loss" in text
        assert "<img" not in text


def test_port_imports_without_matplotlib():
    """The chip image's case: no matplotlib. The views, the dashboard and
    the examples import; a view raises the named ImportError."""
    code = (
        "import sys, importlib.abc\n"
        "class Hide(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError('No module named ' + repr(name))\n"
        "sys.meta_path.insert(0, Hide())\n"
        "import njw_tpu_torch.viz, njw_tpu_torch.viz.geospatial\n"
        "import njw_tpu_torch.viz.geofinancial, njw_tpu_torch.dashboard\n"
        "import njw_tpu_torch.dashboard.geofin, njw_tpu_torch.examples\n"
        "import pkgutil, importlib\n"
        "for m in pkgutil.iter_modules(njw_tpu_torch.examples.__path__):\n"
        "    importlib.import_module('njw_tpu_torch.examples.' + m.name)\n"
        "assert not [m for m in sys.modules if m.startswith('matplotlib')]\n"
        "try:\n"
        "    njw_tpu_torch.viz.show_image([[0.0]])\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e)\n"
        "else:\n"
        "    raise SystemExit('a view drew without matplotlib')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
