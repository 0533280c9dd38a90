"""The geospatial paths at full width, defined once.

``chip_smoke.py`` phase 19 drives these on the card and
``scripts/profile_torch.py --model imaging`` profiles one call of each;
both take them from here (``Call`` and ``ImagingPath`` are the medical
paths' records):

  geo_suite_512   the suite's 512^2 DEM (a gaussian hill plus noise 0.5,
                  rng 0): terrain_derivatives and a viewshed from the
                  centre, one call (njw_tpu/bench/suite.py:321-368)
  dem_2048        scripts/measure_geospatial.py's DEM formula at 2048^2
                  (hill, sinusoids, noise 0.5; rng 0 drawn for this size
                  alone) and its cost surface |dem| / 100 + 1:
                  terrain_derivatives, viewshed, fill_sinks,
                  flow_accumulation (push and doubling), cost_distance from
                  the centre, least_cost_path to the corner (0, 0),
                  DEMProcessor.hydrology (scripts/measure_geospatial.py:
                  40-75; BENCH_NOTES.md:679-708)
  point_cloud_1m  synthetic_point_cloud(1_000_000, seed=0), a LiDAR tile's
                  size: rasterize_dem (min, max, mean), classify_ground,
                  compute_normals, extract_buildings, cell 2.0
                  (njw_tpu/geospatial/datasets.py:32)
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.geospatial import dem as D
from njw_tpu_torch.geospatial import point_cloud as P
from njw_tpu_torch.geospatial.datasets import synthetic_point_cloud
from njw_tpu_torch.medical.main_paths import Call, ImagingPath


def suite_dem(n: int = 512) -> np.ndarray:
    """The suite's GeospatialBenchmark DEM."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:n, 0:n] / n
    return (50 * np.exp(-((yy - 0.5) ** 2 + (xx - 0.5) ** 2) / 0.1)
            + rng.normal(0, 0.5, (n, n))).astype(np.float32)


def measure_dem(n: int = 2048) -> np.ndarray:
    """scripts/measure_geospatial.py's dem_for(n), from a fresh rng(0)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:n, 0:n] / n
    return (50 * np.exp(-((yy - 0.5) ** 2 + (xx - 0.5) ** 2) / 0.1)
            + 5 * np.sin(8 * np.pi * xx) * np.sin(6 * np.pi * yy)
            + rng.normal(0, 0.5, (n, n))).astype(np.float32)


def _dem_setup(make, n):
    def setup(device):
        dem = torch.from_numpy(make(n)).to(device)
        return {"dem": dem, "cost": torch.abs(dem) * 0.01 + 1.0,
                "src": (n // 2, n // 2)}
    return setup


def _suite_call(d):
    return (D.terrain_derivatives(d["dem"]),
            D.viewshed(d["dem"], d["src"], n_samples=64))


def _pc_setup(device):
    pc = synthetic_point_cloud(1_000_000, seed=0)
    return {"pc": pc, "classified": P.classify_ground(pc, 2.0,
                                                      device=device),
            "device": device}


def _raster(statistic):
    return lambda d: P.rasterize_dem(d["pc"], 2.0, statistic,
                                     device=d["device"])[0]


N_DEM = 2048
PC_POINTS = 1_000_000

GEO_PATHS = {
    "geo_suite_512": ImagingPath(
        "njw_tpu/bench/suite.py:321-368", _dem_setup(suite_dem, 512),
        {"derivatives_viewshed": Call(_suite_call, 512 * 512, "cells/s",
                                      True)}),
    "dem_2048": ImagingPath(
        "scripts/measure_geospatial.py:40-75; BENCH_NOTES.md:679-708",
        _dem_setup(measure_dem, N_DEM),
        {"terrain_derivatives": Call(
            lambda d: D.terrain_derivatives(d["dem"]), N_DEM ** 2,
            "cells/s", True),
         "viewshed": Call(lambda d: D.viewshed(d["dem"], d["src"],
                                               n_samples=64),
                          N_DEM ** 2, "cells/s", True),
         "fill_sinks": Call(lambda d: D.fill_sinks(d["dem"]), N_DEM ** 2,
                            "cells/s", False, reps=1),
         "flow_push": Call(lambda d: D.flow_accumulation(d["dem"]),
                           N_DEM ** 2, "cells/s", False, reps=2),
         "flow_doubling": Call(
             lambda d: D.flow_accumulation(d["dem"], method="doubling"),
             N_DEM ** 2, "cells/s", False, reps=2),
         "cost_distance": Call(lambda d: D.cost_distance(d["cost"],
                                                         d["src"]),
                               N_DEM ** 2, "cells/s", False, reps=1),
         "least_cost_path": Call(
             lambda d: D.least_cost_path(d["cost"], d["src"], (0, 0)),
             N_DEM ** 2, "cells/s", False, reps=1),
         "hydrology": Call(
             lambda d: D.DEMProcessor(d["dem"]).hydrology(), N_DEM ** 2,
             "cells/s", False, reps=1)}),
    "point_cloud_1m": ImagingPath(
        "njw_tpu/geospatial/datasets.py:32 at a LiDAR tile's size",
        _pc_setup, {
            **{f"rasterize_{st}": Call(_raster(st), PC_POINTS, "points/s",
                                       False, nan_ok=True)
               for st in ("min", "max", "mean")},
            "classify_ground": Call(
                lambda d: P.classify_ground(d["pc"], 2.0,
                                            device=d["device"]),
                PC_POINTS, "points/s", False),
            "compute_normals": Call(
                lambda d: P.compute_normals(d["pc"], 2.0,
                                            device=d["device"]),
                PC_POINTS, "points/s", False),
            "extract_buildings": Call(
                lambda d: P.extract_buildings(d["classified"], 2.0,
                                              device=d["device"]),
                PC_POINTS, "points/s", False)}),
}

