"""Geospatial benchmark metrics: time-stamped series, raster and
point-cloud throughput helpers, per-operation records, cost and energy
efficiency, and accuracy measures of outputs against an oracle.

The port's own copy of ``njw_tpu/geospatial/metrics.py`` (no array
library beyond NumPy).
"""
from __future__ import annotations

import time
from typing import Any, Optional


class GeospatialMetrics:
    """Time-stamped metric series + geospatial throughput helpers."""

    def __init__(self):
        self._series: dict[str, list[dict]] = {}

    # --- generic series (ref :46-113) ----------------------------------
    def record_metric(self, name: str, value: Any,
                      timestamp: Optional[float] = None):
        self._series.setdefault(name, []).append(
            {"value": value, "timestamp": timestamp or time.time()})

    def get_metric(self, name: str) -> list[dict]:
        return list(self._series.get(name, []))

    def get_latest_metric(self, name: str):
        s = self._series.get(name)
        return s[-1]["value"] if s else None

    def get_average_metric(self, name: str) -> Optional[float]:
        s = self._series.get(name)
        if not s:
            return None
        vals = [float(e["value"]) for e in s]
        return sum(vals) / len(vals)

    # --- throughput helpers (ref :113-157) ------------------------------
    def calculate_raster_throughput(self, operation: str, width: int,
                                    height: int, seconds: float) -> float:
        tp = width * height / max(seconds, 1e-12)   # cells/s
        self.record_metric(f"{operation}_throughput_cells_per_s", tp)
        return tp

    def calculate_point_cloud_throughput(self, operation: str,
                                         num_points: int,
                                         seconds: float) -> float:
        tp = num_points / max(seconds, 1e-12)       # points/s
        self.record_metric(f"{operation}_throughput_points_per_s", tp)
        return tp

    # --- per-operation records (ref :157-226) ---------------------------
    def record_viewshed_performance(self, width, height, seconds):
        return self.calculate_raster_throughput("viewshed", width, height,
                                                seconds)

    def record_dem_derivatives_performance(self, width, height, seconds):
        return self.calculate_raster_throughput("dem_derivatives", width,
                                                height, seconds)

    def record_hydro_features_performance(self, width, height, seconds):
        return self.calculate_raster_throughput("hydro_features", width,
                                                height, seconds)

    def record_point_classification_performance(self, n_points, seconds):
        return self.calculate_point_cloud_throughput(
            "point_classification", n_points, seconds)

    def record_surface_reconstruction_performance(self, n_points, seconds):
        return self.calculate_point_cloud_throughput(
            "surface_reconstruction", n_points, seconds)

    def record_feature_extraction_performance(self, n_points, seconds):
        return self.calculate_point_cloud_throughput(
            "feature_extraction", n_points, seconds)

    # --- efficiency (ref :226-260) --------------------------------------
    def record_cost_efficiency(self, operation: str, cost: float,
                               throughput: float) -> float:
        eff = throughput / max(cost, 1e-12)
        self.record_metric(f"{operation}_throughput_per_dollar", eff)
        return eff

    def record_energy_efficiency(self, operation: str, joules: float,
                                 throughput: float) -> float:
        eff = throughput / max(joules, 1e-12)
        self.record_metric(f"{operation}_throughput_per_joule", eff)
        return eff

    def summary(self) -> dict[str, float]:
        return {k: self.get_average_metric(k) for k in sorted(self._series)}


# --- accuracy metrics (validation of accelerated vs oracle outputs) -----

def raster_rmse(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def viewshed_agreement(a, b) -> float:
    """Fraction of cells with identical visibility classification."""
    import numpy as np

    return float(np.mean(np.asarray(a, bool) == np.asarray(b, bool)))


def classification_scores(pred, truth) -> dict:
    """Per-class precision/recall/F1 for point classifications."""
    import numpy as np

    pred = np.asarray(pred)
    truth = np.asarray(truth)
    out = {}
    for cls in np.unique(truth):
        tp = int(np.sum((pred == cls) & (truth == cls)))
        fp = int(np.sum((pred == cls) & (truth != cls)))
        fn = int(np.sum((pred != cls) & (truth == cls)))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        out[int(cls)] = {"precision": prec, "recall": rec, "f1": f1}
    return out
