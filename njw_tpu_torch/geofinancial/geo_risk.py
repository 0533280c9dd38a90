"""Spatial risk factors and the geospatial portfolio risk model.

Counterpart of ``njw_tpu/geofinancial/geo_risk.py``. A factor is a NumPy
float32 surface in [0, 1], sampled bilinearly at asset locations on the
host, as in the JAX package. The factors built from terrain run the DEM
functions of ``njw_tpu_torch.geospatial`` on ``device`` (CUDA unless
given; a tensor DEM stays on its own device) and bring the surface back
as float32 NumPy: slope by ``terrain_derivatives``, flood risk by
``fill_sinks`` and ``flow_accumulation`` with their cycles and rounds
capped at ``n_iterations`` (the cap bounds the drainage path resolved,
as in the JAX package; it is not run to convergence).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from njw_tpu_torch.geospatial.dem import (
    GeoTransform, fill_sinks, flow_accumulation, terrain_derivatives,
)
from njw_tpu_torch.platform.tensors import to_numpy

# Identity mapping (row = y, col = x). The GDAL default is north-up
# (pixel_height = -1), which flips y; risk surfaces built directly from
# row-major arrays want the identity.
IDENTITY_TRANSFORM = GeoTransform(pixel_height=1.0)


@dataclass
class SpatialRiskFactor:
    """A named risk surface over a geographic grid, sampled at asset
    locations. risk_data in [0, 1]."""

    name: str
    risk_weight: float
    risk_data: np.ndarray
    geo_transform: GeoTransform = field(
        default_factory=lambda: IDENTITY_TRANSFORM)
    description: str = ""

    def __post_init__(self):
        self.risk_data = np.clip(np.asarray(to_numpy(self.risk_data),
                                            np.float32), 0.0, 1.0)

    def sample(self, x, y) -> np.ndarray:
        """Bilinear-sample the risk surface at geo coords (vectorized)."""
        row, col = self.geo_transform.geo_to_pixel(np.asarray(x),
                                                   np.asarray(y))
        h, w = self.risk_data.shape
        r0 = np.clip(np.floor(row).astype(int), 0, h - 2)
        c0 = np.clip(np.floor(col).astype(int), 0, w - 2)
        fr = np.clip(row - r0, 0.0, 1.0)
        fc = np.clip(col - c0, 0.0, 1.0)
        d = self.risk_data
        return ((1 - fr) * (1 - fc) * d[r0, c0]
                + (1 - fr) * fc * d[r0, c0 + 1]
                + fr * (1 - fc) * d[r0 + 1, c0]
                + fr * fc * d[r0 + 1, c0 + 1])


def _normalize(a, invert: bool = False) -> np.ndarray:
    a = np.asarray(to_numpy(a), np.float32)
    lo, hi = np.nanmin(a), np.nanmax(a)
    n = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    return 1.0 - n if invert else n


def create_elevation_risk_factor(dem, weight: float = 1.0,
                                 geo_transform=IDENTITY_TRANSFORM,
                                 low_is_risky: bool = True):
    """Low-lying terrain is risky (flooding); NumPy on the host."""
    return SpatialRiskFactor(
        "elevation_risk", weight, _normalize(dem, invert=low_is_risky),
        geo_transform, "normalized (inverse) elevation")


def create_slope_risk_factor(dem, weight: float = 1.0,
                             geo_transform=IDENTITY_TRANSFORM,
                             cell_size: float = 1.0, *, device=None):
    """Steep slopes are risky (landslide): Horn's slope on ``device``."""
    slope = to_numpy(terrain_derivatives(dem, cell_size,
                                         device=device)["slope"])
    return SpatialRiskFactor("slope_risk", weight, _normalize(slope),
                             geo_transform, "normalized slope")


def create_flood_risk_factor(dem, weight: float = 1.0,
                             geo_transform=IDENTITY_TRANSFORM,
                             n_iterations: int = 128, *, device=None):
    """Flow accumulation + low elevation -> flood risk. fill_sinks and
    flow_accumulation run on ``device``, both capped at n_iterations."""
    filled = fill_sinks(dem, n_iterations, device=device)
    acc = to_numpy(flow_accumulation(filled, n_iterations))
    risk = 0.5 * _normalize(np.log1p(acc)) + 0.5 * _normalize(dem, invert=True)
    return SpatialRiskFactor("flood_risk", weight, risk, geo_transform,
                             "flow accumulation + low elevation")


class GeospatialRiskModel:
    """Weighted combination of spatial risk factors."""

    def __init__(self, risk_factors: Optional[list] = None):
        self.risk_factors: list[SpatialRiskFactor] = risk_factors or []

    def add_risk_factor(self, rf: SpatialRiskFactor):
        self.risk_factors.append(rf)
        return self

    def assess_risk(self, x, y) -> np.ndarray:
        """Weighted average of factor risks at asset locations."""
        if not self.risk_factors:
            return np.zeros_like(np.asarray(x, np.float32))
        total_w = sum(rf.risk_weight for rf in self.risk_factors)
        acc = np.zeros_like(np.asarray(x, np.float32))
        for rf in self.risk_factors:
            acc = acc + rf.risk_weight * rf.sample(x, y)
        return acc / max(total_w, 1e-12)


@dataclass
class Asset:
    id: str
    name: str
    value: float
    x: float
    y: float
    metadata: dict = field(default_factory=dict)
    returns: Optional[np.ndarray] = None  # daily simple returns, oldest first


class GeospatialPortfolio:
    """Assets with locations and values; risk assessed for all assets at
    once by one vectorised sample."""

    def __init__(self, assets: Optional[list[Asset]] = None):
        self.assets: list[Asset] = assets or []

    def add_asset(self, id, name, value, x, y, metadata=None,
                  returns=None):
        self.assets.append(Asset(
            id, name, value, x, y, metadata or {},
            None if returns is None else np.asarray(returns, np.float64)))
        return self

    @property
    def total_value(self) -> float:
        return float(sum(a.value for a in self.assets))

    def coords(self):
        return (np.asarray([a.x for a in self.assets], np.float32),
                np.asarray([a.y for a in self.assets], np.float32))

    def assess_risk(self, model: GeospatialRiskModel) -> dict[str, float]:
        """Per-asset risk scores keyed by asset id."""
        if not self.assets:
            return {}
        x, y = self.coords()
        scores = model.assess_risk(x, y)
        return {a.id: float(s) for a, s in zip(self.assets, scores)}

    def value_at_risk(self, model: GeospatialRiskModel,
                      threshold: float = 0.5) -> float:
        """Total value of assets whose risk exceeds the threshold."""
        risks = self.assess_risk(model)
        return float(sum(a.value for a in self.assets
                         if risks[a.id] >= threshold))

    def expected_loss(self, model: GeospatialRiskModel,
                      damage_ratio: float = 1.0) -> float:
        risks = self.assess_risk(model)
        return float(sum(a.value * risks[a.id] * damage_ratio
                         for a in self.assets))

    # -- returns-based metrics -------------------------------------------

    def _asset_returns(self, lookback_days: int) -> np.ndarray:
        """(n_assets, lookback) return matrix; raises when any asset lacks
        history."""
        rows = []
        for a in self.assets:
            if a.returns is None or len(a.returns) < lookback_days:
                raise ValueError(
                    f"Asset {a.id} has insufficient returns data")
            rows.append(np.asarray(a.returns,
                                   np.float64)[-lookback_days:])
        return np.stack(rows)

    def calculate_var(self, confidence_level: float = 0.95,
                      lookback_days: int = 252,
                      method: str = "historical") -> float:
        """Value-weighted portfolio VaR from asset return histories (a
        single series: the host's NumPy methods)."""
        from njw_tpu_torch.geofinancial.risk_metrics import (
            RiskMetricsAnalyzer,
        )

        asset_returns = self._asset_returns(lookback_days)
        total = self.total_value
        weights = np.asarray([a.value / total for a in self.assets])
        portfolio_returns = weights @ asset_returns
        return RiskMetricsAnalyzer().calculate_var(
            portfolio_returns, confidence_level, method)

    def optimize_for_geo_risk(self, risk_model: GeospatialRiskModel,
                              target_return: float,
                              max_risk_score: float = 0.5,
                              risk_aversion: float = 1.0,
                              lookback_days: int = 252,
                              max_weight: float = 0.3) -> dict:
        """Mean-variance weights with geo-risk-adjusted expected returns:
        mu_adj = mu - risk_aversion * geo_risk; assets whose geo-risk
        exceeds max_risk_score are excluded (weight 0). Returns
        {asset_id: weight}."""
        from njw_tpu_torch.geofinancial.portfolio import PortfolioOptimizer

        risk_scores = self.assess_risk(risk_model)
        asset_returns = self._asset_returns(lookback_days)
        mu = asset_returns.mean(axis=1)
        cov = np.atleast_2d(np.cov(asset_returns))
        risk = np.asarray([risk_scores[a.id] for a in self.assets])
        adjusted = mu - risk_aversion * risk
        keep = np.flatnonzero(risk <= max_risk_score)
        if keep.size == 0:
            raise ValueError(
                f"no assets with geo-risk <= {max_risk_score}")
        result = PortfolioOptimizer().optimize(
            adjusted[keep], cov[np.ix_(keep, keep)], target_return,
            constraints={"max_weight": max_weight})
        weights = {a.id: 0.0 for a in self.assets}
        for i, k in enumerate(keep):
            weights[self.assets[k].id] = float(result["weights"][i])
        return weights
