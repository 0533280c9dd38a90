"""Multi-region risk analysis.

Counterpart of ``njw_tpu/geofinancial/multiregion.py``: the JAX
package's NumPy code, copied, on the port's ``geo_risk`` (regions, the
regional portfolio with its JSON save and load, the multi-region model,
the comparator, ``make_region_grid``). A file saved by either package
loads in the other.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, GeospatialRiskModel,
)


@dataclass
class RegionDefinition:
    """A named rectangular region (ref: multiregion_analysis.py:56)."""

    name: str
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    metadata: dict = field(default_factory=dict)

    def contains(self, x, y) -> np.ndarray:
        x = np.asarray(x)
        y = np.asarray(y)
        return ((x >= self.x_min) & (x <= self.x_max)
                & (y >= self.y_min) & (y <= self.y_max))


class RegionalPortfolio:
    """Portfolio partitioned by region (ref: multiregion_analysis.py)."""

    def __init__(self, portfolio: GeospatialPortfolio,
                 regions: list[RegionDefinition]):
        self.portfolio = portfolio
        self.regions = regions

    def split(self) -> dict[str, GeospatialPortfolio]:
        x, y = self.portfolio.coords()
        out = {}
        for region in self.regions:
            mask = region.contains(x, y)
            sub = GeospatialPortfolio(
                [a for a, m in zip(self.portfolio.assets, mask) if m])
            out[region.name] = sub
        return out

    def region_of(self, asset) -> str:
        """First region containing the asset, or '_unassigned'."""
        for region in self.regions:
            if bool(region.contains(asset.x, asset.y)):
                return region.name
        return "_unassigned"

    def save(self, file_path: str) -> str:
        """JSON round-trip of regions + assets
        (ref: multiregion_analysis.py:386)."""
        parent = os.path.dirname(file_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        data = {
            "regions": [asdict(r) for r in self.regions],
            "assets": [{
                "id": a.id, "name": a.name, "value": a.value,
                "x": a.x, "y": a.y, "metadata": a.metadata,
                "returns": (None if a.returns is None
                            else np.asarray(a.returns).tolist()),
            } for a in self.portfolio.assets],
        }
        with open(file_path, "w") as fh:
            json.dump(data, fh, indent=2)
        return file_path

    @classmethod
    def load(cls, file_path: str) -> "RegionalPortfolio":
        """ref: multiregion_analysis.py:410."""
        with open(file_path) as fh:
            data = json.load(fh)
        regions = [RegionDefinition(**r) for r in data["regions"]]
        port = GeospatialPortfolio()
        for a in data["assets"]:
            port.add_asset(a["id"], a["name"], a["value"], a["x"],
                           a["y"], a.get("metadata") or {},
                           returns=a.get("returns"))
        return cls(port, regions)


class MultiRegionRiskModel:
    """Per-region risk models + cross-region rollup
    (ref: MultiRegionRiskModel, multiregion_analysis.py:451)."""

    def __init__(self):
        self.region_models: dict[str, GeospatialRiskModel] = {}
        self.regions: dict[str, RegionDefinition] = {}

    def add_region(self, region: RegionDefinition,
                   model: GeospatialRiskModel):
        self.regions[region.name] = region
        self.region_models[region.name] = model
        return self

    def assess(self, portfolio: GeospatialPortfolio) -> dict:
        """Per-region summary: asset count, value, mean risk, expected
        loss; assets outside every region go to '_unassigned'."""
        x, y = portfolio.coords()
        assigned = np.zeros(len(portfolio.assets), bool)
        out = {}
        for name, region in self.regions.items():
            mask = region.contains(x, y) & ~assigned
            assigned |= mask
            sub = GeospatialPortfolio(
                [a for a, m in zip(portfolio.assets, mask) if m])
            model = self.region_models[name]
            risks = sub.assess_risk(model)
            vals = np.asarray([a.value for a in sub.assets])
            rs = np.asarray([risks[a.id] for a in sub.assets]) \
                if sub.assets else np.zeros(0)
            out[name] = {
                "n_assets": len(sub.assets),
                "total_value": float(vals.sum()) if len(vals) else 0.0,
                "mean_risk": float(rs.mean()) if len(rs) else 0.0,
                "expected_loss": float((vals * rs).sum()) if len(rs) else 0.0,
            }
        n_un = int((~assigned).sum())
        if n_un:
            out["_unassigned"] = {"n_assets": n_un}
        return out

    def assess_regional_risks(self, portfolio: GeospatialPortfolio
                              ) -> dict:
        """Per-asset risk scores grouped by region:
        {region: {asset_id: risk}} — the input shape of the analysis
        methods below (ref: multiregion_analysis.py:600
        assess_regional_risks)."""
        x, y = portfolio.coords()
        assigned = np.zeros(len(portfolio.assets), bool)
        out = {}
        for name, region in self.regions.items():
            mask = region.contains(x, y) & ~assigned
            assigned |= mask
            sub = GeospatialPortfolio(
                [a for a, m in zip(portfolio.assets, mask) if m])
            out[name] = sub.assess_risk(self.region_models[name])
        return out

    @staticmethod
    def identify_high_risk_assets(regional_risks: dict,
                                  threshold: float = 0.7,
                                  top_n: int = None) -> dict:
        """Per region: assets at/above the risk threshold, sorted by
        risk, optionally capped at top_n
        (ref: multiregion_analysis.py:644)."""
        out = {}
        for region, scores in regional_risks.items():
            rows = [{"asset_id": aid, "risk_score": s}
                    for aid, s in sorted(scores.items(),
                                         key=lambda kv: kv[1],
                                         reverse=True)
                    if s >= threshold]
            out[region] = rows[:top_n] if top_n else rows
        return out

    @staticmethod
    def calculate_diversification_benefit(
            regional_risks: dict,
            regional_portfolio: "RegionalPortfolio") -> float:
        """Risk reduction from regional diversification: compare the
        value-weighted per-asset risk with the value-weighted per-REGION
        mean risk (region-level pooling smooths idiosyncratic risk);
        benefit = (asset_level - region_level) / asset_level
        (ref: multiregion_analysis.py:684)."""
        value_by_id = {a.id: a.value
                       for a in regional_portfolio.portfolio.assets}
        total = sum(value_by_id.values())
        if total == 0:
            return 0.0
        asset_level = 0.0
        region_value: dict[str, float] = {}
        for region, scores in regional_risks.items():
            for aid, risk in scores.items():
                v = value_by_id.get(aid, 0.0)
                asset_level += (v / total) * risk
                region_value[region] = region_value.get(region, 0.0) + v
        region_level = 0.0
        for region, scores in regional_risks.items():
            if not scores:
                continue
            region_level += (region_value.get(region, 0.0) / total) * \
                float(np.mean(list(scores.values())))
        if asset_level == 0:
            return 0.0
        return (asset_level - region_level) / asset_level

    def perform_cross_region_analysis(
            self, regional_portfolio: "RegionalPortfolio",
            threshold: float = 0.7, top_n: int = 10) -> dict:
        """Comprehensive rollup: per-region stats, high-risk assets,
        inter-region risk correlations, diversification benefit, and an
        inverse-risk allocation recommendation
        (ref: multiregion_analysis.py:736)."""
        portfolio = regional_portfolio.portfolio
        regional_risks = self.assess_regional_risks(portfolio)
        stats = {}
        for region, scores in regional_risks.items():
            vals = np.asarray(list(scores.values()), np.float64)
            stats[region] = {
                "n_assets": len(scores),
                "mean": float(vals.mean()) if len(vals) else 0.0,
                "std": float(vals.std()) if len(vals) else 0.0,
                "max": float(vals.max()) if len(vals) else 0.0,
            }
        # Correlation of the region models' risk fields over ALL asset
        # locations (how co-exposed the regions are).
        x, y = portfolio.coords()
        names = list(self.region_models)
        if len(names) > 1 and len(portfolio.assets) > 1:
            fields = np.stack([
                np.asarray(self.region_models[n].assess_risk(x, y),
                           np.float64) for n in names])
            corr = np.nan_to_num(np.corrcoef(fields), nan=0.0)
        else:
            corr = np.ones((len(names), len(names)))
        diversification = self.calculate_diversification_benefit(
            regional_risks, regional_portfolio)
        # Inverse-risk target allocation over regions with assets.
        mean_risk = np.asarray([max(stats[n]["mean"], 1e-3)
                                for n in names])
        inv = 1.0 / mean_risk
        allocation = {n: float(w) for n, w in zip(names, inv / inv.sum())}
        return {
            "statistics": stats,
            "high_risk_assets": self.identify_high_risk_assets(
                regional_risks, threshold, top_n),
            "risk_correlations": {
                "regions": names, "matrix": corr.tolist()},
            "diversification_benefit": diversification,
            "recommended_allocation": allocation,
        }


class RegionalRiskComparator:
    """Rank regions by risk metrics (ref: RegionalRiskComparator)."""

    def __init__(self, model: MultiRegionRiskModel):
        self.model = model

    def rank(self, portfolio: GeospatialPortfolio,
             by: str = "expected_loss") -> list[tuple[str, float]]:
        summary = self.model.assess(portfolio)
        rows = [(name, stats.get(by, 0.0))
                for name, stats in summary.items()
                if not name.startswith("_")]
        return sorted(rows, key=lambda kv: kv[1], reverse=True)


def make_region_grid(x_min, x_max, y_min, y_max, nx: int, ny: int,
                     prefix: str = "region") -> list[RegionDefinition]:
    """Tile a bounding box into nx x ny regions
    (ref grid helpers: multiregion_analysis.py:1776-1876)."""
    xs = np.linspace(x_min, x_max, nx + 1)
    ys = np.linspace(y_min, y_max, ny + 1)
    out = []
    for j in range(ny):
        for i in range(nx):
            out.append(RegionDefinition(
                f"{prefix}_{j}_{i}", xs[i], xs[i + 1], ys[j], ys[j + 1]))
    return out
