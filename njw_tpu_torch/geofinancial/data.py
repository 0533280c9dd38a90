"""Geo-financial data connectors: file ingestion into the risk stack.

Counterpart of ``njw_tpu/geofinancial/data.py``, copied: the same CSV,
GeoJSON and DEM npz formats (stdlib and NumPy IO only), so a file written
by either package loads in the other:

* assets: CSV / GeoJSON -> GeospatialPortfolio
* financials: returns CSV, returns-from-prices, attach to assets
* rasters: npz DEM / risk-surface files -> SpatialRiskFactor
"""
from __future__ import annotations

import csv
import json
import os
from typing import Optional

import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, GeoTransform, IDENTITY_TRANSFORM,
    SpatialRiskFactor, _normalize,
)


class AssetLocationDataLoader:
    """ref: data_connectors.py:25 — asset location ingestion."""

    @staticmethod
    def load_asset_csv(path: str, *, id_col: str = "id",
                       name_col: str = "name", value_col: str = "value",
                       x_col: str = "x", y_col: str = "y") -> GeospatialPortfolio:
        port = GeospatialPortfolio()
        with open(path, newline="") as fh:
            for i, row in enumerate(csv.DictReader(fh)):
                meta = {k: v for k, v in row.items()
                        if k not in (id_col, name_col, value_col,
                                     x_col, y_col)}
                port.add_asset(
                    row.get(id_col, f"asset_{i}"),
                    row.get(name_col, f"Asset {i}"),
                    float(row[value_col]), float(row[x_col]),
                    float(row[y_col]), metadata=meta)
        return port

    @staticmethod
    def load_asset_geojson(path: str,
                           value_prop: str = "value") -> GeospatialPortfolio:
        """Point-feature GeoJSON (ref: data_connectors.py:71)."""
        with open(path) as fh:
            doc = json.load(fh)
        port = GeospatialPortfolio()
        for i, feat in enumerate(doc.get("features", [])):
            geom = feat.get("geometry", {})
            if geom.get("type") != "Point":
                continue
            x, y = geom["coordinates"][:2]
            props = dict(feat.get("properties", {}))
            value = float(props.pop(value_prop, 0.0))
            port.add_asset(
                str(props.pop("id", f"asset_{i}")),
                str(props.pop("name", f"Asset {i}")),
                value, float(x), float(y), metadata=props)
        return port

    @staticmethod
    def save_asset_csv(port: GeospatialPortfolio, path: str) -> str:
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["id", "name", "value", "x", "y"])
            for a in port.assets:
                w.writerow([a.id, a.name, a.value, a.x, a.y])
        return path


class FinancialDataLoader:
    """ref: data_connectors.py:139 — returns/prices ingestion."""

    @staticmethod
    def load_returns_csv(path: str) -> dict[str, np.ndarray]:
        """Wide CSV (first column date, one column per asset id) ->
        {asset_id: returns array} (ref: data_connectors.py:148)."""
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh))
        header, data = rows[0], rows[1:]
        out = {}
        for j, col in enumerate(header[1:], start=1):
            out[col] = np.array([float(r[j]) for r in data], np.float32)
        return out

    @staticmethod
    def calculate_returns_from_prices(prices: np.ndarray,
                                      log_returns: bool = False) -> np.ndarray:
        """(T,) or (T, n) prices -> (T-1, ...) simple or log returns
        (ref: data_connectors.py:192)."""
        p = np.asarray(prices, np.float64)
        if log_returns:
            return np.log(p[1:] / p[:-1]).astype(np.float32)
        return ((p[1:] - p[:-1]) / p[:-1]).astype(np.float32)

    @staticmethod
    def attach_returns_to_assets(port: GeospatialPortfolio,
                                 returns: dict[str, np.ndarray]) -> int:
        """Store per-asset return series in asset metadata
        (ref: data_connectors.py:233). Returns #matched."""
        n = 0
        for a in port.assets:
            if a.id in returns:
                r = np.asarray(returns[a.id], np.float32)
                a.metadata["returns"] = r
                a.metadata["volatility"] = float(r.std())
                n += 1
        return n


class GeoRiskDataLoader:
    """ref: data_connectors.py:260 — raster ingestion (npz in the
    GeoTIFF role; this image has no GDAL)."""

    @staticmethod
    def save_dem(path: str, dem: np.ndarray,
                 transform: Optional[GeoTransform] = None) -> str:
        t = transform or IDENTITY_TRANSFORM
        np.savez_compressed(
            path, dem=np.asarray(dem, np.float32),
            transform=np.array([t.origin_x, t.origin_y, t.pixel_width,
                                t.pixel_height], np.float64))
        return path if path.endswith(".npz") else path + ".npz"

    @staticmethod
    def load_dem(path: str) -> tuple[np.ndarray, GeoTransform]:
        d = np.load(path)
        dem = d["dem"]
        if "transform" in d:
            ox, oy, pw, ph = d["transform"]
            t = GeoTransform(origin_x=ox, origin_y=oy, pixel_width=pw,
                             pixel_height=ph)
        else:
            t = IDENTITY_TRANSFORM
        return dem, t

    @staticmethod
    def load_raster_as_risk_factor(
        path: str, name: str, weight: float = 1.0, *,
        invert: bool = False, description: str = "",
    ) -> SpatialRiskFactor:
        """npz raster -> normalized [0,1] SpatialRiskFactor
        (ref: data_connectors.py:281 load_geotiff_as_risk_factor)."""
        dem, t = GeoRiskDataLoader.load_dem(path)
        return SpatialRiskFactor(
            name=name, risk_weight=weight,
            risk_data=_normalize(dem, invert=invert),
            geo_transform=t, description=description)


def export_portfolio_geojson(port: GeospatialPortfolio, path: str,
                             risks: Optional[dict] = None) -> str:
    """Portfolio -> point-feature GeoJSON (with optional per-asset risk),
    the dashboard/map interchange format."""
    feats = []
    for a in port.assets:
        props = {"id": a.id, "name": a.name, "value": a.value}
        if risks and a.id in risks:
            props["risk"] = float(risks[a.id])
        feats.append({
            "type": "Feature",
            "geometry": {"type": "Point", "coordinates": [a.x, a.y]},
            "properties": props,
        })
    doc = {"type": "FeatureCollection", "features": feats}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
