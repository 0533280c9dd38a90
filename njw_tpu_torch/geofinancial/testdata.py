"""Synthetic geo-financial test data.

Counterpart of ``njw_tpu/geofinancial/testdata.py``, copied (NumPy, so a
seed gives the same DEM, assets and returns in both packages): fractal
DEM (``njw_tpu_torch.geospatial.datasets.synthetic_dem``), spatially
clustered asset portfolios and correlated return series.

CLI: python -m njw_tpu_torch.geofinancial.testdata --out DIR [--size N]
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import GeospatialPortfolio


def generate_dem(size: int = 512, *, roughness: float = 0.5,
                 relief: float = 100.0, seed: int = 0) -> np.ndarray:
    """Fractal terrain (ref: generate_test_data.py:34) — delegates to the
    geospatial spectral-synthesis generator (one implementation)."""
    from njw_tpu_torch.geospatial.datasets import synthetic_dem

    return synthetic_dem(size, roughness=roughness, relief=relief,
                         seed=seed)


def generate_assets(
    n_assets: int = 50, *, extent: float = 512.0, n_clusters: int = 5,
    value_range: tuple = (1e6, 1e8), cluster_radius: Optional[float] = None,
    seed: int = 0,
) -> GeospatialPortfolio:
    """Spatially clustered portfolio (ref: generate_test_data.py:106):
    assets around n_clusters urban centers, log-uniform values."""
    rng = np.random.default_rng(seed)
    radius = cluster_radius or extent / 10.0
    centers = rng.uniform(0.1 * extent, 0.9 * extent, (n_clusters, 2))
    which = rng.integers(0, n_clusters, n_assets)
    xy = centers[which] + rng.normal(0.0, radius, (n_assets, 2))
    xy = np.clip(xy, 0.0, extent - 1.0)
    lo, hi = np.log(value_range[0]), np.log(value_range[1])
    values = np.exp(rng.uniform(lo, hi, n_assets))
    sectors = rng.choice(
        ["residential", "commercial", "industrial", "infrastructure"],
        n_assets)
    port = GeospatialPortfolio()
    for i in range(n_assets):
        port.add_asset(
            f"asset_{i:04d}", f"Asset {i}", float(values[i]),
            float(xy[i, 0]), float(xy[i, 1]),
            metadata={"sector": str(sectors[i]),
                      "cluster": int(which[i])})
    return port


def generate_returns(
    n_assets: int = 50, n_days: int = 252, *, annual_vol: float = 0.2,
    annual_drift: float = 0.05, market_beta: float = 0.6, seed: int = 0,
) -> np.ndarray:
    """(n_days, n_assets) daily simple returns with a one-factor market
    correlation structure (ref: generate_test_data.py:233)."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / 252.0
    vol = annual_vol * np.sqrt(dt)
    mu = annual_drift * dt
    market = rng.normal(0.0, 1.0, (n_days, 1))
    idio = rng.normal(0.0, 1.0, (n_days, n_assets))
    shocks = market_beta * market + np.sqrt(1 - market_beta ** 2) * idio
    return (mu + vol * shocks).astype(np.float32)


def generate_price_series(returns: np.ndarray,
                          p0: float = 100.0) -> np.ndarray:
    """Returns -> price paths (cumulative product, row 0 = p0)."""
    r = np.asarray(returns, np.float64)
    prices = p0 * np.cumprod(1.0 + r, axis=0)
    return np.vstack([np.full((1,) + r.shape[1:], p0), prices]) \
        .astype(np.float32)


def generate_dataset(out_dir: str, *, size: int = 256, n_assets: int = 50,
                     n_days: int = 252, seed: int = 0) -> dict:
    """Write a complete test dataset (DEM npz + assets CSV + returns CSV);
    returns the file map (ref: generate_test_data.py:412 main)."""
    import csv

    from njw_tpu_torch.geofinancial.data import (
        AssetLocationDataLoader, GeoRiskDataLoader,
    )

    os.makedirs(out_dir, exist_ok=True)
    dem = generate_dem(size, seed=seed)
    dem_path = GeoRiskDataLoader.save_dem(
        os.path.join(out_dir, "dem.npz"), dem)
    port = generate_assets(n_assets, extent=float(size), seed=seed)
    assets_path = AssetLocationDataLoader.save_asset_csv(
        port, os.path.join(out_dir, "assets.csv"))
    returns = generate_returns(n_assets, n_days, seed=seed)
    returns_path = os.path.join(out_dir, "returns.csv")
    with open(returns_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["day"] + [a.id for a in port.assets])
        for t in range(n_days):
            w.writerow([t] + [f"{x:.6f}" for x in returns[t]])
    return {"dem": dem_path, "assets": assets_path,
            "returns": returns_path}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="njw_tpu_torch.geofinancial.testdata")
    p.add_argument("--out", default="./geofin_test_data")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--assets", type=int, default=50)
    p.add_argument("--days", type=int, default=252)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    files = generate_dataset(args.out, size=args.size,
                             n_assets=args.assets, n_days=args.days,
                             seed=args.seed)
    for k, v in files.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
