"""The geo-financial paths at full width, defined once.

``chip_smoke.py`` phase 20 drives these on the card and
``scripts/profile_torch.py --model finance`` profiles one call of each;
both take them from here (``Call`` and ``ImagingPath`` are the medical
paths' records). Each setup draws its inputs from a fresh
``np.random.default_rng(0)`` for its own size, or from the seed it names:

  mc_var_500x1m       monte_carlo_var at 0.95 and 0.99 with the CVaR, equal
                      weights, 500 assets x 10^6 samples
                      (configs/financial_benchmark.yaml tpu_scale); mean
                      and covariance by scripts/measure_financial.py:78-81
                      (a = normal x 0.01, cov = a a^T + 1e-4 I, mean
                      normal(4e-4, 2e-4))
  mc_var_500x10k      the same at 10^4 samples (the yaml's yaml_large)
  mc_wealth_100x10k   monte_carlo_simulation, equal weights, 100 assets,
                      10 000 paths x 252 days (the yaml's
                      wealth_simulation), the same mean and covariance
                      recipe
  options_chain_1024  a desk's chain of 32 strikes (70-130) x 32 maturities
                      (0.1-2.0 y), spot 100, r 0.05, sigma 0.2:
                      black_scholes (call and put) and greeks over it, the
                      American put by binomial_tree at 300 steps over it
                      (examples/financial_modeling_example.py:103-116
                      prices one option each, the tree at 300 steps), one
                      up-and-out barrier at 130 and one Asian call at their
                      defaults (100 000 paths x 252 steps, seed 0)
  geofin_pipeline_2048  examples/geofinancial_example.py:57-113 without the
                      HTML report: generate_dem(2048, seed=11) (the terrain
                      paths' full width), flood (weight 1.0) and elevation
                      (0.5) factors, generate_assets(10 000, extent 2048,
                      seed=11), expected_loss, the climate, economic and
                      stress sets with VaR at 0.95 and 0.99, a 4 x 4 region
                      ranking by expected loss
"""
from __future__ import annotations

import numpy as np

from njw_tpu_torch.geofinancial import options as O
from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialRiskModel, create_elevation_risk_factor,
    create_flood_risk_factor,
)
from njw_tpu_torch.geofinancial.multiregion import (
    MultiRegionRiskModel, RegionalRiskComparator, make_region_grid,
)
from njw_tpu_torch.geofinancial.portfolio import (
    monte_carlo_simulation, terminal_wealth,
)
from njw_tpu_torch.geofinancial.risk_metrics import (
    monte_carlo_var, portfolio_samples, standard_normals,
)
from njw_tpu_torch.geofinancial.scenarios import (
    ScenarioAnalyzer, create_climate_scenarios, create_economic_scenarios,
    create_stress_scenarios,
)
from njw_tpu_torch.geofinancial.testdata import generate_assets, generate_dem
from njw_tpu_torch.medical.main_paths import Call, ImagingPath
from njw_tpu_torch.platform.tensors import as_tensor

CONFIDENCES = (0.95, 0.99)
SPOT, RATE, VOL = 100.0, 0.05, 0.2
TREE_STEPS = 300
BARRIER = 130.0
MC_PATHS, MC_STEPS = 100_000, 252     # the exotics' defaults
WEALTH_PATHS, HORIZON = 10_000, 252
N_DEM, N_SITES, GEO_SEED = 2048, 10_000, 11
SCENARIO_SETS = {"climate": create_climate_scenarios,
                 "economic": create_economic_scenarios,
                 "stress": create_stress_scenarios}


def market(n_assets: int):
    """scripts/measure_financial.py:78-81's daily mean and covariance, from
    a fresh rng(0): (mean, cov, equal weights, the Cholesky factor that
    the Monte-Carlo functions take)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n_assets, n_assets)) * 0.01
    cov = a @ a.T + 1e-4 * np.eye(n_assets)
    mean = rng.normal(4e-4, 2e-4, n_assets)
    chol = np.linalg.cholesky(cov + 1e-12 * np.eye(n_assets))
    return mean, cov, np.full(n_assets, 1.0 / n_assets), chol


def option_chain():
    """(strikes, maturities) of the chain, strike-major, as NumPy."""
    k, t = np.meshgrid(np.linspace(70.0, 130.0, 32),
                       np.linspace(0.1, 2.0, 32), indexing="ij")
    return k.ravel(), t.ravel()


def _market_setup(n_assets):
    def setup(device):
        mean, cov, w, chol = market(n_assets)
        return {"device": device, "mean": mean, "cov": cov, "weights": w,
                "mean32": as_tensor(mean, device),
                "chol32": as_tensor(chol, device),
                "w32": as_tensor(w, device)}
    return setup


def _var_call(n_samples, confidence):
    def call(d):
        return monte_carlo_var(mean=d["mean"], cov=d["cov"],
                               weights=d["weights"], n_samples=n_samples,
                               confidence=confidence, return_cvar=True,
                               device=d["device"])

    def device_part(d):
        z = standard_normals((n_samples, d["mean"].size), 0, d["device"])
        return portfolio_samples(z, d["mean32"], d["chol32"], d["w32"])
    return Call(call, n_samples, "samples/s", False, device_fn=device_part)


def _var_path(n_samples, source):
    return ImagingPath(source, _market_setup(500), {
        f"var_cvar_{round(c * 100)}": _var_call(n_samples, c)
        for c in CONFIDENCES})


def _wealth(d):
    return monte_carlo_simulation(d["weights"], mean=d["mean"], cov=d["cov"],
                                  n_paths=WEALTH_PATHS, horizon=HORIZON,
                                  device=d["device"])


def _wealth_device(d):
    z = standard_normals((WEALTH_PATHS * HORIZON, d["mean"].size), 0,
                         d["device"])
    return terminal_wealth(z, d["w32"], d["mean32"], d["chol32"],
                           WEALTH_PATHS, HORIZON)


def _chain_setup(device):
    k, t = option_chain()
    n = k.size
    args = (np.full(n, SPOT), k, t, np.full(n, RATE), np.full(n, VOL))
    return {"device": device, "args": args,
            "t32": [as_tensor(a, device) for a in args]}


def _prices(d):
    return tuple(O.black_scholes(*d["args"], kind, device=d["device"])
                 for kind in ("call", "put"))


def _tree(d):
    return O.binomial_tree(*d["args"], n_steps=TREE_STEPS, kind="put",
                           american=True, device=d["device"])


def _paths_device(d):
    z = standard_normals((MC_PATHS, MC_STEPS), 0, d["device"])
    return O.gbm_paths(z, SPOT, 1.0, RATE, VOL).double()


def _options_calls():
    n = option_chain()[0].size
    return {
        "black_scholes": Call(
            _prices, 2 * n, "options/s", False,
            device_fn=lambda d: (O._bs(*d["t32"], True),
                                 O._bs(*d["t32"], False))),
        "greeks": Call(
            lambda d: O.greeks(*d["args"], device=d["device"]), n,
            "options/s", False,
            device_fn=lambda d: O._greeks(*d["t32"], True)),
        "american_put_tree": Call(
            _tree, n, "options/s", False,
            device_fn=lambda d: O._binomial(*d["t32"], TREE_STEPS, False,
                                            True)),
        "barrier_up_out": Call(
            lambda d: O.barrier_option_price(SPOT, 100.0, BARRIER, 1.0, RATE,
                                             VOL, device=d["device"]),
            MC_PATHS * MC_STEPS, "path-days/s", False,
            device_fn=lambda d: O._barrier_stats(
                _paths_device(d), 100.0, BARRIER, 1.0, RATE, "call",
                "up-and-out")),
        "asian": Call(
            lambda d: O.asian_option_price(SPOT, 100.0, 1.0, RATE, VOL,
                                           device=d["device"]),
            MC_PATHS * MC_STEPS, "path-days/s", False,
            device_fn=lambda d: O._asian_stats(_paths_device(d), 100.0, 1.0,
                                               RATE, "call")),
    }


def risk_model(dem, device) -> GeospatialRiskModel:
    """The example's model: flood (weight 1.0) and elevation (0.5)."""
    return GeospatialRiskModel([
        create_flood_risk_factor(dem, weight=1.0, device=device),
        create_elevation_risk_factor(dem, weight=0.5)])


def analysis(portfolio, model, extent: float, regions=(4, 4)) -> dict:
    """The example's analysis (examples/geofinancial_example.py:65-104):
    per-asset risks, expected loss, each scenario set with its VaR at
    each of CONFIDENCES, the regions ranked by expected loss. NumPy on
    the host."""
    analyzer = ScenarioAnalyzer(portfolio, model)
    sets = {}
    for name, make in SCENARIO_SETS.items():
        sset = make()
        agg = analyzer.evaluate_set(sset)
        sets[name] = {"expected_loss": agg["expected_loss"],
                      "worst_case": agg["worst_case"],
                      "worst_loss": agg["worst_loss"],
                      "var": {c: analyzer.var(sset, c)
                              for c in CONFIDENCES}}
    mrm = MultiRegionRiskModel()
    for region in make_region_grid(0.0, extent, 0.0, extent, *regions):
        mrm.add_region(region, model)
    x, y = portfolio.coords()
    return {"risks": model.assess_risk(x, y),
            "total_value": portfolio.total_value,
            "expected_loss": portfolio.expected_loss(model),
            "scenario_sets": sets,
            "regions": RegionalRiskComparator(mrm).rank(portfolio)}


def _pipeline_setup(device):
    return {"device": device, "dem": generate_dem(N_DEM, seed=GEO_SEED),
            "portfolio": generate_assets(N_SITES, extent=float(N_DEM),
                                         seed=GEO_SEED)}


def _model_call(d):
    d["model"] = risk_model(d["dem"], d["device"])
    return d["model"]


FINANCE_PATHS = {
    "mc_var_500x1m": _var_path(
        10 ** 6, "configs/financial_benchmark.yaml tpu_scale; "
        "scripts/measure_financial.py:78-81"),
    "mc_var_500x10k": _var_path(
        10_000, "configs/financial_benchmark.yaml yaml_large; "
        "scripts/measure_financial.py:78-81"),
    "mc_wealth_100x10k": ImagingPath(
        "configs/financial_benchmark.yaml wealth_simulation; "
        "scripts/measure_financial.py:78-81", _market_setup(100),
        {"simulate": Call(_wealth, WEALTH_PATHS * HORIZON, "path-days/s",
                          False, device_fn=_wealth_device)}),
    "options_chain_1024": ImagingPath(
        "examples/financial_modeling_example.py:103-116 over a 32 x 32 "
        "chain; njw_tpu/geofinancial/options.py:90-92", _chain_setup,
        _options_calls()),
    "geofin_pipeline_2048": ImagingPath(
        "examples/geofinancial_example.py:57-113 at --dem-size 2048 "
        "--assets 10000 --regions 4 4", _pipeline_setup,
        {"risk_model": Call(_model_call, N_DEM ** 2, "cells/s", False,
                            reps=1),
         "analysis": Call(lambda d: analysis(d["portfolio"], d["model"],
                                             float(N_DEM)),
                          N_SITES, "assets/s", False, reps=1)}),
}
