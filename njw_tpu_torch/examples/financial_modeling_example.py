"""Financial-modeling walkthrough: risk metrics, portfolio optimisation
and options pricing, and the geo-risk-adjusted optimisation of a
geospatial portfolio. Counterpart of
``examples/financial_modeling_example.py``.

Synthetic correlated returns -> VaR/CVaR (historical, parametric,
Monte-Carlo on the device) -> mean-variance frontier / risk parity /
Black-Litterman -> options pricing with autograd Greeks -> geospatial
portfolio: value-weighted VaR and geo-risk-adjusted weights.

    python -m njw_tpu_torch.examples.financial_modeling_example \\
        --assets 50 --json
"""
import argparse
import json

import numpy as np

from njw_tpu_torch.examples._common import add_device
from njw_tpu_torch.geofinancial import (
    GeospatialRiskModel, RiskMetricsAnalyzer, PortfolioOptimizer,
    create_elevation_risk_factor, generate_assets, generate_dem,
    monte_carlo_var, risk_parity, efficient_frontier, black_litterman,
    monte_carlo_simulation, black_scholes, greeks, binomial_tree,
    barrier_option_price, asian_option_price,
)
from njw_tpu_torch.geofinancial.risk_metrics import (
    covariance_matrix, max_drawdown, risk_attribution, sharpe_ratio,
)
from njw_tpu_torch.geofinancial.testdata import generate_returns
from njw_tpu_torch.platform.device import require_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.financial_modeling_example",
        description=__doc__)
    p.add_argument("--assets", type=int, default=50)
    p.add_argument("--days", type=int, default=756)
    p.add_argument("--mc-samples", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--json", action="store_true")
    add_device(p)
    args = p.parse_args(argv)
    dev = require_device(args.device)

    out: dict = {}
    rng = np.random.default_rng(args.seed)

    # 1. Correlated return history (one-factor market model).
    rets = generate_returns(args.assets, args.days, seed=args.seed
                            ).astype(np.float64)
    # Give assets distinct drifts so optimization has something to find.
    drifts = rng.uniform(-2e-4, 8e-4, args.assets)
    rets = rets + drifts
    w_eq = np.full(args.assets, 1.0 / args.assets)
    port_rets = rets @ w_eq

    an = RiskMetricsAnalyzer(device=dev)
    out["risk_metrics"] = {
        "var_historical_95": an.calculate_var(port_rets, 0.95),
        "var_parametric_95": an.calculate_var(port_rets, 0.95,
                                              "parametric"),
        "var_monte_carlo_95": monte_carlo_var(
            rets, 0.95, n_samples=args.mc_samples, seed=args.seed,
            device=dev),
        "cvar_95": an.calculate_cvar(port_rets, 0.95),
        "sharpe": sharpe_ratio(port_rets),
        "max_drawdown": max_drawdown(port_rets),
    }

    # 2. Optimization family.
    mu = rets.mean(axis=0)
    cov = covariance_matrix(rets, annualize=False)
    opt = PortfolioOptimizer(device=dev)
    mv = opt.optimize(mu, cov, target_return=float(np.quantile(mu, 0.7)),
                      constraints={"max_weight": 0.1})
    rp = risk_parity(cov)
    ef = efficient_frontier(mu, cov, n_points=10,
                            max_weight=0.2)
    bl = black_litterman(w_eq, cov, views_P=[[1.0] + [0.0] *
                                             (args.assets - 1)],
                         views_Q=[0.001])
    att = risk_attribution(mv["weights"], cov)
    sim = monte_carlo_simulation(mv["weights"], mean=mu, cov=cov,
                                 n_paths=20_000, horizon=252,
                                 seed=args.seed, device=dev)
    out["optimization"] = {
        "mean_variance": {"expected_return": mv["expected_return"],
                          "volatility": mv["volatility"],
                          "sharpe": mv["sharpe"],
                          "n_nonzero": int((mv["weights"] > 1e-6).sum())},
        "risk_parity_max_contrib_dev": float(np.abs(
            rp["risk_contributions"] - 1.0 / args.assets).max()),
        "frontier_vol_range": [float(ef["volatilities"].min()),
                               float(ef["volatilities"].max())],
        "black_litterman_view_shift": float(
            bl["posterior_returns"][0] - bl["implied_returns"][0]),
        "top_risk_contributor_pct": float(att["pct_contribution"].max()),
        "mc_simulation": {"mean": sim["mean"], "q05": sim["q05"],
                          "prob_loss": sim["prob_loss"]},
    }

    # 3. Options pricing.
    g = greeks(100.0, 100.0, 1.0, 0.05, 0.2, device=dev)
    out["options"] = {
        "bs_call": black_scholes(100, 100, 1.0, 0.05, 0.2, device=dev),
        "binomial_american_put": binomial_tree(
            100, 110, 1.0, 0.08, 0.2, kind="put", n_steps=300,
            american=True, device=dev),
        "delta": g["delta"], "gamma": g["gamma"], "vega": g["vega"],
        "barrier_up_out": barrier_option_price(
            100, 100, 130, 1.0, 0.05, 0.2, n_paths=50_000,
            device=dev)["price"],
        "asian_call": asian_option_price(
            100, 100, 1.0, 0.05, 0.2, n_paths=50_000, device=dev)["price"],
    }

    # 4. Geospatial wiring: value-weighted VaR + geo-adjusted weights.
    dem = generate_dem(256, seed=args.seed)
    port = generate_assets(args.assets, extent=256.0, seed=args.seed)
    for i, a in enumerate(port.assets):
        a.returns = rets[:, i]
    model = GeospatialRiskModel([create_elevation_risk_factor(dem)])
    geo_w = port.optimize_for_geo_risk(
        model, target_return=float(np.median(mu)), max_risk_score=0.7,
        risk_aversion=0.001, max_weight=0.15)
    risks = port.assess_risk(model)
    held = [i for i, a in enumerate(port.assets) if geo_w[a.id] > 1e-6]
    out["geo_portfolio"] = {
        "portfolio_var_95": port.calculate_var(0.95),
        "n_assets_held": len(held),
        "mean_geo_risk_held": float(np.mean(
            [risks[port.assets[i].id] for i in held])) if held else None,
        "mean_geo_risk_all": float(np.mean(list(risks.values()))),
    }

    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for section, vals in out.items():
            print(f"== {section} ==")
            for k, v in vals.items():
                print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
