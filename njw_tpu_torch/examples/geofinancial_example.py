"""Geo-financial risk pipeline: synthetic DEM + portfolio -> spatial risk
model -> scenario analysis (climate, economic, stress sets; VaR at
several confidences) -> multi-region comparison -> static HTML report.
Counterpart of ``examples/geofinancial_example.py``.

The flood factor's DEM sweeps (fill_sinks, flow_accumulation) run on
the device; the scenario and region layers are host NumPy, as in the
JAX package.

    python -m njw_tpu_torch.examples.geofinancial_example --assets 200 \\
        --dem-size 256 --scenario-sets climate economic stress \\
        --regions 2 2 --json
"""
import argparse
import json

import torch

from njw_tpu_torch.examples._common import add_device
from njw_tpu_torch.geofinancial import (
    GeospatialRiskModel, create_elevation_risk_factor,
    create_flood_risk_factor, generate_assets, generate_dem,
)
from njw_tpu_torch.geofinancial.multiregion import (
    MultiRegionRiskModel, RegionalRiskComparator, make_region_grid,
)
from njw_tpu_torch.geofinancial.scenarios import (
    ScenarioAnalyzer, create_climate_scenarios, create_economic_scenarios,
    create_stress_scenarios,
)
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import have_matplotlib
from njw_tpu_torch.viz.geofinancial import generate_geofin_report

SCENARIO_FACTORIES = {
    "climate": create_climate_scenarios,
    "economic": create_economic_scenarios,
    "stress": create_stress_scenarios,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.geofinancial_example",
        description=__doc__)
    p.add_argument("--assets", type=int, default=80)
    p.add_argument("--dem-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--flood-weight", type=float, default=1.0)
    p.add_argument("--elevation-weight", type=float, default=0.5)
    p.add_argument("--scenario-sets", nargs="+", default=["climate"],
                   choices=sorted(SCENARIO_FACTORIES))
    p.add_argument("--confidences", type=float, nargs="+",
                   default=[0.95, 0.99])
    p.add_argument("--regions", type=int, nargs=2, default=None,
                   metavar=("NX", "NY"),
                   help="split the extent into an NX x NY region grid and "
                        "rank regions by expected loss")
    p.add_argument("--output-dir", default="geofin_output")
    p.add_argument("--json", action="store_true")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    dem = torch.from_numpy(generate_dem(args.dem_size, seed=args.seed)).to(dev)
    model = GeospatialRiskModel([
        create_flood_risk_factor(dem, weight=args.flood_weight),
        create_elevation_risk_factor(dem, weight=args.elevation_weight),
    ])
    portfolio = generate_assets(args.assets, extent=float(args.dem_size),
                                seed=args.seed)
    el = portfolio.expected_loss(model)
    out = {
        "assets": len(portfolio.assets),
        "total_value": round(portfolio.total_value, 2),
        "expected_loss": round(el, 2),
        "scenario_sets": {},
    }
    if not args.json:
        print(f"assets: {out['assets']}  total: ${out['total_value']:,.0f}"
              f"  expected loss: ${out['expected_loss']:,.0f} "
              f"({100*el/portfolio.total_value:.1f}%)")

    analyzer = ScenarioAnalyzer(portfolio, model)
    report_set = None
    for name in args.scenario_sets:
        sset = SCENARIO_FACTORIES[name]()
        report_set = report_set or sset
        agg = analyzer.evaluate_set(sset)
        entry = {
            "n_scenarios": len(sset.scenarios),
            "expected_loss": round(agg["expected_loss"], 2),
            "worst_case": agg["worst_case"],
            "worst_loss": round(agg["worst_loss"], 2),
            "var": {str(c): round(analyzer.var(sset, c), 2)
                    for c in args.confidences},
        }
        out["scenario_sets"][name] = entry
        if not args.json:
            print(f"[{name}] {entry['n_scenarios']} scenarios  "
                  f"E[loss] ${entry['expected_loss']:,.0f}  "
                  f"worst: {entry['worst_case']} "
                  f"(${entry['worst_loss']:,.0f})")
            for c in args.confidences:
                print(f"         VaR{int(c*100)}: "
                      f"${entry['var'][str(c)]:,.0f}")

    if args.regions:
        nx, ny = args.regions
        mrm = MultiRegionRiskModel()
        for region in make_region_grid(0.0, float(args.dem_size), 0.0,
                                       float(args.dem_size), nx, ny):
            mrm.add_region(region, model)
        ranked = RegionalRiskComparator(mrm).rank(portfolio)
        out["regions"] = [{"name": name, "expected_loss": round(loss, 2)}
                          for name, loss in ranked]
        if not args.json:
            print(f"region ranking ({nx}x{ny} grid, by expected loss):")
            for name, loss in ranked:
                print(f"  {name}: ${loss:,.0f}")

    if not have_matplotlib():
        print("geofinancial_example: plots not drawn: matplotlib is not "
              "installed (the report holds its tables alone)", flush=True)
    page = generate_geofin_report(args.output_dir, portfolio, model,
                                  scenarios=report_set)
    out["report"] = page
    if args.json:
        print(json.dumps(out))
    else:
        print(f"report: {page}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
