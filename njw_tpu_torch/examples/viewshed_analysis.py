"""Geospatial terrain-analysis pipeline: synthetic DEM -> multi-observer
viewshed -> terrain derivatives -> hydrology (fill sinks + flow
accumulation) -> least-cost path -> HTML report with per-op timings.
Counterpart of ``examples/viewshed_analysis.py``.

The viewshed is a radial sweep (a cumulative maximum along rays, no
per-cell host loop) and the hydrology solvers are line-scan sweeps, all
on the device.

    python -m njw_tpu_torch.examples.viewshed_analysis --size 512 \\
        --observers 3 --observer-height 10 --path 10 10 500 500 --json
"""
import argparse
import json

import numpy as np

from njw_tpu_torch.examples._common import add_device, timed
from njw_tpu_torch.geospatial.datasets import synthetic_dem
from njw_tpu_torch.geospatial.dem import (
    DEMProcessor, cost_distance, least_cost_path,
)
from njw_tpu_torch.geospatial.metrics import GeospatialMetrics
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import have_matplotlib, to_numpy
from njw_tpu_torch.viz.geospatial import generate_geospatial_report


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.viewshed_analysis",
        description=__doc__)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--roughness", type=float, default=0.6)
    p.add_argument("--relief", type=float, default=200.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--observers", type=int, default=1,
                   help="number of observer points (random + center)")
    p.add_argument("--observer-height", type=float, default=10.0)
    p.add_argument("--path", type=int, nargs=4, default=None,
                   metavar=("Y0", "X0", "Y1", "X1"),
                   help="least-cost path endpoints (slope-weighted cost)")
    p.add_argument("--output-dir", default="viewshed_output")
    p.add_argument("--json", action="store_true")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    n = args.size
    dem = synthetic_dem(n, roughness=args.roughness, relief=args.relief,
                        seed=args.seed)
    proc = DEMProcessor(dem, device=dev)
    metrics = GeospatialMetrics()
    timings = {}
    out = {"size": n}

    rng = np.random.default_rng(args.seed)
    observers = [(n // 2, n // 2)] + [
        tuple(int(v) for v in rng.integers(n // 8, 7 * n // 8, 2))
        for _ in range(max(args.observers - 1, 0))
    ]
    visible_any = np.zeros((n, n), bool)
    obs_rows = []
    for oy, ox in observers:
        vis, dt = timed(lambda: to_numpy(proc.viewshed(
            (oy, ox), observer_height=args.observer_height)), dev)
        metrics.record_viewshed_performance(n, n, dt)
        visible_any |= vis > 0.5
        obs_rows.append({"observer": [oy, ox],
                         "visible_fraction": round(float(vis.mean()), 4),
                         "ms": round(dt * 1e3, 1)})
    out["viewsheds"] = obs_rows
    out["union_visible_fraction"] = round(float(visible_any.mean()), 4)

    deriv, dt = timed(proc.terrain_derivatives, dev)
    timings["derivatives_ms"] = round(dt * 1e3, 1)
    slope = to_numpy(deriv["slope"])
    aspect = to_numpy(deriv["aspect"])

    hydro, dt = timed(proc.hydrology, dev)
    timings["hydrology_ms"] = round(dt * 1e3, 1)
    flow = to_numpy(hydro["flow_accumulation"])
    out["max_upstream_cells"] = int(flow.max())
    out["mean_slope_deg"] = round(float(np.rad2deg(slope).mean()), 2)

    if args.path:
        y0, x0, y1, x1 = args.path
        cost = 1.0 + 10.0 * slope  # slope-weighted traversal cost
        # least_cost_path returns the path alone (a list of (y, x)); the
        # total is the cost distance at the target. (The JAX script
        # unpacks the list into (path, total) and fails there.)
        (path_xy, total), dt = timed(lambda: (
            least_cost_path(cost, (y0, x0), (y1, x1), device=dev),
            cost_distance(cost, (y0, x0), device=dev)[y1, x1]), dev)
        path_xy = np.asarray(path_xy)
        timings["least_cost_ms"] = round(dt * 1e3, 1)
        out["path_cost"] = round(float(total), 2)
        out["path_points"] = int(path_xy.shape[0])

    out["timings"] = timings
    if not have_matplotlib():
        print("viewshed_analysis: plots not drawn: matplotlib is not "
              "installed (the report holds its table alone)", flush=True)
    page = generate_geospatial_report(
        args.output_dir, dem, visible=visible_any.astype(np.float32),
        observer_xy=observers[0], slope=slope, aspect=aspect,
        flow_acc=flow, metrics=metrics.summary())
    out["report"] = page

    if args.json:
        print(json.dumps(out))
    else:
        for row in obs_rows:
            print(f"observer {row['observer']}: "
                  f"{100*row['visible_fraction']:.1f}% visible "
                  f"({row['ms']} ms)")
        print(f"union visible: {100*out['union_visible_fraction']:.1f}%  "
              f"mean slope {out['mean_slope_deg']} deg  "
              f"max upstream {out['max_upstream_cells']} cells")
        if args.path:
            print(f"least-cost path: {out['path_points']} points, "
                  f"cost {out['path_cost']}")
        print(f"timings: {timings}")
        print(f"report: {page}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
