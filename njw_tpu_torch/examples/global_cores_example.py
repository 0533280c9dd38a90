"""Global dynamical cores demo: the spherical and icosahedral grids, run.
Counterpart of ``examples/global_cores_example.py``.

Three studies, selectable with --study:

  rossby      exact Rossby-Haurwitz retrogression on the spectral BVE:
              measures the numerical phase speed against the analytic
              -2*Omega/(n(n+1)) rate.
  williamson  Williamson TC2 steady-state error on both global cores
              (spectral against icosahedral finite-volume) at matched
              resolution.
  nested      two-way nested refinement on the planar SWE: the patch's
              fields after a run.

    python -m njw_tpu_torch.examples.global_cores_example \\
        --study williamson --nlat 64 --hours 24
"""
import argparse
import json
import time

import numpy as np

from njw_tpu_torch.examples._common import add_device, synchronize
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import to_numpy
from njw_tpu_torch.weather import SimConfig, Simulation
from njw_tpu_torch.weather.nested import make_nested_sim


def _timed_steps(sim, steps, device) -> float:
    t0 = time.perf_counter()
    sim.step(steps)
    synchronize(device)
    return time.perf_counter() - t0


def study_rossby(args):
    dev = require_device(args.device)
    nlat = args.nlat
    cfg = SimConfig(model="barotropic", grid_type="spherical_harmonic",
                    grid_width=2 * nlat, grid_height=nlat, dt=args.dt,
                    device=args.device)
    sim = Simulation.from_config(cfg, "rossby_haurwitz")
    m, n = 4, 5
    sht = sim.sht
    omega = sim.omega
    steps = int(round(args.hours * 3600.0 / args.dt))
    wall = _timed_steps(sim, steps, dev)

    # phase of the (m, n) coefficient of the complex spectral state
    z = to_numpy(sim.state.zeta)
    phase = np.angle(z[m, n])
    t = steps * args.dt
    analytic_rate = -2.0 * omega / (n * (n + 1.0))
    # a_mn(t) = a_mn(0) e^{-i m c t} for a pattern moving at rate c:
    # the measured rate is minus the coefficient phase slope
    measured = -phase / (m * t)
    out = {"study": "rossby", "nlat": nlat, "trunc": sht.trunc,
           "model_hours": args.hours,
           "analytic_rate_rad_s": analytic_rate,
           "measured_rate_rad_s": float(measured),
           "rel_error": float(abs(measured - analytic_rate)
                              / abs(analytic_rate)),
           "wall_s": round(wall, 2)}
    print(json.dumps(out, indent=2))


def _h_drift(sim, steps, device):
    """(relative L2 drift of h over ``steps``, wall seconds)."""
    h0 = to_numpy(sim.output_fn(sim.state)["h"])
    wall = _timed_steps(sim, steps, device)
    h1 = to_numpy(sim.output_fn(sim.state)["h"])
    return (float(np.sqrt(((h1 - h0) ** 2).mean())
                  / np.sqrt((h0 ** 2).mean())), wall)


def study_williamson(args):
    dev = require_device(args.device)
    steps = int(round(args.hours * 3600.0 / args.dt))

    # spectral core
    nlat = args.nlat
    cfg = SimConfig(model="shallow_water", grid_type="spherical_harmonic",
                    grid_width=2 * nlat, grid_height=nlat, dt=args.dt,
                    device=args.device)
    spec_err, spec_wall = _h_drift(
        Simulation.from_config(cfg, "williamson2"), steps, dev)

    # icosahedral core at comparable cell count: 10 n^2 ~= 2 nlat^2
    n_ico = 1 << int(round(np.log2(max(np.sqrt(nlat * nlat / 5.0), 4))))
    icfg = SimConfig(model="shallow_water", grid_type="icosahedral",
                     grid_width=n_ico, grid_height=n_ico, dt=args.dt,
                     device=args.device)
    ico_err, ico_wall = _h_drift(
        Simulation.from_config(icfg, "williamson2"), steps, dev)

    out = {"study": "williamson_tc2", "model_hours": args.hours,
           "spectral": {"nlat": nlat, "points": 2 * nlat * nlat,
                        "rel_l2_h_drift": spec_err,
                        "wall_s": round(spec_wall, 2)},
           "icosahedral": {"n": n_ico, "cells": 10 * n_ico * n_ico,
                           "rel_l2_h_drift": ico_err,
                           "wall_s": round(ico_wall, 2)},
           "note": "TC2 is an exact steady state; drift is pure "
                   "discretization error. Spectral wins on accuracy per "
                   "point (exponential convergence), the FV core wins on "
                   "locality (halo exchange vs transforms)."}
    print(json.dumps(out, indent=2))


def study_nested(args):
    require_device(args.device)
    n = 96
    cfg = SimConfig(grid_width=n, grid_height=n, dt=0.02,
                    device=args.device)
    patch = (n // 4, 3 * n // 4, n // 4, 3 * n // 4)
    sim = make_nested_sim(Simulation, cfg, "vortex", patch=patch,
                          ratio=args.ratio, strength=2.0)
    t0 = time.perf_counter()
    sim.run(args.steps, output_interval=args.steps)
    wall = time.perf_counter() - t0
    snap = sim.snapshots[-1]
    out = {"study": "nested", "grid": f"{n}x{n}",
           "patch": patch, "ratio": args.ratio, "steps": args.steps,
           "coarse_h_range": [float(snap["h"].min()),
                              float(snap["h"].max())],
           "fine_h_range": [float(snap["fine_h"].min()),
                            float(snap["fine_h"].max())],
           "finite": bool(np.isfinite(snap["fine_h"]).all()),
           "wall_s": round(wall, 2)}
    print(json.dumps(out, indent=2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.global_cores_example",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--study", default="williamson",
                   choices=["rossby", "williamson", "nested"])
    p.add_argument("--nlat", type=int, default=64)
    p.add_argument("--dt", type=float, default=450.0)
    p.add_argument("--hours", type=float, default=24.0)
    p.add_argument("--ratio", type=int, default=2)
    p.add_argument("--steps", type=int, default=200)
    add_device(p)
    args = p.parse_args(argv)
    {"rossby": study_rossby, "williamson": study_williamson,
     "nested": study_nested}[args.study](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
